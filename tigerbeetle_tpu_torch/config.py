"""Cluster/process configuration, mirroring the reference's two-level config.

Reference: src/config.zig (ConfigCluster :130-185, ConfigProcess :73-121,
presets :206-303) and src/constants.zig (derived constants :45-74, batch sizes
:203-204).  Only the knobs that matter to the TPU build are carried over;
format-affecting values keep the reference defaults so the wire protocol and
batch math match exactly.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Consensus/format-affecting constants (config.zig:130-185)."""

    # Wire/WAL message size (config.zig: message_size_max default 1 MiB).
    message_size_max: int = 1 << 20
    # 256-byte message header (message_header.zig:17).
    header_size: int = 256
    # WAL slots (config.zig: journal_slot_count default 1024).
    journal_slot_count: int = 1024
    # Consensus pipeline depth (config.zig: pipeline_prepare_queue_max 8).
    pipeline_prepare_queue_max: int = 8
    clients_max: int = 32
    replicas_max: int = 6
    standbys_max: int = 6
    lsm_batch_multiple: int = 32

    @property
    def message_body_size_max(self) -> int:
        return self.message_size_max - self.header_size

    @property
    def batch_max_create_transfers(self) -> int:
        # (1 MiB - 256 B) / 128 B = 8190 (state_machine.zig:70-75).
        return self.message_body_size_max // 128

    @property
    def batch_max_create_accounts(self) -> int:
        return self.message_body_size_max // 128

    @property
    def batch_max_lookups(self) -> int:
        # lookup events are bare u128 ids but results are 128 B rows, and
        # batch_max divides by max(event, result) size (state_machine.zig:70-75).
        return self.message_body_size_max // 128

    @property
    def vsr_checkpoint_interval(self) -> int:
        # constants.zig:45-74: journal_slot_count minus compaction+pipeline margin.
        return self.journal_slot_count - self.lsm_batch_multiple - (
            self.pipeline_prepare_queue_max + 1
        )


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """Device ledger capacity knobs (the TPU analogue of ConfigProcess cache
    sizing, config.zig:84-101). Capacities are power-of-two open-addressing
    table sizes; load factor should stay under ~0.5 for short probe chains."""

    accounts_capacity_log2: int = 16
    transfers_capacity_log2: int = 18
    posted_capacity_log2: int = 16
    history_capacity_log2: int = 16
    # Upper bound on linear-probe distance before the kernel reports the table
    # as over-full (host must grow/rebuild; analogous to cache eviction limits).
    max_probe: int = 64
    # Cold-tier Bloom filter size (machine.py tiering): 2^N bits; sized so
    # the false-positive rate stays low as spilled-id counts grow (the
    # filter doubles on saturation either way — this is the floor).
    bloom_bits_log2: int = 20
    # Fraction of live hot transfers spilled per eviction (machine.evict_cold).
    eviction_fraction: float = 0.5
    # Jacobi fixpoint budget for the general transfer kernel: pass k is
    # exact for outcome-cascade depth < k; deeper cascades route to the
    # sequential path (ops/transfer_full.py loop_cond).
    jacobi_max_passes: int = 8
    # Defer secondary-index maintenance to first query (bulk-ingest mode):
    # the sorted-runs indexes are DERIVED state either way; eager appends
    # cost one sorted run per commit plus periodic level-merge compiles,
    # which a write-only burst never amortizes.  Queries stay exact — the
    # first one pays one full-table rebuild.
    lazy_index: bool = False

    @property
    def accounts_capacity(self) -> int:
        return 1 << self.accounts_capacity_log2

    @property
    def transfers_capacity(self) -> int:
        return 1 << self.transfers_capacity_log2

    @property
    def posted_capacity(self) -> int:
        return 1 << self.posted_capacity_log2

    @property
    def history_capacity(self) -> int:
        return 1 << self.history_capacity_log2


@dataclasses.dataclass(frozen=True)
class ProcessConfig:
    """Per-process runtime knobs (config.zig ConfigProcess :73-121): free to
    differ between replicas and across restarts — nothing here affects the
    storage format or the wire protocol.  Every field is wired into the
    runtime (servers, storage, CLI); unreferenced knobs don't belong here."""

    # Default listen address (config.zig port/address; the CLI's
    # --addresses default derives from these).
    address: str = "127.0.0.1"
    port: int = 3000
    # Consensus tick cadence for the TCP cluster server (tick_ms).
    tick_ms: int = 10
    # Peer dial backoff window (connection_delay_min/max_ms).
    connection_delay_min_ms: int = 50
    connection_delay_max_ms: int = 1000
    tcp_backlog: int = 64
    tcp_nodelay: bool = True
    # Reply-flush drain budget: a client that stops reading has this long
    # before its connection is evicted (message_bus.zig bounded send queue +
    # terminate discipline; see net/bus.py "Memory budget" invariant).
    drain_timeout_ms: int = 5000
    # Max ops executed per commit dispatch on the TCP bus (replica.zig's
    # async commit_dispatch never monopolizes its IO loop); the remainder
    # drains via the bus commit pump, yielding to the loop between chunks.
    commit_budget_ops: int = 4
    # O_DIRECT for the zoned data file (direct_io / direct_io_required):
    # page-cache writeback lies about durability; required=True refuses to
    # run on filesystems without it instead of silently degrading.
    direct_io: bool = False
    direct_io_required: bool = False


# Presets, mirroring config.zig:206-303.
PRODUCTION = ClusterConfig()
TEST_MIN = ClusterConfig(message_size_max=8192, journal_slot_count=64)
PROCESS_DEFAULT = ProcessConfig()

LEDGER_TEST = LedgerConfig(
    accounts_capacity_log2=10, transfers_capacity_log2=12, posted_capacity_log2=10,
    history_capacity_log2=10, max_probe=1 << 10,
    bloom_bits_log2=14,
)


@dataclasses.dataclass(frozen=True)
class Preset:
    """A named (cluster, process, ledger) bundle — the two-level preset
    matrix of config.zig:206-303 (default_production / default_development /
    test_min), extended with the TPU build's ledger level."""

    name: str
    cluster: ClusterConfig
    process: "ProcessConfig"
    ledger: LedgerConfig


PRESETS = {
    # Production: 1 MiB messages, full WAL ring, HBM-scale tables.
    "production": Preset(
        "production", PRODUCTION, ProcessConfig(direct_io=True),
        LedgerConfig(),
    ),
    # Development: same wire format (a dev client talks to a prod cluster)
    # but laptop-sized tables, buffered IO, smaller bloom.
    "development": Preset(
        "development", PRODUCTION, PROCESS_DEFAULT,
        LedgerConfig(
            accounts_capacity_log2=14, transfers_capacity_log2=16,
            posted_capacity_log2=14, history_capacity_log2=14,
            bloom_bits_log2=16,
        ),
    ),
    # test_min: tiny everything (8 KiB messages, 64-slot WAL) so unit and
    # sim rings run thousands of schedules (config.zig:241-269).
    "test_min": Preset("test_min", TEST_MIN, PROCESS_DEFAULT, LEDGER_TEST),
}
# Benchmark sizing: 10M+ accounts, tens of millions of transfers resident.
LEDGER_BENCH = LedgerConfig(
    accounts_capacity_log2=21, transfers_capacity_log2=25, posted_capacity_log2=21
)

NS_PER_S = 1_000_000_000
