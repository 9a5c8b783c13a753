"""The port's composed scans (``tigerbeetle_tpu_torch/ops/scan_builder.py``
through ``TorchStateMachine.scan_transfers``, ``scan_accounts``,
``query_transfers_where`` and ``query_accounts_where``) against
``TpuStateMachine`` on the same batches, over the fast path, the general
kernel and the sequential path, with the field indexes maintained on every
commit and with ``lazy_index``: prefix scans over ``ledger``, ``code``,
``user_data_128`` and ``user_data_32``, composed by union, intersection
and difference.  Tolerance: exact equality of every row (integers only)."""

import pytest

from tests.test_torch_queries import (
    assert_index_equal, commit3, extra_batch, run_route, same_rows)
from tigerbeetle_tpu.ops import scan_builder as jsb
from tigerbeetle_tpu_torch.ops import scan_builder as tsb


def check_scans(t, j, n_exprs=5):
    exprs = [
        tsb.scan_prefix("ledger", 1),
        tsb.merge_union(tsb.scan_prefix("code", 10), tsb.scan_prefix("code", 30)),
        tsb.merge_intersection(tsb.scan_prefix("ledger", 1),
                               tsb.scan_prefix("code", 20)),
        tsb.merge_difference(tsb.scan_prefix("user_data_128", (1 << 64) | 1),
                             tsb.scan_prefix("code", 10)),
        tsb.merge_union(
            tsb.merge_intersection(tsb.scan_prefix("code", 10),
                                   tsb.scan_prefix("user_data_128", 2 << 64)),
            tsb.scan_prefix("ledger", 2)),
    ]
    # The default limit gives one window size; a small limit on one
    # expression also runs the evaluator's window-doubling loop.
    exprs = exprs[:n_exprs]
    for e, kw in [(e, {}) for e in exprs] + [(exprs[-1], dict(limit=5,
                                                               reversed=True))]:
        same_rows(t.scan_transfers(e, **kw), j.scan_transfers(_to_jax(e), **kw),
                  f"scan_transfers {e} {kw}")
    for e, je in ((tsb.scan_prefix("code", 20), jsb.scan_prefix("code", 20)),
                  (tsb.merge_difference(tsb.scan_prefix("ledger", 1),
                                        tsb.scan_prefix("user_data_32", 1)),
                   jsb.merge_difference(jsb.scan_prefix("ledger", 1),
                                        jsb.scan_prefix("user_data_32", 1)))):
        same_rows(t.scan_accounts(e), j.scan_accounts(je), f"scan_accounts {e}")
    same_rows(t.query_transfers_where(ledger=1, code=10, limit=9),
              j.query_transfers_where(ledger=1, code=10, limit=9),
              "query_transfers_where")
    same_rows(t.query_accounts_where(ledger=1, code=20),
              j.query_accounts_where(ledger=1, code=20), "query_accounts_where")


def _to_jax(expr):
    if isinstance(expr, tsb.Prefix):
        return jsb.Prefix(expr.field, expr.value)
    if isinstance(expr, tsb.Union):
        return jsb.Union(tuple(_to_jax(c) for c in expr.children))
    if isinstance(expr, tsb.Intersection):
        return jsb.Intersection(tuple(_to_jax(c) for c in expr.children))
    return jsb.Difference(_to_jax(expr.include), _to_jax(expr.exclude))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("route", ["fast", "general", "sequential"])
def test_scans_match_jax(route, lazy):
    t, j, ref = run_route(route, lazy)
    check_scans(t, j)
    # One more batch after the field indexes materialized: appended (eager)
    # or marked stale (lazy), and the scans stay equal.
    commit3(t, j, ref, "create_transfers", extra_batch(route), 10 ** 10)
    for f in ("ledger", "code", "user_data_128"):
        assert_index_equal(t.scans_transfers.indexes[f],
                           j.scans_transfers.indexes[f])
    check_scans(t, j, n_exprs=4)


def test_scan_errors_match_jax():
    t, _, _ = run_route("fast", False)
    with pytest.raises(ValueError):
        t.query_transfers_where()
    with pytest.raises(ValueError):
        t.query_accounts_where()
    with pytest.raises(KeyError):
        t.scan_transfers(tsb.scan_prefix("amount", 1))
