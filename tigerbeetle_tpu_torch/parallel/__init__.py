"""The sharded ledger (counterpart of ``tigerbeetle_tpu/parallel``)."""
