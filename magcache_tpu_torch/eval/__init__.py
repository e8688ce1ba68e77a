"""Golden-reference evaluation: metrics, comparisons, sweeps (counterpart of
``magcache_tpu.eval``)."""
