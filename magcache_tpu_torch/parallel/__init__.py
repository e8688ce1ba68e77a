"""The (dp, sp, tp) rank grid: the group interface and its two
implementations (``mesh``), the tensor-parallel weight slices (``shard``)
and the explicit collectives and sharded kernel wrappers built on them
(``collectives``)."""
