"""Sequence parallelism over the ``sp`` axis: the group interface and its two
implementations (``mesh``), and the explicit collectives built on it
(``collectives``)."""
