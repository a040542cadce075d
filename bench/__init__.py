"""The benchmark of ``repro_torch``'s serving engine on one H100: the
harness (``bench.run``), its data (``configs/``, ``traffic/``,
``workloads/``), its per-layer readers (``metrics/``) and its yardstick
(``roofline``, ``reference``, ``check``).  Imports no JAX and nothing of
the JAX package."""
