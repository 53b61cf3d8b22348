"""The benchmark's harness: one run of one cell (``cli``), its window,
drivers (``generate``, ``training``), the check against the reference
(``compare``), the traced run's instruments (``tracing``) and the kernels'
bounds (``roofline``)."""
