"""The benchmark's harness: one run of one cell (``cli``), its window,
drivers (``generate``, ``training``), the ranks of a cell of several cards
(``ranks``), the check against the reference (``compare``) and the faults
it is shown to catch (``faults``), the traced run's instruments
(``tracing``) and the kernels' bounds (``roofline``)."""
