#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell of
``BENCHMARK.json`` on this machine's first CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It prints its set-up parts and the numbers
its check compared on standard error, and one JSON result as the last line
of standard output; it exits non-zero, with no result, without the card the
cell needs or where a JAX module was loaded.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:]))
