#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card (four for a four-chip
cell).  See ``port_bench/__init__.py`` for how a cell is found."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.harness import common  # noqa: E402

T_START = common.process_start_time()

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
