"""python3 tfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The benchmark of texturefusion_torch (tfbench/harness.py). Run from the
root of a checkout that holds the port; it needs as many CUDA devices as
the cell asks for, and exits non-zero without a result line otherwise.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.entry(T_START))
