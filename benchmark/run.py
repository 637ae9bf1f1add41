"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON line as its last line of
standard output (`benchmark/harness/cli.py` says what it holds).
"""

import os
import sys
import time

T0 = time.time()        # set-up is timed from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this file's folder, leads the path
sys.path[0] = ROOT

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
