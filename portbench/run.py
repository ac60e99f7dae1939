"""Run one cell of the benchmark of the PyTorch and CUDA port once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell asks for. The last line of
standard output is one JSON object (correct, attempted, failed, metrics, device, [breakdown],
compared); the numbers compared for ``correct`` are also the last lines of standard error.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
