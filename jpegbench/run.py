"""Run one cell of the benchmark once and print its result line.

    python3 jpegbench/run.py --workload rst444.loader128 --seed 7 \
        --seconds 10 --trace 0

See jpegbench/harness.py.  Only the standard library is imported before
`main`: the corpus's worker processes start from this file and must not
load torch.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    from jpegbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
