"""Run one cell of the benchmark once, on the card:

    python benchmark/run.py --workload fit512_b16.mean --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout. Prints the set-up stages, counts and checks
on standard error and one JSON result as the last line of standard
output; ``--trace 1`` reports the per-layer metrics instead of the
end-to-end ones. Exits 2 without a result where the machine has fewer
CUDA devices than the cell needs, and 3 where the run loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
