"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, metrics and configurations are in ``BENCHMARK.json``; see
``bench/harness.py``. The last line of standard output is the result.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402

if __name__ == "__main__":
    harness.setup_environment()
    sys.exit(harness.main(t_start=T_START))
