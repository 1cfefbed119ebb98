"""python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once on the card (``benchmark/harness.py``)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_dirs()
    raise SystemExit(harness.main(sys.argv[1:], T_START))
