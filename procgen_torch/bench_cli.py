"""Console entry point of the port's throughput benchmark
(``procgen-torch-bench``; counterpart of ``procgen_tpu/bench_cli.py``):
rendered fast-path env-steps/s of each game, one JSON line.  The harness
is ``procgen_torch/bench/throughput.py``; its options are the reference
package's ``bench.py``'s, plus ``--device`` (``cuda`` unless ``cpu`` is
given).

    python -m procgen_torch.bench_cli --games maze --num-envs 4096 --chunk 8 --chunks 1
"""

from __future__ import annotations

from procgen_torch.bench import throughput


def main(argv=None) -> int:
    return throughput.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
