"""What the benchmark runs imports neither JAX nor the JAX package, and
the reference imports nothing of the program.  Module names are compared by
their whole top-level name: the port's name begins with the JAX package's."""

import subprocess
import sys

from benchmark import harness
from benchmark.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "procgen_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_run_loads_no_jax():
    loaded = _top_level_after(
        "from benchmark import run, harness, control, envloop\n"
        "from benchmark.drivers import ppo, random_actions\n"
        "envloop.port_modules()\n"
        "import procgen_torch.learn.ppo\n")
    assert "procgen_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        "from benchmark.reference import envs, learner, games, frame, png, mt\n"
        "from benchmark import yardstick, synth_assets, inputs, trace\n")
    assert not loaded & (FORBIDDEN | {"procgen_torch"}), loaded


def test_no_reference_source_names_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace("(", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in FORBIDDEN | {"procgen_torch"}, (path, line)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "procgen_tpu_like", sys)
    assert "procgen_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "procgen_tpu.x", sys)
    assert "procgen_tpu" in harness.forbidden_modules()


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "maze-hard.random-4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:  # a card is present: the run is the chip's to judge
        return
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
