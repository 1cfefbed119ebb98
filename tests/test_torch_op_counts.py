"""``procgen_torch.bench.op_counts`` on the CPU, 4 envs, generated assets.

Its keys come from ``telemetry.SPANS``: every program span that the
profiled refill or the profiled step and frame opened (as telemetry itself
recorded in each profiler session) appears under the span's name less
``procgen_torch.``, and no other does; no span holds more ops than the span
around it; and the spans each game must open are there.
"""

import pytest
import torch

from procgen_torch import telemetry
from procgen_torch.bench import op_counts
from procgen_torch.bench.profiling import profiled

torch.set_num_threads(1)

# (game, mode): the keys its refill and its step must report
CASES = {
    ("maze", "hard"): ("torch_ops_per_refill.levelgen",),
    ("miner", "hard"): ("torch_ops_per_refill.levelgen",
                        "torch_ops_per_step_in_miner.gravity_sweep"),
    ("jumper", "easy"): ("torch_ops_per_refill.levelgen", "torch_ops_per_jumper.levelgen_scans"),
    ("dodgeball", "hard"): ("torch_ops_per_refill.levelgen",
                            "torch_ops_per_step_in_dodgeball.enemy_sweep"),
}


def short(span):
    return span.removeprefix("procgen_torch.")


@pytest.mark.parametrize("game,mode", list(CASES), ids=[g for g, _ in CASES])
def test_op_counts_keys_follow_the_spans(game, mode, monkeypatch):
    opened = []  # telemetry's spans of each profiler session: the refill, then the step

    def recording(fn, spans, cuda=True):
        out = profiled(fn, spans, cuda)
        opened.append(telemetry.snapshot()["spans"])
        return out

    monkeypatch.setattr(op_counts, "profiled", recording)
    out = op_counts.count(game, mode, envs=4, device="cpu", generated_assets=True)
    refill_spans, step_spans = opened

    assert out["torch_ops_per_refill"] > 0 and out["refill_calls_per_refill"] == 1
    assert out["torch_ops_per_game_step"] > 0 and out["torch_ops_per_frame"] > 0
    assert set(refill_spans) | set(step_spans) <= set(telemetry.SPANS)
    want = {f"torch_ops_per_{short(s)}" for s in refill_spans}
    want |= {f"{short(s)}_calls_per_refill" for s in refill_spans}
    want |= {f"torch_ops_per_step_in_{short(s)}" for s in step_spans}
    got = {k for k in out if k.startswith("torch_ops_per_") or k.endswith("_calls_per_refill")}
    assert got == want | {"torch_ops_per_game_step", "torch_ops_per_frame"}
    for s, (calls, _, _) in refill_spans.items():
        assert out[f"{short(s)}_calls_per_refill"] == calls

    # each span's ops within those of the span around it: the dotted parent
    # where it was opened, else the refill, the game step or the frame
    total = out["torch_ops_per_refill"]
    for s in refill_spans:
        name = short(s)
        parent = name.rpartition(".")[0]
        around = (out[f"torch_ops_per_{parent}"] * out[f"{parent}_calls_per_refill"]
                  if f"{parent}_calls_per_refill" in out else total)
        assert out[f"torch_ops_per_{name}"] * out[f"{name}_calls_per_refill"] <= around, name
    for s in step_spans:
        name = short(s)
        parent = f"torch_ops_per_step_in_{name.rpartition('.')[0]}"
        around = out.get(parent, out["torch_ops_per_frame" if name.startswith("frame")
                                     else "torch_ops_per_game_step"])
        assert out[f"torch_ops_per_step_in_{name}"] <= around, name

    for key in CASES[game, mode]:
        assert out[key] > 0, key
