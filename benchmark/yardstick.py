"""What the work costs at the least: the peaks of the card, the work a frame's
sprite composite needs, and the FLOPs of the IMPALA CNN.

The composite is counted as the work the frame needs, whatever implements
it: each input read once (the uint8 layer under the sprites, the drawn
records, the sprite atlas), the uint8 frame written once, and 20 float32
operations per covered pixel of each drawn record.  A float32 canvas that
an implementation keeps between its passes is not counted, so a version
that fuses the uint8 read and store into the kernel leaves the count as it
is.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

RES = 64
RECORD_FIELDS = 11  # (bbx0, bby0, bbw, bbh, var, refl, alpha, ok, n_th, n_tv, z)
OPS_PER_COVERED_PIXEL = 20


def covered_pixels(records: torch.Tensor) -> torch.Tensor:
    """Per drawn record (``ok`` > 0) of (N, E, 11) float32 records, the
    pixels of the 64x64 frame whose centres lie in its box: ``(x + 0.5 -
    bbx0) / bbw`` in [0, 1), the same along y.  Returns (N, E) int64."""
    px = torch.arange(RES, dtype=torch.float32, device=records.device) + 0.5

    def inside(lo, size):
        t = (px - records[..., lo, None]) / records[..., size, None]
        return ((t >= 0) & (t < 1)).sum(-1)

    ok = records[..., 7] > 0
    return torch.where(ok, inside(0, 2) * inside(1, 3), 0)


def entity_records(state) -> torch.Tensor:
    """(N, E, 11) records of the entities a frame of ``state`` draws, in the
    fields ``covered_pixels`` reads: each alive entity's box on the screen
    (``get_object_rect``, basic-abstract-game.cpp:811-817, unrotated) and
    ``ok``."""
    e = state.ents
    unit, view_dim = state.unit[:, None], state.view_dim[:, None]
    rec = torch.zeros(e.x.shape + (RECORD_FIELDS,), dtype=torch.float32, device=e.x.device)
    rec[..., 0] = (e.x - e.rx) * unit - state.x_off[:, None]
    rec[..., 1] = (view_dim - (e.y + e.ry)) * unit + state.y_off[:, None]
    rec[..., 2] = 2 * e.rx * unit
    rec[..., 3] = 2 * e.ry * unit
    rec[..., 7] = e.alive.to(torch.float32)
    return rec


def atlas_bytes(game: str) -> int:
    """The sprite atlas a frame reads: one 32x32 RGBA image per sprite of
    the game (``reference/games.py``)."""
    from benchmark.reference.games import GAMES

    return len(GAMES[game].sprites) * 32 * 32 * 4


def composite_work(records: torch.Tensor, atlas_bytes: int) -> tuple[int, int]:
    """(bytes, float32 operations) one frame's composite needs for a batch
    with these records: the uint8 base layer read and the uint8 frame
    written, the drawn records and the atlas read once, 20 operations per
    covered pixel per drawn record."""
    n = records.shape[0]
    drawn = int((records[..., 7] > 0).sum())
    frame = n * RES * RES * 3
    nbytes = 2 * frame + drawn * RECORD_FIELDS * 4 + int(atlas_bytes)
    return nbytes, OPS_PER_COVERED_PIXEL * int(covered_pixels(records).sum())


def bound_s(nbytes: int, flops: int) -> float:
    """The least time: the larger of bytes over the memory bandwidth and
    float32 operations over the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def impala_forward_flops(depths=(16, 32, 32), hidden=256, n_actions=15, side=64,
                         channels=3) -> int:
    """2 x the multiply-adds of one observation's forward pass through
    ``learn/nets.py``'s IMPALA CNN: per stack a 3x3 convolution, a 3x3
    max-pool of stride 2, and two residual blocks of two 3x3 convolutions;
    the dense layer over the flattened output and the policy and value
    heads."""
    macs, c = 0, channels
    for d in depths:
        macs += side * side * d * c * 9  # the stack's first convolution
        side = (side + 1) // 2  # max-pool, stride 2, SAME
        macs += 4 * side * side * d * d * 9  # two residual blocks
        c = d
    flat = side * side * c
    macs += flat * hidden + hidden * (n_actions + 1)
    return 2 * macs


def ppo_iteration_flops(num_envs: int, n_steps: int, n_epochs: int,
                        per_obs: int | None = None) -> int:
    """FLOPs of one PPO iteration: the rollout's n_steps + 1 forwards per
    env, and per update epoch a forward and a backward (twice the forward)
    over every observation."""
    f = impala_forward_flops() if per_obs is None else per_obs
    return (n_steps + 1) * num_envs * f + n_epochs * n_steps * num_envs * 3 * f
