"""procgen_torch's plunder against native/plunder_oracle.cpp, procgen_tpu and
its own inline path, in PNG mode on a synthetic asset root (plunder reads
its ships' aspect ratios from the PNG headers when it is built).

* levelgen of six seeds per mode (easy, hard) against the std::mt19937 C++
  oracle built with the reference's float rand01 (``build_oracle`` of
  tests/test_torch_caveflyer.py): the ship permutation, lane directions
  and speeds, panels, legend and agent (types, themes, x, y, rx, ry), and
  the next raw draws of the step stream.  The oracle takes one aspect
  ratio for every ship; the port's game is given the same one.  Parity
  mode computes the lane speeds' double chain ``.15 + .1 * rand01()``
  (plunder.cpp:153) and matches bit for bit; fast mode rounds each float
  op in turn and its lane speeds are held to 1 ulp;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState (a target
  ship and another ship staged above the agent, in its line of fire), then
  both packages step it and draw its frame, the juice and progress bars
  included; every state field and frame bitwise after every step; easy
  mode for 80 steps.  Targets hit, other ships hit, explosions and spawned
  ships are counted, and each must occur;
* the port's fast path against its inline path.

The JAX side's float chains are pinned to the reference's roundings
(``pin_jax_roundings``, ``pin_jax_render``).  The spawned ship's row
``(lane * .11f + .4f) * (main_height / 2 - r_scale) + main_height / 2``
runs unpinned there: XLA:CPU's FMAs give the reference's bits, which are
the double chain narrowed once (tests/test_torch_ref_parity_faults.py).
"""

import subprocess

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig

from procgen_torch import objects as O
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import plunder as PL
from test_torch_assets import asset_root_fixture
from test_torch_caveflyer import build_oracle
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fast_path import pin_jax_render, pin_jax_roundings
from test_torch_fruitbot import check_stream, oracle_ents, port_reset

torch.set_num_threads(1)

N = 4
SEED = 31

synth_root = asset_root_fixture()


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mode,mode_i", [("easy", 0), ("hard", 1)])
def test_plunder_levelgen_matches_oracle(synth_root, monkeypatch, mode, mode_i, parity):
    binary = build_oracle("plunder", float_rand01=True)
    aspect = PL.Plunder(EnvConfig(env_name="plunder")).ship_aspects[0]
    # the oracle's one aspect ratio for every ship
    monkeypatch.setattr(PL.Plunder, "__init__", _one_aspect(PL.Plunder.__init__, aspect))
    cfg = EnvConfig(env_name="plunder", num_envs=6, distribution_mode=DistributionMode[mode],
                    parity_mode=parity)
    seeds = [4 + 23 * i for i in range(6)]
    _, state, mt = port_reset(cfg, seeds)
    ents, ex = state.ents, state.extra
    panels = 0
    for i, seed in enumerate(seeds):
        out = subprocess.run([str(binary), str(seed), str(mode_i), float(aspect).hex()],
                             check=True, capture_output=True, text=True).stdout.splitlines()
        where = f"seed {seed}"
        num_panels, agent_theme, n_ents = map(int, out[0].split()[1:])
        perm = list(map(int, out[1].split()[1:]))
        assert ex["image_permutation"][i].tolist() == perm, where
        assert ex["target_bools"][i].tolist() == [k == perm[0] for k in range(6)], where
        assert ex["lane_directions"][i].tolist() == [bool(int(v)) for v in out[2].split()[1:]], where
        vels = [_bits(float.fromhex(v)) for v in out[3].split()[1:]]
        got = [_bits(v) for v in ex["lane_vels"][i]]
        assert max(abs(a - b) for a, b in zip(got, vels)) <= (0 if parity else 1), (where, got, vels)
        ref = oracle_ents(out[4:4 + n_ents])
        assert int(ents.alive[i].sum()) == n_ents, where
        assert int(ents.image_theme[i, 0]) == agent_theme, where
        panels += num_panels
        for k, (t, theme, *xyr) in enumerate(ref):
            assert int(ents.type[i, k]) == t, (where, k)
            assert int(ents.image_theme[i, k]) == theme, (where, k)
            got = [_bits(getattr(ents, f)[i, k]) for f in ("x", "y", "rx", "ry")]
            assert got == [_bits(v) for v in xyr], (where, k)
        check_stream(mt, i, map(int, out[4 + n_ents].split()[1:]), where)
    assert panels > 0 or mode == "easy"


def _one_aspect(init, aspect):
    def patched(self, cfg):
        init(self, cfg)
        self.ship_aspects = [aspect] * len(self.ship_aspects)

    return patched


def _cfgs(mode="hard"):
    kw = dict(env_name="plunder", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: fire (9) half the time, else any."""
    return np.where(rs.rand(N) < 0.5, 9, rs.randint(0, 15, size=N)).astype(np.int32)


def _stage(state, which):
    """A target ship 4 above the agent and one of the other sailing colour
    8 above, drifting slowly, in the new levels of ``which``."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    perm = state.extra["image_permutation"]
    for dy, theme in ((4.0, perm[:, 0]), (8.0, perm[:, 1])):
        ship = eo.make_entity(ax, ay + dy, np.float32(0.02), 0.0, 1.0, 0.6, PL.SHIP)
        ship.update(image_type=PL.SHIP, image_theme=theme)
        ents, _ = eo.append_entity(ents, ship, active=which)
    return state.replace(ents=ents)


@pytest.mark.parametrize("mode,steps", [("hard", 250), ("easy", 80)])
def test_plunder_step_matches_reference(synth_root, monkeypatch, jax_x64_off, mode, steps):
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    counts = dict(targets=0, misses=0, explosions=0, spawned=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        ents = state.ents
        new = ents.alive & (ents.life_time == 0)
        counts["explosions"] += int((new & (ents.type == O.EXPLOSION)).sum())
        counts["spawned"] += int((new & (ents.type == PL.SHIP)).sum())
        counts["targets"] += int((state.reward >= PL.POSITIVE_REWARD).sum())
        if prev is not None:
            fell = prev.extra["juice_left"] - state.extra["juice_left"]
            counts["misses"] += int(((fell > 0.05) & ~prev.done).sum())
        prev = state
    for k in counts:
        assert counts[k] > 0, counts


def test_plunder_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
