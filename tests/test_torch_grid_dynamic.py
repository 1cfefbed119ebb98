"""procgen_torch's grid-dynamic game miner against procgen_tpu (chaser, the
other one, is in tests/test_torch_chaser.py).

The fast path step by step: 4 envs, refill bucket 2, forced resets (action
-1) at t = 40, 41 and 90.  After the cold start and after every step the
whole FastState (live state, queue and queue_valid, every ``extra`` field)
must be equal field for field, floats bit for bit (with the documented
view_dim rule of tests/test_torch_fast_path.py), and the rendered uint8
frames identical.  The frames run the plain compositor through both z
passes and the grid pass between them; memory mode adds the center-agent
view.

The JAX side is pinned to the reference's diamond count across a level
swap (``pin_jax_kept_fields``): its fast path carries the queued level's
count, the port's the dying step's (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.parallel import fast as j_fast
from procgen_tpu.parallel.fast import make_fast_fns as j_make_fast_fns
from procgen_tpu.render import fast2 as j_fast2
from procgen_tpu.render.pack import RenderPack as JPack
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import compositor, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template
from test_torch_fast_path import assert_fields_equal, jax_fields

torch.set_num_threads(1)

N = 4
SEED = 23
FORCED = (40, 41, 90)


def pin_jax_kept_fields(monkeypatch, game, mode):
    """The JAX fast path's level swap made to carry the game's
    ``kept_across_reset`` fields from the dying step, as the port's does and
    as the reference keeps them (miner.cpp:23, 305): its ``_KEEP_FIELDS``
    gains ``extra`` when those fields are the whole of ``extra`` (miner's
    ``diamonds_remaining``), before its step is traced."""
    cfg = EnvConfig(env_name=game, num_envs=N, distribution_mode=DistributionMode[mode],
                    rand_seed=SEED, use_generated_assets=True)
    gd = make_game(cfg)
    if gd.kept_across_reset:
        assert set(gd.init_extra(cfg, N, "cpu")) == set(gd.kept_across_reset)
        monkeypatch.setattr(j_fast, "_KEEP_FIELDS", j_fast._KEEP_FIELDS + ("extra",))


def jax_fast_path(game, mode):
    cfg = JConfig(
        env_name=game, num_envs=N, distribution_mode=JMode[mode], rand_seed=SEED,
        use_generated_assets=True,
    )
    gd = j_make_game(cfg)
    pack = JPack(gd, cfg)
    tmpl = j_template(gd, cfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), tmpl)
    master = JR.HostMT(SEED)
    seeds = jnp.asarray([master.randint_full() for _ in range(N)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    init, step = j_make_fast_fns(gd, cfg, pack, refill_bucket=2)

    # one program per mode: the step and its frame
    @jax.jit
    def step_and_render(fs, acts):
        fs = step(fs, acts)
        return fs, j_fast2.render_frames2(gd, cfg, fs.state, pack)

    return jax.jit(init.cold)(batched), step_and_render


def run_against_reference(game, mode, steps, expect_reward=True):
    """Both fast paths side by side for ``steps`` steps; every state field
    and frame must agree.  Returns the number of episodes that ended."""
    j_fs, j_step = jax_fast_path(game, mode)

    cfg = EnvConfig(
        env_name=game, num_envs=N, distribution_mode=DistributionMode[mode],
        rand_seed=SEED, use_generated_assets=True,
    )
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=2)
    fs = init.cold(seeded_template(gd, cfg, N, device="cpu"))
    assert_fields_equal(jax_fields(j_fs), convert.fast_state_to_numpy(fs), "at cold start")

    rng = np.random.RandomState(11)
    resets = rewarded = 0
    for t in range(steps):
        if t in FORCED:
            acts = np.full((N,), -1, np.int32)
        else:
            acts = rng.randint(0, 15, size=N).astype(np.int32)
        j_fs, j_frame = j_step(j_fs, jnp.asarray(acts))
        fs = step(fs, torch.as_tensor(acts))
        resets += int(np.asarray(j_fs.state.done).sum())
        rewarded += int((np.asarray(j_fs.state.reward) != 0).sum())
        assert_fields_equal(
            jax_fields(j_fs), convert.fast_state_to_numpy(fs), f"at step {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(j_frame),
            fast2.render_frames2(gd, cfg, fs.state, pack).numpy(),
            err_msg=f"frame diverged at step {t}",
        )
    # the forced resets ran the queue path
    assert resets >= sum(t < steps for t in FORCED) * N
    assert rewarded > 0 or not expect_reward  # the game's reward paths ran
    assert compositor.launches == 0  # CPU tensors never reach the kernel
    return resets


@pytest.mark.parametrize(
    "mode,steps", [("easy", 150), ("hard", 150), ("memory", 110)]
)
def test_miner_fast_path_matches_reference(monkeypatch, mode, steps):
    pin_jax_kept_fields(monkeypatch, "miner", mode)
    run_against_reference("miner", mode, steps)
