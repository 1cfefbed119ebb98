"""Episode loop: Game::step / Game::reset (game.cpp:93-165); counterpart of
``procgen_tpu/engine/game.py``.  All functions take and return a batch.

``step_env`` resets finished envs inline (levelgen for the whole batch,
selected per env): the exact but slow path for tests and small batches.
The high-throughput path swaps in pregenerated levels
(procgen_torch/parallel/fast.py).
"""

from __future__ import annotations

import torch

from procgen_torch import rng as R
from procgen_torch.state import I32, EnvState, tree_select


def reset_env(gd, cfg, state: EnvState) -> EnvState:
    """Game::reset (game.cpp:93-118)."""
    er0 = state.episodes_remaining == 0
    seq_keep = state.level_complete & bool(cfg.use_sequential_levels)
    # sequential path: wrapping int32 add (game.cpp:97-100)
    seed_seq = R.to_int32(state.current_level_seed.to(torch.int64) + 997)
    lrng, drawn = R.mt_randint(
        state.level_seed_rng,
        cfg.level_seed_low,
        cfg.level_seed_high,
        active=er0 & ~seq_keep,
    )
    new_seed = torch.where(
        er0, torch.where(seq_keep, seed_seq, drawn), state.current_level_seed
    )
    # else-branch bookkeeping (game.cpp:105-109); unreachable in practice
    # because episodes_remaining is always 0 at reset, kept for fidelity.
    state = state.replace(
        level_seed_rng=lrng,
        current_level_seed=new_seed,
        episodes_remaining=torch.where(er0, 1, state.episodes_remaining),
        reward=torch.where(er0, state.reward, 0.0),
        done=state.done & er0,
        level_complete=state.level_complete & er0,
    )
    # level generation draws through a prefetched block
    rs = R.mt_block_open(R.mt_seed(new_seed), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    state = state.replace(rng=R.mt_block_close(rs))
    return state.replace(
        cur_time=torch.zeros_like(state.cur_time),
        episodes_remaining=state.episodes_remaining - 1,
        action=torch.full_like(state.action, gd.default_action),
    )


def step_env_no_reset(gd, cfg, state: EnvState, action) -> EnvState:
    """Game::step (game.cpp:120-143) without the auto-reset: a finished env
    keeps its final state; the caller swaps in a new level before the next
    step (inline reset or level queue)."""
    action = torch.as_tensor(action, device=state.done.device).to(I32)
    cur_time = state.cur_time + 1
    force = action == -1
    action = torch.where(force, gd.default_action, action)

    state = state.replace(
        cur_time=cur_time,
        action=action,
        reward=torch.zeros_like(state.reward),
        done=torch.zeros_like(state.done),
        level_complete=torch.zeros_like(state.level_complete),
    )
    state = gd.game_step(cfg, state)

    done = state.done | force | (cur_time >= state.timeout)
    reward = state.reward
    return state.replace(
        done=done,
        last_reward_timer=torch.where(reward != 0, 10, state.last_reward_timer),
        last_reward=torch.where(reward != 0, reward, state.last_reward),
        prev_level_seed=state.current_level_seed,
    )


def finish_step(cfg, state: EnvState) -> EnvState:
    """Post-reset step epilogue (game.cpp:148-153): sequential-levels
    chaining hides the done, then episode_done is latched."""
    if cfg.use_sequential_levels:
        state = state.replace(done=state.done & ~state.level_complete)
    return state.replace(episode_done=state.done)


def step_env(gd, cfg, state: EnvState, action) -> EnvState:
    """Game::step (game.cpp:120-155) with inline masked auto-reset: when
    done, the returned state already holds the next level.  The reset runs
    only on steps where some env finished (one host read per step): a
    reset is levelgen for the whole batch, and leaper's pre-rolls 300
    physics steps."""
    state = step_env_no_reset(gd, cfg, state, action)
    if bool(state.done.any()):
        reset_state = reset_env(gd, cfg, state)
        state = tree_select(state.done, reset_state, state)
    return finish_step(cfg, state)
