"""High-throughput stepping: pregenerated level queue + compacted refill
(counterpart of ``procgen_tpu/parallel/fast.py``).

Each env carries one pregenerated next-level state (the "queue").  A step
that finishes an episode swaps the queue entry in (exact: level content
depends only on the env's level_seed_rng, which the queue entry already
advanced); the queue is refilled for a compacted bucket of empty slots, so
levelgen cost scales with the episode-completion rate, not num_envs.

The refill loop runs on the host: ``while need.any()`` costs one device
sync per step.
"""

from __future__ import annotations

import dataclasses

import torch

from procgen_torch.engine.game import finish_step, reset_env, step_env_no_reset
from procgen_torch.render.fast2 import render_static2
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import EnvState, tree_map, tree_select

# step-output fields that must come from the dying step, not the pregen entry
_KEEP_FIELDS = (
    "reward",
    "done",
    "level_complete",
    "prev_level_seed",
    "last_reward",
    "last_reward_timer",
)


REFILL_SPAN = "procgen_torch.refill"


@dataclasses.dataclass
class FastState:
    state: EnvState  # live envs, batched
    queue: EnvState  # one pregenerated next level per env
    queue_valid: torch.Tensor  # bool (N,)


def make_fast_fns(gd, cfg, pack, refill_bucket: int = 1024):
    """Returns (init, step) for the fast path; ``init.cold`` starts from an
    unreset seeded template batch.  ``pack``: RenderPack; the refill renders
    each level's static layer so per-step frames composite entities only.
    States may live on any device; all work follows them."""
    if cfg.use_sequential_levels:
        raise ValueError("use_sequential_levels requires the inline reset path")

    def pregen(states: EnvState) -> EnvState:
        states = update_view_params(gd, cfg, reset_env(gd, cfg, states))
        return states.replace(static_layer=render_static2(gd, cfg, states, pack))

    def init(state: EnvState) -> FastState:
        n = state.num_envs
        # ensure the live state's static layer is rendered (first episodes)
        state = state.replace(static_layer=render_static2(gd, cfg, state, pack))
        none = torch.zeros((n,), dtype=torch.bool, device=state.done.device)
        return refill_if_needed(FastState(state, state, none), ~none)

    def cold_init(state: EnvState) -> FastState:
        """Initial FastState from an unreset seeded template batch: levels
        come from the same bucket-sized refill the step uses and are adopted
        as the live states (episode-0 resets of each env's level_seed_rng)."""
        n = state.num_envs
        none = torch.zeros((n,), dtype=torch.bool, device=state.done.device)
        fs = refill_if_needed(FastState(state, state, none), ~none)
        return FastState(fs.queue, fs.queue, none)

    def _compacted_refill(fs: FastState, need) -> FastState:
        n = fs.queue_valid.shape[0]
        bucket = min(refill_bucket, n)
        # refill priority: dying envs with empty queue first, then other
        # empty queues; ties by index (a stable sort on -score, as top_k)
        score = need.to(torch.int32) * 2 + (~fs.queue_valid).to(torch.int32)
        idx = torch.sort(-score, stable=True).indices[:bucket]
        fresh = pregen(tree_map(lambda a: a[idx], fs.state))
        fill = ~fs.queue_valid[idx]  # only write slots that were empty

        def scatter(qa, fa):
            out = qa.clone()
            f = fill.reshape(fill.shape + (1,) * (fa.dim() - 1))
            out[idx] = torch.where(f, fa, qa[idx])
            return out

        queue = tree_map(scatter, fs.queue, fresh)
        valid = fs.queue_valid.clone()
        valid[idx] = True
        return FastState(fs.state, queue, valid)

    def refill_if_needed(fs: FastState, need) -> FastState:
        # loop the bucket-sized refill until every dying env has a queue
        # entry; a mass simultaneous death iterates ceil(need / bucket) times
        while bool(need.any()):
            # a profiler span (free when no profiler runs): chip_smoke.py
            # reads the refill's share of the step from it
            with torch.profiler.record_function(REFILL_SPAN):
                fs = _compacted_refill(fs, need)
                need = need & ~fs.queue_valid
        return fs

    def step(fs: FastState, actions) -> FastState:
        stepped = step_env_no_reset(gd, cfg, fs.state, actions)
        need = stepped.done & ~fs.queue_valid
        fs = refill_if_needed(FastState(stepped, fs.queue, fs.queue_valid), need)

        # swap in pregen levels for finished episodes, keeping the dying
        # step's outputs
        merged_queue = fs.queue.replace(
            **{f: getattr(stepped, f) for f in _KEEP_FIELDS}
        )
        state = tree_select(stepped.done, merged_queue, stepped)
        state = finish_step(cfg, state)
        state = update_view_params(gd, cfg, state)
        valid = fs.queue_valid & ~stepped.done
        return FastState(state, fs.queue, valid)

    init.cold = cold_init
    return init, step
