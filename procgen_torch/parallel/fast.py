"""High-throughput stepping: pregenerated level queue + compacted refill
(counterpart of ``procgen_tpu/parallel/fast.py``).

Each env carries one pregenerated next-level state (the "queue").  A step
that finishes an episode swaps the queue entry in (exact: level content
depends only on the env's level_seed_rng, which the queue entry already
advanced); the queue is refilled for a compacted bucket of empty slots, so
levelgen cost scales with the episode-completion rate, not num_envs.

The refill loop runs on the host: its test for a dying env costs one
device sync per step (and, under a mesh, one all-reduce of the N refill
scores).  Under a profiler (``procgen_torch.telemetry``) the step, the
refill and its two halves are spans, the refill counts the rows it
pregenerates and those it writes into an empty queue slot, and the step
counts the rows that swap in their queued level (``fast.swaps``).
"""

from __future__ import annotations

import dataclasses

import torch

from procgen_torch import telemetry
from procgen_torch.engine.game import finish_step, reset_env, step_env_no_reset
from procgen_torch.parallel import sharding
from procgen_torch.render.fast2 import render_static2
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import EnvState, tree_map, tree_select

# step-output fields that must come from the dying step, not the pregen entry
# (besides the game's ``kept_across_reset`` fields of ``extra``)
_KEEP_FIELDS = (
    "reward",
    "done",
    "level_complete",
    "prev_level_seed",
    "last_reward",
    "last_reward_timer",
)


REFILL_SPAN = "procgen_torch.refill"
LEVELGEN_SPAN = "procgen_torch.refill.levelgen"
BAKE_SPAN = "procgen_torch.refill.bake"
GAME_STEP_SPAN = "procgen_torch.game_step"


@dataclasses.dataclass
class FastState:
    state: EnvState  # live envs, batched
    queue: EnvState  # one pregenerated next level per env
    queue_valid: torch.Tensor  # bool (N,)


def make_fast_fns(gd, cfg, pack, refill_bucket: int = 1024, mesh=None):
    """Returns (init, step) for the fast path; ``init.cold`` starts from an
    unreset seeded template batch.  ``pack``: RenderPack; the refill renders
    each level's static layer so per-step frames composite entities only.
    States may live on any device; all work follows them.  With a sharded
    ``mesh`` (parallel/sharding.py) the states are this rank's rows of the
    global batch and ``refill_bucket`` is the global bucket."""
    if mesh is not None and not mesh.sharded:
        mesh = None
    if cfg.use_sequential_levels:
        raise ValueError("use_sequential_levels requires the inline reset path")

    def pregen(states: EnvState) -> EnvState:
        with telemetry.span(LEVELGEN_SPAN):
            states = update_view_params(gd, cfg, reset_env(gd, cfg, states))
        with telemetry.span(BAKE_SPAN):
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

    def _refill_rows(fs: FastState, idx) -> FastState:
        """Pregenerate the live rows ``idx`` and write them into the queue
        slots among them that were empty."""
        fresh = pregen(tree_map(lambda a: a[idx], fs.state))
        fill = ~fs.queue_valid[idx]  # only write slots that were empty
        telemetry.count("refill.rows", idx.numel())
        telemetry.count("refill.rows_used", fill)

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
        # entry; a mass simultaneous death iterates ceil(need / bucket) times.
        # Refill priority: dying envs with empty queue first, then other
        # empty queues; ties by index (a stable sort on -score, as top_k).
        # Which env refills on which step is part of the state (a queue
        # entry carries the bookkeeping of the step that generated it), so
        # under a mesh the priority and the bucket are global: every rank
        # gathers all N scores, takes the same top ``bucket`` and
        # pregenerates the chosen rows it owns (possibly none), and every
        # rank runs the same number of iterations.
        n = fs.queue_valid.shape[0]
        start = 0 if mesh is None else mesh.rank * n
        while True:
            score = need.to(torch.int32) * 2 + (~fs.queue_valid).to(torch.int32)
            if mesh is not None:
                (score,) = sharding.gather_rows([score], mesh)
            telemetry.count("host_reads.fast.refill_test")
            if not bool((score >= 2).any()):  # score >= 2 iff need
                return fs
            # a span (one flag read when no profiler runs): the benchmark
            # reads the refill's share of the step from it
            with telemetry.span(REFILL_SPAN):
                idx = torch.sort(-score, stable=True).indices[:min(refill_bucket, score.shape[0])]
                if mesh is not None:
                    idx = idx[(idx >= start) & (idx < start + n)] - start
                if idx.numel():
                    fs = _refill_rows(fs, idx)
                need = need & ~fs.queue_valid

    def step(fs: FastState, actions) -> FastState:
        telemetry.count("fast.steps")
        with telemetry.span(GAME_STEP_SPAN):
            stepped = step_env_no_reset(gd, cfg, fs.state, actions)
        need = stepped.done & ~fs.queue_valid
        fs = refill_if_needed(FastState(stepped, fs.queue, fs.queue_valid), need)

        # swap in pregen levels for finished episodes, keeping the dying
        # step's outputs and the game state the reference keeps across a
        # reset (the inline reset leaves both alone)
        telemetry.count("fast.swaps", stepped.done)
        merged_queue = fs.queue.replace(
            extra={**fs.queue.extra, **{f: stepped.extra[f] for f in gd.kept_across_reset}},
            **{f: getattr(stepped, f) for f in _KEEP_FIELDS},
        )
        state = tree_select(stepped.done, merged_queue, stepped)
        state = finish_step(cfg, state)
        state = update_view_params(gd, cfg, state)
        valid = fs.queue_valid & ~stepped.done
        return FastState(state, fs.queue, valid)

    init.cold = cold_init
    return init, step
