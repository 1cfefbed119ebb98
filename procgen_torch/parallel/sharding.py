"""Env-axis sharding over processes (counterpart of
``procgen_tpu/parallel/sharding.py``).

The reference package shards one program over a device mesh: every state
leaf carries a leading ``num_envs`` axis split by ``NamedSharding(P("env"))``
and XLA keeps the program's semantics those of the unsharded one.  The port
runs one process per card over ``torch.distributed``: rank ``r`` of ``W``
owns the contiguous rows ``[r * N / W, (r + 1) * N / W)`` of every leaf.
Env stepping and rendering are per env and need no collective; the two
places where one env's result depends on others, the fast path's refill
priority (parallel/fast.py) and the learner's minibatch statistics and
gradients (learn/ppo.py), call the collectives below, so a W-rank run
computes what one process computes over the global batch.

Every collective is an ``all_reduce`` or a ``broadcast``: NCCL and gloo both
run those on CUDA tensors, so the same code runs with one process per card
(NCCL) and with several processes sharing one card (gloo).  An all-gather
is an ``all_reduce(SUM)`` of a zero-filled global byte buffer, which is
exact for every dtype.  Callers reach the collectives through this module
at call time (``sharding.all_reduce``), so a wrapper can time them.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
import uuid

import torch
import torch.distributed as dist

from procgen_torch import resolve_device
from procgen_torch.state import tree_map


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This process's place on the env axis: ``rank`` of ``world`` ranks,
    the device its rows live on, and the process group (None for the
    one-process mesh, whose collectives are the identity)."""

    rank: int
    world: int
    device: torch.device
    group: object = None

    @property
    def sharded(self) -> bool:
        return self.group is not None


def make_env_mesh(n_devices: int | None = None, device="cuda") -> EnvMesh:
    """The mesh over the default process group, or the one-rank mesh on
    ``device`` when no group was initialised."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices asked for without a process group")
        return EnvMesh(0, 1, resolve_device(device))
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"{n_devices} devices asked for in a group of {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return EnvMesh(dist.get_rank(), world, dev, dist.group.WORLD)


def env_sharding(mesh: EnvMesh, num_envs: int) -> tuple[int, int]:
    """(start, count) of the rows of a ``num_envs`` batch that ``mesh.rank``
    owns (the layout of ``NamedSharding(P("env"))``)."""
    if num_envs % mesh.world:
        raise ValueError(f"{num_envs} envs do not split over {mesh.world} ranks")
    per = num_envs // mesh.world
    return mesh.rank * per, per


def shard_env_state(state, mesh: EnvMesh):
    """This rank's rows of every leaf of a global batched EnvState or
    FastState (the counterpart of ``device_put`` with the env sharding)."""

    def rows(x):
        start, count = env_sharding(mesh, x.shape[0])
        return x[start:start + count].to(mesh.device)

    return tree_map(rows, state)


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None) -> EnvMesh:
    """Join the process group and return the env mesh.

    Without arguments it reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``.  ``coordinator_address`` is a
    ``host:port`` (TCP) or an init URL (``file:///path``).  On ``"cuda"``
    each process takes ``cuda:LOCAL_RANK`` (``cuda:process_id`` when
    LOCAL_RANK is unset) and NCCL; a device with an index (``"cuda:0"``)
    is taken as given, so that several ranks may share one card, which
    NCCL refuses: pass ``backend="gloo"`` for that.  ``device="cpu"`` takes
    gloo.  Raises without CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id or 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    return make_env_mesh(device=dev)


def rank_unique_seed(rand_seed: int, process_id: int | None = None) -> int:
    """The reference's env.py:54-63: a seed unique to each rank, so that
    hosts generate disjoint level streams."""
    pid = (dist.get_rank() if dist.is_initialized() else 0) if process_id is None else process_id
    return (rand_seed + 31 * pid) % (2**31 - 1)


def host_env_slice(num_envs_global: int) -> tuple[int, int]:
    """(start, count) of this process's env shard, the env axis split
    evenly over the processes."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    assert num_envs_global % n == 0, (num_envs_global, n)
    per = num_envs_global // n
    return pid * per, per


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; the identity on one process."""
    if mesh.sharded:
        dist.all_reduce(t, group=mesh.group)
    return t


def broadcast(t: torch.Tensor, mesh: EnvMesh, src: int = 0) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place."""
    if mesh.sharded:
        dist.broadcast(t, src, group=mesh.group)
    return t


def gather_rows(tensors, mesh: EnvMesh) -> list:
    """The global tensors of per-rank row shards: each result is the ranks'
    tensors concatenated along axis 0, bit for bit.  One all-reduce of a
    zero-filled byte buffer in which each rank writes its own row."""
    if not mesh.sharded:
        return list(tensors)
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    # each part starts on an 8-byte boundary, so that its bytes view as
    # its dtype again
    offs = [0]
    for p in parts:
        offs.append(offs[-1] + -(-p.numel() // 8) * 8)
    buf = torch.zeros((mesh.world, offs[-1]), dtype=torch.uint8, device=mesh.device)
    for p, off in zip(parts, offs):
        buf[mesh.rank, off:off + p.numel()] = p
    all_reduce(buf, mesh)
    return [buf[:, off:off + p.numel()].reshape(-1).view(t.dtype)
            .reshape((t.shape[0] * mesh.world,) + tuple(t.shape[1:]))
            for t, p, off in zip(tensors, parts, offs)]


def make_global_env_state(local_state, mesh: EnvMesh):
    """The global state assembled on every rank from the ranks' shards (for
    checks and tests: it holds the whole batch on each card)."""
    leaves = []
    tree_map(leaves.append, local_state)
    it = iter(gather_rows(leaves, mesh))
    return tree_map(lambda _: next(it), local_state)


def spawn_ranks(fn, world: int, workdir: str, args=(), timeout: float = 900.0, beside=None):
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes
    started with ``spawn`` (``fork`` after CUDA initialisation hangs), which
    meet through a file store under ``workdir``; ``beside()``, if given,
    runs in this process meanwhile.  Raises unless every rank exits 0; on
    the first failure, or at ``timeout`` seconds, the ranks still running
    (waiting in a collective) are terminated."""
    init_method = f"file://{os.path.join(os.path.abspath(workdir), 'store-' + uuid.uuid4().hex)}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(rank, world, init_method, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        if beside is not None:
            beside()
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks exited with {codes} (negative: stopped by a signal)")
