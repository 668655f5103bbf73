"""Data parallelism across processes: the global batch over a process group.

The JAX package's trainer shards the batch over a mesh and lets XLA insert
the reductions, so BatchNorm's statistics, the loss's denominator and the
metrics are the global batch's (``pointnetgpd_tpu/training/train.py:10-13``,
``:74-78``). The port runs one process per rank (``torch.distributed``) and
takes the same global quantities by all-reduces:

- ``batch_group(group)``: while active, the train-mode BatchNorm of
  ``models/layers.py`` and ``models/fused_maxpool.py`` take their statistics
  over the group's whole batch;
- ``all_reduce_sum``: a differentiable sum over the group (its backward sums
  the cotangents over the group), so the statistics' gradients reach every
  rank's inputs;
- ``GroupExchange``: the exchange of ``parallel.mesh.ShardDraws`` across
  ranks: each rank asks the same seeded source for the whole batch's draw
  and keeps its rows; per-row counts are gathered first;
- ``spawn``: N ranks of a function under ``torch.multiprocessing``, on a
  free port of localhost, joined with a timeout.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
import torch.distributed as dist

_GROUP = None        # the process group of batch_group, or None


def active_group():
    """The group whose whole batch train-mode statistics run over (None:
    this process's batch)."""
    return _GROUP


@contextlib.contextmanager
def batch_group(group):
    """Take BatchNorm's statistics over ``group``'s whole batch (None: the
    local batch) while the context is active."""
    global _GROUP
    saved, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = saved


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's loss depends on the sum: its gradient is the sum of
        # the ranks' cotangents
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """Sum of ``x`` over ``group``, differentiable; ``x`` itself for no
    group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_(x, group):
    """In-place sum over ``group`` (not differentiable); returns ``x``."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x, group):
    """(b, ...) on each rank -> (world * b, ...), rank order. Built on
    all_reduce, which every backend takes for CUDA tensors."""
    if group is None:
        return x
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    out[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
    dist.all_reduce(out, group=group)
    return out


class GroupExchange:
    """``ShardDraws``' exchange across the ranks of ``group``: gather the
    local per-row values (equal row counts on every rank), then make the
    whole batch's draw on this rank (every rank holds the same source)."""

    def __init__(self, group):
        self.group = group

    def __call__(self, local, draw):
        if local is None:
            return draw([None])
        return draw([all_gather_rows(local, self.group)])


def group_draws(base, group, device):
    """This rank's ``ShardDraws`` of ``base`` over ``group``."""
    from .mesh import ShardDraws

    return ShardDraws(base, dist.get_rank(group), dist.get_world_size(group),
                      GroupExchange(group), device)


def free_port() -> int:
    """A free TCP port of localhost (bound to port 0 and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, init_method, backend, args):
    """One spawned rank: join the group, run ``fn``, leave the group. A
    rank that waits for the others gives up after 300 s."""
    import datetime

    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, args=(), timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one group over ``tcp://127.0.0.1:<free port>``; ``fn`` must be a
    module-level function. Raises if a rank fails or the ranks have not
    ended within ``timeout`` seconds (then they are killed)."""
    import torch.multiprocessing as mp

    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_entry, args=(fn, world, init_method, backend,
                                           tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline
                                                - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks of {fn.__name__} did not end within "
                    f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def environment_rank():
    """(rank, world) from torchrun's environment, or None outside it."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
