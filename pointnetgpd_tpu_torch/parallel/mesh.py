"""Device meshes and shard helpers: the port's data-parallel layer.

Port of ``pointnetgpd_tpu/parallel/mesh.py``. Within one process the JAX
package's mesh is an ordered set of devices with the batch axis split over
them; here a ``Mesh`` is a tuple of ``torch.device``s. A
device may repeat: ``make_mesh(8, device="cpu")`` is eight shards on the
CPU, as the JAX tests' eight virtual CPU devices are, and
``make_mesh(2, device="cuda:0")`` two shards on one card.

Work on a mesh is split along its leading axis, one equal chunk per shard
(``shard_batch``, after ``pad_to_multiple``). ``run_shards`` runs each
shard's work in a host thread of its own, with that shard's device
current, so the shards' work is dispatched without a host synchronization
between them; the caller gathers the outputs once onto the first device
(``gather``).

Sharding must not change a random draw: ``ShardDraws`` hands a shard its
rows of what a ``draws.Draws`` source makes for the whole batch. A draw
whose numbers depend on per-row counts (the crop's) needs every shard's
counts first: the shards exchange them at a ``Rendezvous`` (threads of one
process) or by a collective (``parallel/dist.py``, ranks of a process
group), and the base source is asked once for the whole batch.

Across processes: ``initialize_distributed`` joins the process group that
``torchrun`` (or ``torch.multiprocessing.spawn``) describes.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
from dataclasses import dataclass
from typing import ClassVar

import torch

# seconds a shard waits at a rendezvous for the others before the run fails
RENDEZVOUS_TIMEOUT = 600.0


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one per shard, along the batch axis
    (``axis_name``, always "dp")."""

    devices: tuple
    axis_name: ClassVar[str] = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> tuple:
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A 1-D mesh. ``device="cuda"``: the first ``n_devices`` CUDA devices
    (all of them by default); a named device (``"cuda:0"``, ``"cpu"``):
    ``n_devices`` shards on it (default 1). Raises where the devices asked
    for are not there: a mesh never drops to fewer shards."""
    dev = torch.device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"{n} CUDA devices asked for, {count} present; "
                             "name one device (e.g. 'cuda:0') to put "
                             "several shards on it")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh(device={device!r}): no CUDA device")
    return Mesh((dev,) * (n_devices or 1))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(x, mesh: Mesh, fill=0):
    """Pad the leading axis of ``x`` to a multiple of the mesh size with
    ``fill`` and split it: one chunk per shard, each on its device."""
    n = x.shape[0]
    n_pad = pad_to_multiple(max(n, 1), mesh.size)
    if n_pad > n:
        x = torch.cat([x, torch.full((n_pad - n,) + tuple(x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    return [c.to(d, non_blocking=True)
            for c, d in zip(x.chunk(mesh.size), mesh.devices)]


def gather(chunks, device):
    """Concatenate per-shard outputs (tensors, or tuples of tensors) along
    the leading axis onto ``device``."""
    if isinstance(chunks[0], (tuple, list)):
        return type(chunks[0])(gather([c[i] for c in chunks], device)
                               for i in range(len(chunks[0])))
    return torch.cat([c.to(device, non_blocking=True) for c in chunks])


def replicate(x, mesh: Mesh):
    """One copy of a module or tensor per distinct device of the mesh, as a
    list indexed by shard (shards on one device share its copy). A
    module's copy on its own device is the module itself."""
    copies = {}
    for d in mesh.distinct():
        if isinstance(x, torch.nn.Module):
            on = next(iter(x.parameters()), torch.empty(0)).device
            copies[d] = x if on == d else copy.deepcopy(x).to(d)
        else:
            copies[d] = x.to(d)
    return [copies[d] for d in mesh.devices]


@contextlib.contextmanager
def on_device(device):
    """Make ``device`` the thread's current CUDA device (kernels launch on
    the current device's context); a no-op for the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


class Rendezvous:
    """Where the shards of one process meet to exchange a value: each shard
    deposits its own, ``combine`` runs once on all of them, and every shard
    gets its result. A shard that fails aborts it, so the others raise
    instead of waiting."""

    def __init__(self, n: int, timeout: float = RENDEZVOUS_TIMEOUT):
        self.n = n
        self._slots = [None] * n
        self._combine = None
        self._out = None
        self._barrier = threading.Barrier(n, action=self._act,
                                          timeout=timeout)
        self._read = threading.Barrier(n, timeout=timeout)

    def _act(self):
        self._out = self._combine(self._slots)

    def exchange(self, shard: int, local, combine):
        if self.n == 1:
            return combine([local])
        self._slots[shard] = local
        self._combine = combine
        self._barrier.wait()         # the last shard in runs combine
        out = self._out
        self._read.wait()            # all have read it before the next
        return out

    def abort(self):
        self._barrier.abort()
        self._read.abort()


def run_shards(mesh: Mesh, fn, *per_shard, rendezvous: Rendezvous | None
               = None):
    """``[fn(s, *(a[s] for a in per_shard)) for s in shards]``, each shard
    in a host thread of its own with its device current. The first
    exception of any shard is raised after every thread has ended."""
    n = mesh.size
    results, errors = [None] * n, []

    def work(s):
        try:
            with on_device(mesh.devices[s]):
                results[s] = fn(s, *(a[s] for a in per_shard))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            if rendezvous is not None:
                rendezvous.abort()

    if n == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(s,), daemon=True)
                   for s in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        # a shard's own error before the broken barriers it caused
        errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        raise errors[0]
    return results


class ShardDraws:
    """Shard ``shard`` of ``n`` equal row blocks of what the draws source
    ``base`` makes for the whole batch (the ``draws.Draws`` methods).
    ``exchange(local, combine)`` meets the other shards: it takes this
    shard's local value (its counts, or None), and returns
    ``combine(all shards' values)``, which asks ``base`` for the whole
    batch's draw. ``Rendezvous.exchange`` (threads) and
    ``parallel.dist.GroupExchange`` (ranks) are the two exchanges."""

    def __init__(self, base, shard: int, n: int, exchange, device):
        self.base, self.shard, self.n = base, shard, n
        self._exchange = exchange
        self.device = torch.device(device)

    def _rows(self, t):
        blk = t.shape[0] // self.n
        return t[self.shard * blk:(self.shard + 1) * blk].to(self.device)

    @staticmethod
    def _cat(counts):
        dev = counts[0].device
        return torch.cat([c.to(dev) for c in counts])

    def crop_perm(self, p: int):
        return self._exchange(None, lambda _: self.base.crop_perm(p)).to(
            self.device)

    def crop_windows(self, count, num_out: int):
        r, start = self._exchange(count, lambda cs: self.base.crop_windows(
            self._cat(cs), num_out))
        return self._rows(r), self._rows(start)

    def crop_keys(self, g: int, p_len: int):
        return self._rows(self._exchange(None, lambda _: self.base.crop_keys(
            g * self.n, p_len)))

    def crop_ranks(self, count, num_out: int):
        return self._rows(self._exchange(
            count, lambda cs: self.base.crop_ranks(self._cat(cs), num_out)))

    def resample(self, n: int, num_points: int, p_in: int):
        return self._rows(self._exchange(None, lambda _: self.base.resample(
            n * self.n, num_points, p_in)))

    def per_sample(self, b: int):
        src = self._exchange(None, lambda _: self.base.per_sample(b * self.n))
        return ShardDraws(src, self.shard, self.n, self._exchange,
                          self.device)



def thread_draws(base, mesh: Mesh, rendezvous: Rendezvous):
    """One ``ShardDraws`` per shard of ``mesh``, meeting at ``rendezvous``."""
    return [ShardDraws(base, s, mesh.size,
                       lambda local, draw, s=s: rendezvous.exchange(
                           s, local, draw), d)
            for s, d in enumerate(mesh.devices)]


def initialize_distributed(backend: str | None = None,
                           device: str = "cuda"):
    """Join the process group that the environment describes (``torchrun``
    sets WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT). Returns the world
    size; a no-op that returns 1 only when the environment names no world
    size. Errors of ``init_process_group`` propagate."""
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return world
