"""Ranks and their collectives: the port's counterpart of ``shard_map``.

The JAX package writes its partitioned paths per shard inside ``shard_map``
with ``lax.ppermute``, ``psum``, ``pmean``, ``all_gather(tiled=True)`` and
``axis_index``. The port keeps that shape: each per-rank function takes a
``comm`` and this rank's rows, so it reads line by line beside its JAX
counterpart. A ``comm`` has ``rank``, ``size`` and

- ``ppermute(x, shift)``: rank r receives the ``x`` of rank r − shift (mod
  size), so ``shift=+1`` is JAX's ``perm=[(i, i + 1)]``; the ring wraps at
  both ends;
- ``psum(x)``, ``pmean(x)``: the sum (mean) over ranks, added in rank order
  so that every rank holds the same bits;
- ``all_gather(x, dim=0)``: the ranks' ``x`` concatenated along ``dim``;
- ``barrier()``;
- ``axis(name)``: this rank's comm over one axis of a ("data", "model")
  mesh (``LocalComm``; ``DistComm``'s processes are the data axis).

``x`` may be a tensor or a tree of them (tuples, ``NamedTuple``s, dicts,
as ``torch.utils._pytree`` flattens them); every rank passes the same
shapes, as under ``shard_map``.

Two implementations:

- ``LocalComm``: ranks as Python threads of one process on one device
  (``run_local``), the counterpart of the JAX package's virtual 8-device CPU
  mesh and the only way one card runs several ranks. Every rank enqueues on
  one stream (the device's current one, or the one ``Mesh.capture``
  captures), so a collective deposits its tensor, waits at a
  ``threading.Barrier`` and copies its peer's: stream order puts the copy
  after the producer, with no event. Each rank enqueues its reads of its
  peers' deposits before a second wait, so no rank goes on (to write its
  deposit in place, or deposit again) before they are enqueued. Nothing in
  a collective syncs with the host, so a run captures as one CUDA graph.
- ``DistComm``: over ``torch.distributed`` (``distributed.launch`` starts
  the processes). NCCL when each rank has a card of its own; gloo
  otherwise, and then a CUDA tensor goes through host memory.

A rank that raises aborts the barrier, so its peers raise too, and
``run_local`` re-raises the first exception; every wait has a timeout.
"""

from __future__ import annotations

import contextlib
import functools
import math
import operator
import threading
import time
from typing import Callable, Optional

import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

DEFAULT_TIMEOUT = 600.0     # seconds a run (and any one wait) may take


# -------------------------------------------------------------- LocalComm
class _Group:
    """What the threads of one ``run_local`` group (or of one of its axis
    sub-groups) share: a barrier and a slot a rank."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: list = [None] * size


class _Mesh:
    """The groups of one ``run_local`` run: the whole mesh and, for a
    (data, model) shape, one sub-group per row and per column of it."""

    def __init__(self, shape: tuple, timeout: float):
        self.shape = shape
        self.size = math.prod(n for _, n in shape)
        self.all = _Group(self.size, timeout)
        self.axes: dict = {}
        if len(shape) == 2:
            (a, na), (b, nb) = shape
            self.axes = {(a, j): _Group(na, timeout) for j in range(nb)}
            self.axes.update({(b, i): _Group(nb, timeout)
                              for i in range(na)})

    def abort(self) -> None:
        for g in (self.all, *self.axes.values()):
            g.barrier.abort()


class LocalComm:
    """One rank of a ``run_local`` group: ranks are threads on one device.

    On a (data, model) mesh the global rank is ``d * model + m`` (the
    reference's ``devices.reshape(data, model)``) and ``axis(name)`` is this
    rank's comm over one axis: the ranks that share its other coordinate,
    with a barrier and slots of their own, numbered along the axis."""

    def __init__(self, group: _Group, rank: int, mesh: "_Mesh" = None,
                 coords: Optional[tuple] = None):
        self.group, self.rank, self.size = group, rank, group.size
        self._mesh, self._coords = mesh, coords

    def axis(self, name: str) -> "LocalComm":
        """This rank's comm over the mesh axis ``name``."""
        shape = self._mesh.shape if self._mesh is not None else ()
        names = [a for a, _ in shape]
        if len(names) == 1 and name == names[0]:
            return self
        if len(names) != 2 or name not in names:
            raise ValueError(f"no axis {name!r} in a mesh of {shape}")
        i, j = self._coords
        if name == names[0]:
            return LocalComm(self._mesh.axes[(name, j)], i)
        return LocalComm(self._mesh.axes[(name, i)], j)

    def _exchange(self, x, read: Callable):
        """Deposit ``x``, then ``read(peers' deposits)`` before the second
        wait: no rank goes on (and may write its deposit in place) before
        every rank has enqueued its reads of it."""
        g = self.group
        g.slots[self.rank] = x
        g.barrier.wait()            # every rank has deposited
        out = read(list(g.slots))
        g.barrier.wait()            # every rank has read its peers
        return out

    def ppermute(self, x, shift: int):
        if self.size == 1:
            return x
        src = (self.rank - shift) % self.size
        return self._exchange(x, lambda peers: tree_map(torch.clone,
                                                        peers[src]))

    def psum(self, x):
        return self._exchange(x, lambda peers: tree_map(
            lambda *ts: functools.reduce(operator.add, ts), *peers))

    def pmean(self, x):
        return tree_map(lambda t: t / self.size, self.psum(x))

    def all_gather(self, x, dim: int = 0):
        return self._exchange(x, lambda peers: tree_map(
            lambda *ts: torch.cat(ts, dim=dim), *peers))

    def barrier(self) -> None:
        self.group.barrier.wait()


def run_local(size: int, fn: Callable, device=None,
              timeout: float = DEFAULT_TIMEOUT,
              shape: Optional[tuple] = None, stream=None) -> list:
    """``fn(comm)`` on ``size`` ranks, threads of this process sharing
    ``device``; returns the ranks' results in rank order.

    ``shape``: the mesh's axes as ((name, n), ...), n's product ``size``
    (default one axis, ``(("data", size),)``); with two, ``comm.axis``
    gives each rank its row and column groups. ``stream``: a CUDA stream
    every rank enqueues on (``Mesh.capture`` captures it), else the
    device's current one. Each rank runs under the caller's grad mode
    (which is per thread). A rank that raises aborts every barrier of the
    group, so every rank waiting at a collective raises
    ``BrokenBarrierError``; the first exception raised by ``fn`` itself is
    re-raised here. ``timeout`` bounds the whole run and any one wait: past
    it the barriers break and ``TimeoutError`` is raised (a thread still
    computing is left to finish as a daemon).
    """
    if size < 1:
        raise ValueError(f"size={size}: a run needs at least one rank")
    shape = tuple(shape) if shape is not None else (("data", size),)
    if math.prod(n for _, n in shape) != size:
        raise ValueError(f"a mesh of {shape} is not {size} ranks")
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = _Mesh(shape, timeout)
    inner = shape[-1][1]
    results: list = [None] * size
    errors: list = []               # (rank, exception), in the order raised
    grad = torch.is_grad_enabled()

    def body(rank: int) -> None:
        try:
            on_card = device is not None and device.type == "cuda"
            if on_card:
                torch.cuda.set_device(device)
            comm = LocalComm(mesh.all, rank, mesh, divmod(rank, inner))
            with torch.set_grad_enabled(grad), (
                    torch.cuda.stream(stream) if on_card and stream
                    is not None else contextlib.nullcontext()):
                results[rank] = fn(comm)
        except Exception as e:      # a rank's failure ends the whole run
            errors.append((rank, e))
            mesh.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(size)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        mesh.abort()
        raise TimeoutError(f"{', '.join(alive)} still running after "
                           f"{timeout} s")
    for rank, e in errors:
        if not isinstance(e, threading.BrokenBarrierError):
            raise e
    if errors:
        rank, e = errors[0]
        raise TimeoutError(f"rank {rank} waited at a collective for more "
                           f"than {timeout} s") from e
    return results


# --------------------------------------------------------------- DistComm
class DistComm:
    """This process's rank of an initialised ``torch.distributed`` group.

    ``ppermute`` is one ``batch_isend_irecv`` a hop and returns its input
    when the group has one rank; ``psum`` gathers and adds in rank order,
    as ``LocalComm`` does, so both give the same bits. With gloo, a CUDA
    tensor is copied to the host for the wire and back after it, and bools
    travel as uint8.

    Its collectives wait on the host, so a ``DistComm`` run cannot be
    captured as a CUDA graph: it is always eager, and asking for a graph
    over it raises (``sharding.ParallelTrainer``).
    """

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._via_host = dist.get_backend(group) == "gloo"

    def _wire(self, t: Tensor) -> Tensor:
        if self._via_host:
            t = t.cpu()
            if t.dtype == torch.bool:
                t = t.to(torch.uint8)
        return t.contiguous()

    @staticmethod
    def _back(w: Tensor, like: Tensor) -> Tensor:
        return w.to(device=like.device, dtype=like.dtype)

    def ppermute(self, x, shift: int):
        if self.size == 1:
            return x
        dist = self._dist
        leaves, spec = tree_flatten(x)
        dst = (self.rank + shift) % self.size
        src = (self.rank - shift) % self.size
        sends = [self._wire(t) for t in leaves]
        recvs = [torch.empty_like(s) for s in sends]
        ops = ([dist.P2POp(dist.isend, s, dst, self.group, tag=i)
                for i, s in enumerate(sends)]
               + [dist.P2POp(dist.irecv, r, src, self.group, tag=i)
                  for i, r in enumerate(recvs)])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tree_unflatten([self._back(r, t)
                               for r, t in zip(recvs, leaves)], spec)

    def _gathered(self, t: Tensor) -> list:
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        self._dist.all_gather(parts, w, group=self.group)
        return [self._back(p, t) for p in parts]

    def psum(self, x):
        return tree_map(lambda t: functools.reduce(operator.add,
                                                   self._gathered(t)), x)

    def pmean(self, x):
        return tree_map(lambda t: t / self.size, self.psum(x))

    def all_gather(self, x, dim: int = 0):
        return tree_map(lambda t: torch.cat(self._gathered(t), dim=dim), x)

    def axis(self, name: str):
        """This process's comm over a mesh axis: the processes are the
        ``data`` axis; the ``model`` axis has this one rank."""
        if name == "data":
            return self
        if name == "model":
            return LocalComm(_Group(1, DEFAULT_TIMEOUT), 0)
        raise ValueError(f"no axis {name!r}: processes run the data axis")

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)


def collectives(comm, x: Tensor) -> dict:
    """Every collective once on this rank's ``x`` [m, ...]: what two
    communicators must agree on (the tests hold ``DistComm`` to
    ``LocalComm`` with it)."""
    pair = (x, x > 0)
    return {
        "rank": torch.tensor([comm.rank]),
        "size": torch.tensor([comm.size]),
        "next": comm.ppermute(x, +1),
        "prev": comm.ppermute(x, -1),
        "pair": comm.ppermute(pair, +1),
        "psum": comm.psum(x),
        "pmean": comm.pmean(x),
        "count": comm.psum((x > 0).sum()).reshape(1),
        "all_gather": comm.all_gather(x),
    }
