"""The device mesh: axes ("data", "model") over data × model ranks.

Port of ``relationalgraphlearning_tpu/parallel/mesh.py``. The JAX package
lays its mesh over devices, and its tests over 8 virtual CPU devices. The
port's ranks are threads on one device (``comm.LocalComm``), up to
``RANKS`` of them: the counterpart of that virtual mesh, and what one card
runs. Rank ``d * model + m`` sits at (d, m), as the reference reshapes its
devices; ``comm.axis("data")`` and ``comm.axis("model")`` are its row and
column groups. ``Mesh.run`` is ``shard_map``'s ``in_specs``/``out_specs``
with rows sharded over "data" (replicated over "model"), and
``Mesh.capture`` records such a run of every rank once as one CUDA graph,
the counterpart of the one program ``jit(shard_map(...))`` compiles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import Tensor
from torch.utils._pytree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten)

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch.parallel.comm import run_local

RANKS = 8           # rank slots of one device (the reference's 8-CPU mesh)
ROW = "row"         # sharded over rows: split in D contiguous slices
REP = "rep"         # replicated: every rank holds the same value


def split_rows(x, size: int) -> list:
    """A tree of [n, ...] tensors → ``size`` trees of their contiguous
    [n/size, ...] row slices (``None`` stays ``None``)."""
    for t in tree_leaves(x):
        if t is not None and t.shape[0] % size:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{size} ranks")
    return [tree_map(lambda t: None if t is None else t[
        r * (t.shape[0] // size):(r + 1) * (t.shape[0] // size)], x)
            for r in range(size)]


def combine(outs: list, specs):
    """The ranks' outputs → one: ``ROW`` leaves concatenated in rank order,
    ``REP`` leaves taken from rank 0. ``specs`` is one spec for every leaf
    or a tree of specs shaped as the output's top levels."""
    if isinstance(specs, str):
        if specs == REP:
            return outs[0]
        spec = tree_flatten(outs[0])[1]
        return tree_unflatten([torch.cat(ts, dim=0) for ts in zip(
            *(tree_leaves(o) for o in outs))], spec)
    if isinstance(specs, dict):
        return {k: combine([o[k] for o in outs], s) for k, s in specs.items()}
    parts = [combine([o[i] for o in outs], s) for i, s in enumerate(specs)]
    like = outs[0]
    return type(like)(*parts) if hasattr(like, "_fields") else type(like)(
        parts)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks (threads) on ``device``."""

    data: int
    model: int = 1
    device: torch.device = torch.device("cuda")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def run(self, fn: Callable, replicated=(), row_sharded=(),
            out_specs=ROW, stream=None):
        """``fn(comm, *replicated, *rows)`` on every rank, where ``rows``
        are this rank's data slices of ``row_sharded`` (the ranks of one
        data row share them); the outputs of the model-rank-0 ranks, in
        data order, combined by ``out_specs`` (``ROW``, ``REP`` or a tree
        of them). ``comm`` spans the mesh; with ``model == 1`` it is the
        data axis. ``stream``: see ``run_local``."""
        parts = [split_rows(a, self.data) for a in row_sharded]
        outs = run_local(
            self.size,
            lambda comm: fn(comm, *replicated,
                            *(p[comm.rank // self.model] for p in parts)),
            device=self.device, stream=stream,
            shape=(("data", self.data), ("model", self.model)))
        return combine(outs[::self.model], out_specs)

    def capture(self, fn: Callable, replicated=(), row_sharded=(),
                out_specs=ROW, state: Sequence[Tensor] = ()) -> "MeshGraph":
        """``run`` of every rank recorded once as one CUDA graph
        (``MeshGraph``): ``graph(*row_sharded)`` replays it on new rows."""
        return MeshGraph(self, fn, replicated, row_sharded, out_specs, state)


class MeshGraph:
    """One ``Mesh.run`` of all ranks as one CUDA graph, replayed with one
    launch: the counterpart of the reference's ``jit(shard_map(...))``.

    The ranks' threads enqueue on one side stream, which the main thread
    captures (``capture_error_mode="relaxed"``, so the threads may call the
    CUDA runtime while it records). The caching allocator routes an
    allocation into the graph's pool by the capturing stream, whatever the
    thread, so every rank's tensors, the collectives' deposits and their
    copies live in that pool for as long as the graph. Between two
    collectives the ranks' work is independent, so any interleaving the
    threads happen to record is a valid serial order with the same bits;
    a replay equals the eager run.

    As ``captured.Graphed``, but with one eager warm-up run on the side
    stream first (it loads every kernel and sets up each thread's cuBLAS
    handle, which the capture's threads take back from the pool; a second
    run, which ``Graphed`` makes, would double the set-up of the largest
    meshes' graphs), ``state`` (what ``fn`` writes in place) restored after
    it, the static copies of ``row_sharded`` overwritten by each call, the
    outputs static (the next call overwrites them), and ``launches`` the
    kernel launches one replay holds, summed over the ranks. A capture that
    fails raises; nothing falls back to the eager run.
    """

    def __init__(self, mesh: Mesh, fn: Callable, replicated, row_sharded,
                 out_specs, state: Sequence[Tensor] = ()):
        if mesh.device.type != "cuda":
            raise ValueError(f"a CUDA graph captures ranks on the card; the "
                             f"mesh is on {mesh.device}")
        tensors = [t for t in (*tree_leaves(tuple(row_sharded)), *state)
                   if t is not None]
        if not all(isinstance(t, Tensor) and t.is_cuda for t in tensors):
            raise ValueError("a CUDA graph captures CUDA tensors")
        self.inputs = tree_map(lambda t: None if t is None else t.clone(),
                               tuple(row_sharded))
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(device=mesh.device)
        side.wait_stream(torch.cuda.current_stream(mesh.device))

        def run():
            return mesh.run(fn, replicated, self.inputs, out_specs,
                            stream=side)

        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(mesh.device).wait_stream(side)
        with torch.no_grad():
            for t, before in zip(state, saved):
                t.copy_(before)
        self.graph = torch.cuda.CUDAGraph()
        before = captured.launch_counts()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="relaxed"):
            self.outputs = run()
        self.launches = captured.launches_since(before)

    def __call__(self, *row_sharded):
        new = tree_leaves(tuple(row_sharded))
        static = tree_leaves(self.inputs)
        if len(new) != len(static):
            raise ValueError(f"{len(new)} input tensors, the graph takes "
                             f"{len(static)}")
        for s, t in zip(static, new):
            if s is None or t is s:
                continue
            if t.shape != s.shape or t.dtype != s.dtype:
                raise ValueError(f"an input of {tuple(t.shape)} {t.dtype}: "
                                 f"the graph was captured on "
                                 f"{tuple(s.shape)} {s.dtype}")
            s.copy_(t)
        self.graph.replay()
        return self.outputs


def make_mesh(data: Optional[int] = None, model: int = 1,
              device="cuda") -> Mesh:
    """Mesh with axes ("data", "model") over the ``RANKS`` rank slots of
    ``device``. Defaults: every slot on data. Explicit sizes may use a
    prefix of the slots; more than there are raises."""
    if data is None:
        data = RANKS // model
    if data * model > RANKS:
        raise ValueError(f"mesh {data}x{model} > {RANKS} devices")
    return Mesh(data, model, torch.device(device))
