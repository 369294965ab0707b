"""The device mesh: axes ("data", "model") over D ranks.

Port of ``relationalgraphlearning_tpu/parallel/mesh.py``. The JAX package
lays its mesh over devices, and its tests over 8 virtual CPU devices. The
port's ranks are threads on one device (``comm.LocalComm``), up to
``RANKS`` of them: the counterpart of that virtual mesh, and what one card
runs. ``Mesh.run`` is ``shard_map``'s ``in_specs``/``out_specs`` over the
"data" axis; the "model" axis is recorded for the train step's sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils._pytree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten)

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
    """``data`` ranks (threads) on ``device``; ``model`` recorded."""

    data: int
    model: int = 1
    device: torch.device = torch.device("cuda")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def run(self, fn: Callable, replicated=(), row_sharded=(),
            out_specs=ROW):
        """``fn(comm, *replicated, *rows)`` on every rank of the data axis,
        where ``rows`` are this rank's slices of ``row_sharded``; the
        outputs combined by ``out_specs`` (``ROW``, ``REP`` or a tree of
        them)."""
        parts = [split_rows(a, self.data) for a in row_sharded]
        outs = run_local(
            self.data,
            lambda comm: fn(comm, *replicated,
                            *(p[comm.rank] for p in parts)),
            device=self.device)
        return combine(outs, out_specs)


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
