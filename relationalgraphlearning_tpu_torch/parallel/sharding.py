"""Sharding rules and the data- and tensor-parallel train step and
collection (port of ``relationalgraphlearning_tpu/parallel/sharding.py``).

The reference jits the one-device step with sharding constraints and lets
GSPMD insert the collectives; its semantics are whole-program, so a sharded
step computes what one device computes. The port writes those collectives
out, per rank of a ``Mesh`` ("data" × "model" threads on one card, or
``DistComm`` processes as the data axis):

- **data**: each data rank takes its ``torch.tensor_split`` slice of the
  minibatch (any batch size, as GSPMD accepts any). The losses divide by
  the global max(Σ valid, 1), a ``psum`` over data (a mean of per-rank
  means would be wrong whenever the shards hold different numbers of valid
  rows), and the gradients are summed over data inside the step;
- **model**: ``param_spec``'s rule, the last (output) dim of a 2-D flax
  kernel sharded over ``model`` when divisible, is dim 0 of an
  ``nn.Linear.weight``. Every such layer becomes a ``ShardedLinear``: it
  computes its slice of the output columns and all-gathers them over
  ``model``. The gradient of its slice is the slice of the output's
  gradient times the input; the gradient of its input, which Megatron's "f"
  sums over ``model`` in the backward, is formed whole from the weight the
  forward all-gathers. No collective runs in the backward: autograd runs a
  CUDA backward on one engine thread shared by every rank thread, where a
  rank waiting at a barrier would hold up its peers' backwards for good.
  Biases and 1-D leaves are replicated, and Adam's moments follow their
  parameter's shard. Every 2-D parameter of the port's nets is an
  ``nn.Linear`` weight (the LSTM's gates too), so the rule shards what the
  reference shards;
- the global-norm clip sums a sharded leaf's squared norm over ``model``
  and counts a replicated one once, after the data sum, so every rank
  applies the same update and the ranks of an axis keep the same bits.

A step (the minibatch gather, the loss, the gradients, their sums, the clip,
the optimizer step) of all ranks is captured as one CUDA graph
(``Mesh.capture``) and replayed for every minibatch, as the one-device
trainer replays its step. The collection splits the env batch over data:
a rank's envs keep their global ids and the global stride, read their
columns of the global draws, and the trajectories are gathered in rank
order, so the replay buffer is the one-device buffer slot for slot.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import Tensor, nn
from torch.nn import functional as F
from torch.utils._pytree import tree_map

from relationalgraphlearning_tpu_torch.parallel.mesh import REP, Mesh
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training.explorer import (
    RolloutCarry, Trajectory)
from relationalgraphlearning_tpu_torch.training.trainer import (
    MAX_GRAD_NORM, LossAux)


# ----------------------------------------------------------------- rules
def shard_batch(batch, data: int) -> list:
    """A batch tree → ``data`` trees of its leading-axis slices
    (``torch.tensor_split``: uneven where the batch does not divide); 0-d
    leaves replicated."""
    return [tree_map(lambda t: t if t.dim() == 0 else
                     torch.tensor_split(t, data)[d], batch)
            for d in range(data)]


def param_spec(shape, model: int) -> tuple:
    """The reference's TP rule on a flax leaf of ``shape``: (None,
    "model") for a 2-D kernel whose last (output) dim ``model`` divides,
    else () (replicated)."""
    if len(shape) == 2 and model > 1 and shape[-1] % model == 0:
        return (None, "model")
    return ()


def linear_sharded(layer: nn.Module, model: int) -> bool:
    """``param_spec`` in torch's layout: an ``nn.Linear`` whose weight's
    dim 0 (the output features) ``model`` divides."""
    return (isinstance(layer, nn.Linear) and model > 1
            and layer.out_features % model == 0)


class _ColumnParallel(torch.autograd.Function):
    """y = all_gather_model(x · w_localᵀ) over the last dim; the backward
    takes the gradient's own columns for ``w_local`` and forms the input's
    gradient whole from ``w_full`` (no collective in the backward)."""

    @staticmethod
    def forward(ctx, x, w_local, w_full, comm):
        ctx.save_for_backward(x, w_full)
        ctx.index, ctx.k = comm.rank, w_local.shape[0]
        return comm.all_gather(F.linear(x, w_local), dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, w_full = ctx.saved_tensors
        lo = ctx.index * ctx.k
        g_loc = g[..., lo:lo + ctx.k]
        grad_w = g_loc.reshape(-1, ctx.k).T @ x.reshape(-1, x.shape[-1])
        grad_x = g @ w_full if ctx.needs_input_grad[0] else None
        return grad_x, grad_w, None, None


class ShardedLinear(nn.Module):
    """Rank ``index`` of ``size`` of an ``nn.Linear``: ``weight`` its rows
    [index·k, (index+1)·k) (k = out/size), ``bias`` whole. ``comm``: the
    model axis of the rank that runs it (``bind``)."""

    def __init__(self, layer: nn.Linear, index: int, size: int):
        super().__init__()
        k = layer.out_features // size
        self.weight = nn.Parameter(
            layer.weight.detach()[index * k:(index + 1) * k].clone(),
            requires_grad=layer.weight.requires_grad)
        self.bias = None if layer.bias is None else nn.Parameter(
            layer.bias.detach().clone(),
            requires_grad=layer.bias.requires_grad)
        self.comm = None

    def forward(self, x: Tensor) -> Tensor:
        w_full = self.comm.all_gather(self.weight.detach(), dim=0)
        y = _ColumnParallel.apply(x, self.weight, w_full, self.comm)
        return y if self.bias is None else y + self.bias


def shard_params(module: nn.Module, index: int, model: int) -> nn.Module:
    """Model rank ``index``'s copy of ``module``: every ``linear_sharded``
    layer a ``ShardedLinear`` (the parameters keep their names)."""
    module = copy.deepcopy(module)
    for name, child in list(module.named_modules()):
        for key, sub in list(child.named_children()):
            if linear_sharded(sub, model):
                setattr(child, key, ShardedLinear(sub, index, model))
    return module


def _sharded_names(net: nn.Module, model: int) -> set:
    return {f"{name}.weight" if name else "weight"
            for name, mod in net.named_modules()
            if linear_sharded(mod, model)}


def _rows(t: Tensor, index: int, model: int) -> Tensor:
    k = t.shape[0] // model
    return t[index * k:(index + 1) * k]


class _RankStep:
    """One rank's trainer step on a mesh (mixed into the trainer's class):
    the global denominator, the gradients and losses summed over data, the
    clip's norm over the whole sharded tree."""

    def bind(self, comm) -> None:
        self.data_comm = comm.axis("data")
        model = comm.axis("model")
        for net in (self.net, self.target):
            for mod in net.modules():
                if isinstance(mod, ShardedLinear):
                    mod.comm = model
        self.model_comm = model

    def denominator(self, w: Tensor) -> Tensor:
        return torch.clamp(self.data_comm.psum(w.sum()), min=1.0)

    def compute_grads(self, batch, update_sp, use_td: bool = False
                      ) -> LossAux:
        aux = super().compute_grads(batch, update_sp, use_td)
        grads = [p.grad for p in self.params]
        with torch.no_grad():
            torch._foreach_copy_(grads, self.data_comm.psum(grads))
        return LossAux(*self.data_comm.psum(list(aux)))

    @torch.no_grad()
    def apply_grads(self) -> None:
        grads = [p.grad for p in self.params]
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        shard = self.model_comm.psum((sq * self.shard_mask).sum())
        norm = torch.sqrt(shard + (sq * (1.0 - self.shard_mask)).sum())
        torch._foreach_mul_(grads, torch.clamp(MAX_GRAD_NORM / norm,
                                               max=1.0))
        self.optimizer.step()


def _rank_class(cls: type) -> type:
    return type(f"Rank{cls.__name__}", (_RankStep, cls), {})


def shard_train_state(trainer, model: int, ranks: int) -> list:
    """``ranks`` rank trainers of ``trainer`` (rank r at model index
    r % ``model``): each holds its shards of the parameters, the target
    parameters and the optimizer's moments, gradients of the same shape,
    and an optimizer of the same kind and rate."""
    out = []
    names = _sharded_names(trainer.net, model)
    for r in range(ranks):
        m = r % model
        rt = copy.copy(trainer)
        rt.__class__ = _rank_class(type(trainer))
        rt.net = shard_params(trainer.net, m, model)
        rt.target = shard_params(trainer.target, m, model)
        rt.names, rt.params = map(list, zip(*rt.net.named_parameters()))
        for p in rt.params:
            p.grad = torch.zeros_like(p)
        rt.shard_mask = torch.tensor([float(n in names) for n in rt.names],
                                     device=rt.params[0].device)
        rt.aux_sum = torch.zeros_like(trainer.aux_sum)
        rt.set_learning_rate(trainer.learning_rate, trainer.optimizer_name)
        out.append(rt)
    _scatter(trainer, out, model)
    return out


@torch.no_grad()
def _scatter(trainer, ranks: list, model: int) -> None:
    """``trainer``'s parameters, target and optimizer state → every rank's
    shards of them."""
    names = _sharded_names(trainer.net, model)
    for r, rt in enumerate(ranks):
        m = r % model
        if (rt.optimizer_name, rt.learning_rate) != (
                trainer.optimizer_name, trainer.learning_rate):
            rt.set_learning_rate(trainer.learning_rate,
                                 trainer.optimizer_name)

        def part(name, t):
            return _rows(t, m, model) if name in names and t.dim() else t

        for src, dst in ((trainer.net, rt.net),
                         (trainer.target, rt.target)):
            own = dict(dst.named_parameters())
            for n, p in src.named_parameters():
                own[n].copy_(part(n, p))
        for n, p, q in zip(trainer.names, trainer.params, rt.params):
            for k, t in rt.optimizer.state[q].items():
                t.copy_(part(n, trainer.optimizer.state[p][k]))


@torch.no_grad()
def _gather(trainer, ranks: list, model: int) -> None:
    """The ranks' shards (those of data rank 0) → ``trainer``'s whole
    parameters, target and optimizer state."""
    names = _sharded_names(trainer.net, model)
    row = ranks[:model]

    def whole(name, parts):
        if name in names and parts[0].dim():
            return torch.cat(parts, dim=0)
        return parts[0]

    for get in (lambda rt: rt.net, lambda rt: rt.target):
        own = [dict(get(rt).named_parameters()) for rt in row]
        for n, p in get(trainer).named_parameters():
            p.copy_(whole(n, [o[n] for o in own]))
    for i, (n, p) in enumerate(zip(trainer.names, trainer.params)):
        for k, t in trainer.optimizer.state[p].items():
            t.copy_(whole(n, [rt.optimizer.state[rt.params[i]][k]
                              for rt in row]))


# ------------------------------------------------------------ train step
class ParallelTrainer:
    """The data- and tensor-parallel counterpart of a one-device trainer
    (``MPRLTrainer`` or ``VNRLTrainer``), with its interface: the train
    loop drives either.

    ``trainer`` stays the whole state the loop reads (its policy collects
    and evaluates; its ``state_dict`` is the checkpoint): the ranks' shards
    are gathered into it after every ``optimize`` and target update, and
    ``load_state`` scatters a restored state into them. On a ``Mesh`` the
    ranks are threads and a step of all of them is captured as one CUDA
    graph on the card (``graphed``: None captures on the card, eager on the
    CPU; True on the CPU raises; False is eager). With ``comm`` (a
    ``DistComm``: this process's rank of the data axis, the model axis of
    size 1) the step is eager, and asking for a graph raises: a collective
    through host memory cannot be captured.
    """

    def __init__(self, trainer, mesh: Optional[Mesh] = None, comm=None):
        if (mesh is None) == (comm is None):
            raise ValueError("a ParallelTrainer runs on a mesh or a comm")
        self.base, self.mesh, self.comm = trainer, mesh, comm
        self.model = mesh.model if mesh is not None else 1
        self.data = mesh.data if mesh is not None else comm.size
        self.ranks = shard_train_state(
            trainer, self.model, mesh.size if mesh is not None else 1)
        dev = trainer.params[0].device
        self._idx = None
        self._sp = torch.zeros((), device=dev)
        self._batches: dict = {}
        self._graphs: dict = {}

    # ------------------------------------------------ the loop's interface
    @property
    def net(self):
        return self.base.net

    @property
    def target(self):
        return self.base.target

    @property
    def params(self) -> list:
        return self.base.params

    def set_learning_rate(self, learning_rate: float,
                          optimizer: str = "adam") -> None:
        self.base.set_learning_rate(learning_rate, optimizer)
        for rt in self.ranks:
            rt.set_learning_rate(learning_rate, optimizer)
        self._graphs = {}

    def state_dict(self) -> dict:
        return self.base.state_dict()

    def load_state(self, state: dict, keep_optimizer: bool = False) -> None:
        self.base.load_state(state, keep_optimizer)
        _scatter(self.base, self.ranks, self.model)
        self._graphs = {}

    @torch.no_grad()
    def update_target(self) -> None:
        for rt in self.ranks:
            rt.update_target()
        self.base.update_target()

    # ------------------------------------------------------------ the step
    def _graphed(self, graphed: Optional[bool]) -> bool:
        on_card = self.base.params[0].is_cuda
        if graphed is None:
            graphed = on_card and self.comm is None
        if graphed and self.comm is not None:
            raise ValueError(f"a {type(self.comm).__name__} step cannot be "
                             "captured: its collectives wait on the host")
        if graphed and not on_card:
            raise ValueError("a graphed step needs CUDA tensors")
        return graphed

    def _run(self, fn, key, graphed: bool, statics: tuple):
        """``fn(comm, *statics)`` on every rank: a replay of its captured
        graph, or an eager run."""
        if self.comm is not None:
            return fn(self.comm, *statics)
        if not graphed:
            return self.mesh.run(fn, replicated=statics, out_specs=REP)
        graph = self._graphs.get(key)
        if graph is None:
            state = [t for rt in self.ranks for t in rt.state_tensors()]
            graph = self.mesh.capture(fn, replicated=statics, out_specs=REP,
                                      state=state)
            self._graphs[key] = graph
        return graph()

    def _rank(self, comm):
        rt = self.ranks[comm.rank if self.comm is None else 0]
        rt.bind(comm)
        return rt, comm.axis("data").rank

    def train_step(self, batch: rb.Transition, update_sp,
                   use_td: bool = False, graphed: Optional[bool] = None
                   ) -> LossAux:
        """One step on the global ``batch`` (each data rank its slice) ->
        the global losses; the whole state gathered into the trainer."""
        graphed = self._graphed(graphed)
        key = ("batch", use_td, tuple(t.shape for t in batch))
        static = self._batches.get(key)
        if static is None:
            static = self._batches[key] = tree_map(torch.clone, batch)
        else:
            tree_map(lambda dst, src: dst.copy_(src), static, batch)
        self._sp.fill_(float(update_sp))

        def step(comm, b):
            rt, d = self._rank(comm)
            return torch.stack(rt.train_step(shard_batch(b, self.data)[d],
                                             self._sp, use_td))

        aux = self._run(step, key, graphed, (static,))
        _gather(self.base, self.ranks, self.model)
        return LossAux(*aux.clone())

    __call__ = train_step

    def optimize(self, buffer: rb.ReplayBuffer, idx: Tensor,
                 use_td: bool = False, sp_always: bool = False,
                 graphed: Optional[bool] = None) -> LossAux:
        """``MPRLTrainer.optimize`` over the mesh: one step on each
        minibatch ``idx[i]``, every data rank gathering its slice of it
        from the (replicated) buffer -> the mean global losses."""
        graphed = self._graphed(graphed)
        if self._idx is None or self._idx.shape != idx.shape[1:]:
            self._idx = torch.zeros_like(idx[0])
            self._graphs = {}
        for rt in self.ranks:
            rt.aux_sum.zero_()

        def step(comm, i, sp):
            rt, d = self._rank(comm)
            rt.train_step(rb.sample(buffer, torch.tensor_split(
                i, self.data)[d]), sp, use_td)

        key = (idx.shape[1], use_td, id(buffer))
        stride = 1 if sp_always else self.base.sp_update_stride
        for i in range(idx.shape[0]):
            self._idx.copy_(idx[i])
            self._sp.fill_(float(i % stride == 0))
            self._run(step, key, graphed, (self._idx, self._sp))
        _gather(self.base, self.ranks, self.model)
        mean = self.ranks[0].aux_sum / idx.shape[0]
        return LossAux(mean[0], mean[1])

    def optimize_batches(self, buffer: rb.ReplayBuffer,
                         generator: torch.Generator, num_batches: int,
                         batch_size: int, graphed: Optional[bool] = None
                         ) -> LossAux:
        idx = rb.sample_indices(buffer, generator, (num_batches, batch_size))
        return self.optimize(buffer, idx, use_td=self.base.rl_recomputes_td,
                             graphed=graphed)


def make_parallel_train_step(trainer, mesh: Mesh) -> ParallelTrainer:
    """The trainer's step over ``mesh``: ``step(batch, update_sp)`` ->
    the global losses (``ParallelTrainer``)."""
    return ParallelTrainer(trainer, mesh)


# ------------------------------------------------------------ collection
class ParallelCollect:
    """``Explorer.collect`` with the env batch split over the data axis.

    Data rank d steps envs [d·b, (d+1)·b) of the global batch B (b = B/D):
    their carry keeps the global case ids and a reset strides by B, and it
    reads columns [d·b, (d+1)·b) of the global draws. The trajectories and
    carries are gathered in rank order (dim 1 and dim 0). The policy reads
    the trainer's whole parameters (``ParallelTrainer`` gathers them after
    each sweep), so the model axis takes no part here. On a ``Mesh`` one
    step of every rank is captured as one CUDA graph and replayed
    ``num_steps`` times (``graphed`` as ``Explorer.collect``); with a
    ``DistComm`` this process steps its envs eagerly and all-gathers.
    """

    def __init__(self, explorer, num_steps: int, phase_offset: int,
                 mesh: Optional[Mesh] = None, comm=None):
        if (mesh is None) == (comm is None):
            raise ValueError("a ParallelCollect runs on a mesh or a comm")
        self.explorer, self.num_steps = explorer, num_steps
        self.phase_offset = phase_offset
        self.comm = comm
        self.mesh = None if mesh is None else Mesh(mesh.data, 1, mesh.device)
        self.data = mesh.data if mesh is not None else comm.size
        self._graphs: dict = {}

    def __call__(self, carry: RolloutCarry, epsilon: float = 0.0,
                 draws: Optional[tuple] = None,
                 graphed: Optional[bool] = None
                 ) -> tuple[RolloutCarry, Trajectory]:
        expl, K, D = self.explorer, self.num_steps, self.data
        B, on_card = carry.ep_step.shape[0], carry.robot.is_cuda
        if B % D:
            raise ValueError(f"train_envs={B} not divisible by data axis "
                             f"{D}")
        if graphed is None:
            graphed = on_card and self.comm is None
        if graphed and self.comm is not None:
            raise ValueError("a DistComm collection cannot be captured")
        if graphed and not on_card:
            raise ValueError("a graphed collection needs CUDA tensors")
        if draws is None and epsilon != 0:
            raise ValueError("exploration with epsilon > 0 needs draws")
        b = B // D
        table = expl.case_table(self.phase_offset)
        table.ensure(int(carry.case_counter.max()) + B * K + 1)
        mine = range(D) if self.comm is None else [self.comm.rank]
        key = (B, table.capacity)
        if graphed and key in self._graphs:
            works, step = self._graphs[key]
        else:
            works = {d: expl._work(b, K) for d in mine}

            def one(comm):
                expl._collect_step(works[comm.rank], table, stride=B)

            if self.comm is not None:
                step = lambda: one(self.comm)  # noqa: E731
            elif graphed:
                step = self.mesh.capture(
                    one, out_specs=REP, state=[t for w in works.values()
                                               for t in w.tensors()])
                self._graphs = {key: (works, step)}
            else:
                step = lambda: self.mesh.run(one, out_specs=REP)  # noqa
        for d, w in works.items():
            cols = slice(d * b, (d + 1) * b)
            for dst, src in zip(w.carry, carry):
                dst.copy_(src[cols])
            w.t.zero_()
            w.epsilon.fill_(float(epsilon))
            if draws is not None:
                w.explore_idx.copy_(draws[0][:, cols])
                w.explore_u.copy_(draws[1][:, cols])
        for _ in range(K):
            step()
        if self.comm is not None:
            w = works[self.comm.rank]
            return (RolloutCarry(*self.comm.all_gather(tuple(w.carry))),
                    Trajectory(*self.comm.all_gather(tuple(w.traj), dim=1)))
        return (RolloutCarry(*(torch.cat([works[d].carry[i] for d in mine])
                               for i in range(len(carry)))),
                Trajectory(*(torch.cat([works[d].traj[i] for d in mine],
                                       dim=1)
                             for i in range(len(Trajectory._fields)))))


def make_parallel_collect(explorer, mesh: Mesh, num_steps: int,
                          phase_offset: int) -> ParallelCollect:
    """The explorer's collection with the env batch split over ``mesh``'s
    data axis (``ParallelCollect``)."""
    return ParallelCollect(explorer, num_steps, phase_offset, mesh=mesh)
