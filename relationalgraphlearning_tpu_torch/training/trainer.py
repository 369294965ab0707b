"""Trainers: optimisation steps over the replay buffer (port of
``relationalgraphlearning_tpu/training/trainer.py``).

``MPRLTrainer`` fits MP-RGL's value estimator (the ``valid``-weighted MSE
to the stored Monte-Carlo value, or to a TD target recomputed from the
current target net for each minibatch) and its state predictor (the MSE of
the predicted next human states under a zero action, scaled by
``update_sp``); ``VNRLTrainer`` fits the stored values only.

The reference's ``TrainState`` is a pytree each step returns anew; here the
state lives in place: the policy's nets (the parameters), a copy of them
(the target), the optimizer's moments and step count, and the gradients;
``state_dict`` snapshots it (what a checkpoint holds) and ``load_state``
writes one back.
Every update writes into those tensors (``optimizer.step``, ``copy_`` for
the target, ``load_state`` for a restore), so CUDA graphs that read them
(the captured SGD step, ``Explorer``'s evaluation and collection graphs)
stay right. One SGD step (the minibatch gather at given indices, the loss,
backward, the clip, the optimizer step) is captured once as a CUDA graph
per optimizer and target kind and replayed for every minibatch, as the
reference runs a sweep as one ``lax.scan``.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.utils import profiling

MAX_GRAD_NORM = 10.0


def make_optimizer(name: str, learning_rate: float, params
                   ) -> torch.optim.Optimizer:
    """Adam, or SGD with momentum 0.9 (``trainer.py:31-41``), its state
    made at once (zero moments, step 0) so that a captured step finds it in
    place. The global-norm clip the reference chains in front is
    ``clip_grad_norm``. On CUDA parameters Adam is ``capturable``."""
    params = list(params)
    if name == "adam":
        capturable = params[0].is_cuda
        opt = torch.optim.Adam(params, lr=learning_rate,
                               capturable=capturable, foreach=True)
        for p in params:
            opt.state[p] = {
                "step": torch.zeros((), device=p.device if capturable
                                    else "cpu"),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=0.9,
                              foreach=True)
        for p in params:  # optax's trace starts at 0: m1 = g, as torch's
            opt.state[p] = {"momentum_buffer": torch.zeros_like(p)}
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt


@torch.no_grad()
def clip_grad_norm(grads: list, max_norm: float = MAX_GRAD_NORM) -> Tensor:
    """optax's ``clip_by_global_norm``: every gradient scaled by
    min(1, max_norm/‖g‖), ‖g‖ the norm of all of them together (not
    ``torch.nn.utils.clip_grad_norm_``, whose max_norm/(‖g‖ + 1e-6)
    differs). No host sync. -> ‖g‖."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class LossAux(NamedTuple):
    value_loss: Tensor
    predictor_loss: Tensor


class MPRLTrainer:
    """Joint value and state-predictor training of ModelPredictiveRLPolicy.

    ``sp_update_stride``: the predictor loss counts in every
    ``sp_update_stride``-th minibatch of a sweep (``reduce_sp_update_
    frequency``: 5). ``freeze_state_predictor`` drops the predictor loss;
    ``detach_state_predictor`` lets its gradient reach only
    ``human_motion_predictor``.
    """

    rl_recomputes_td = True  # the RL target is fresh from the target net

    def __init__(self, policy, optimizer: str = "adam",
                 learning_rate: float = 0.001,
                 freeze_state_predictor: bool = False,
                 detach_state_predictor: bool = False,
                 sp_update_stride: int = 1):
        self.policy = policy.train()
        self.net = policy.networks
        self.target = copy.deepcopy(self.net).requires_grad_(False)
        self.freeze_sp = freeze_state_predictor
        self.detach_sp = detach_state_predictor
        self.sp_update_stride = sp_update_stride
        self.names, self.params = map(list, zip(
            *self.net.named_parameters()))
        for p in self.params:  # gradients live in place from the start
            p.grad = torch.zeros_like(p)
        dev = self.params[0].device
        self.aux_sum = torch.zeros(2, device=dev)  # losses over a sweep
        self._sp = {on: torch.tensor(float(on), device=dev)
                    for on in (False, True)}
        self.set_learning_rate(learning_rate, optimizer)

    def set_learning_rate(self, learning_rate: float,
                          optimizer: str = "adam") -> None:
        """A new optimizer with fresh state, as the reference re-inits its
        transform between IL and RL; a captured step is captured again."""
        self.optimizer_name, self.learning_rate = optimizer, learning_rate
        self.optimizer = make_optimizer(optimizer, learning_rate,
                                        self.params)
        self._graphs: dict = {}

    def state_tensors(self) -> list:
        """Every tensor a step writes: parameters, gradients, optimizer
        state, the loss sums."""
        opt = [t for s in self.optimizer.state.values() for t in s.values()]
        return [*self.params, *(p.grad for p in self.params), *opt,
                self.aux_sum]

    # ------------------------------------------------------------------ loss
    @torch.no_grad()
    def td_target(self, batch: rb.Transition) -> Tensor:
        """r + γ̄·(1 − terminal)·V_target(s') from the current target net
        (``trainer.py:82-94``)."""
        gamma_bar = torch.pow(self.policy.gamma,
                              self.policy.env_cfg.time_step
                              * batch.robot[..., T.VPREF])
        v_next = self.target.value(batch.next_robot, batch.next_humans)
        return batch.reward + gamma_bar * (1.0 - batch.terminal) * v_next

    def _nets(self, params: Optional[dict], *args, **kwargs):
        """The nets' forward with ``params`` (name -> tensor) standing in
        for their parameters; the live parameters when None."""
        return torch.func.functional_call(self.net, params or {}, args,
                                          kwargs)

    def denominator(self, w: Tensor) -> Tensor:
        """The losses' denominator: max(Σ valid, 1) over the batch (over
        the global batch on a mesh, ``sharding.py``)."""
        return torch.clamp(w.sum(), min=1.0)

    def loss_fn(self, batch: rb.Transition, update_sp, use_td: bool = False,
                params: Optional[dict] = None) -> tuple[Tensor, LossAux]:
        """The loss of the nets on ``batch`` (``trainer.py:96-129``), with
        ``params`` in place of their parameters when given."""
        w = batch.valid
        denom = self.denominator(w)
        target = self.td_target(batch) if use_td else batch.value
        if self.policy.cfg.mprl.linear_state_predictor or self.freeze_sp:
            v = self._nets(params, batch.robot, batch.humans)
            predictor_loss = torch.zeros((), device=v.device)
        else:
            # human motion does not depend on the action (the action only
            # moves the robot), so a zero action is passed
            zero_action = torch.zeros(batch.robot.shape[:-1] + (2,),
                                      device=w.device)
            v, (_, pred_h) = self._nets(params, batch.robot, batch.humans,
                                        zero_action,
                                        detach_graph=self.detach_sp)
            predictor_loss = (w[..., None, None]
                              * (pred_h - batch.next_humans) ** 2).sum() \
                / (denom * pred_h.shape[-1] * pred_h.shape[-2]) * update_sp
        value_loss = (w * (v - target) ** 2).sum() / denom
        return value_loss + predictor_loss, LossAux(value_loss,
                                                    predictor_loss)

    # ------------------------------------------------------------------ step
    def compute_grads(self, batch: rb.Transition, update_sp,
                      use_td: bool = False) -> LossAux:
        """The gradients of ``loss_fn`` into the parameters' ``grad``, in
        place (a parameter the loss does not reach gets zeros, as in the
        reference).

        The loss runs on fresh views of the parameters and
        ``torch.autograd.grad`` stops at them, so no parameter's gradient
        accumulator runs: one left alive from an earlier eager step keeps
        the stream it was made on, and the backward of a captured step
        would have to wait on that stream, which a capture forbids."""
        dev = self.params[0].device
        with profiling.device_phase("sgd.forward", dev):
            views = {n: p.view_as(p)
                     for n, p in zip(self.names, self.params)}
            loss, aux = self.loss_fn(batch, update_sp, use_td, views)
        with profiling.device_phase("sgd.backward", dev):
            grads = torch.autograd.grad(loss, list(views.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            with torch.no_grad():
                torch._foreach_copy_([p.grad for p in self.params], grads)
        return LossAux(aux.value_loss.detach(), aux.predictor_loss.detach())

    def apply_grads(self) -> None:
        """The clip and the optimizer step on the parameters' ``grad``."""
        clip_grad_norm([p.grad for p in self.params])
        self.optimizer.step()

    def train_step(self, batch: rb.Transition, update_sp,
                   use_td: bool = False) -> LossAux:
        """One optimisation step in place: gradients, the clip, the
        optimizer step; the losses add into ``aux_sum``."""
        aux = self.compute_grads(batch, update_sp, use_td)
        with profiling.device_phase("sgd.optimizer", self.params[0].device):
            self.apply_grads()
        with torch.no_grad():
            self.aux_sum += torch.stack(aux)
        return aux

    def _sgd_step(self, buffer: rb.ReplayBuffer, use_td: bool, idx: Tensor,
                  update_sp: Tensor) -> None:
        with profiling.device_phase("sgd.forward", idx.device):  # the gather
            batch = rb.sample(buffer, idx)
        self.train_step(batch, update_sp, use_td)

    def optimize(self, buffer: rb.ReplayBuffer, idx: Tensor,
                 use_td: bool = False, sp_always: bool = False,
                 graphed: Optional[bool] = None) -> LossAux:
        """One step on each minibatch ``idx[i]`` ([num_batches, batch]
        slot indices) -> the mean losses, 0-d tensors (no host sync).

        The predictor loss counts every ``sp_update_stride``-th step (every
        step with ``sp_always``, as imitation does). ``graphed``: None
        captures on the card and runs eagerly on the CPU; True on the CPU
        raises; False is the eager step.
        """
        on_card = idx.is_cuda
        if graphed is None:
            graphed = on_card
        if graphed and not on_card:
            raise ValueError("a graphed step needs CUDA tensors")
        if graphed:  # one graph per minibatch size and target kind
            key = (idx.shape[1], use_td)
            held, step = self._graphs.get(key, (None, None))
            if held is not buffer:
                step = Graphed(
                    lambda i, sp: self._sgd_step(buffer, use_td, i, sp),
                    idx[0], self._sp[True], state=self.state_tensors(),
                    name="trainer.sgd_step")
                self._graphs[key] = (buffer, step)
        else:
            def step(i, sp):
                self._sgd_step(buffer, use_td, i, sp)
        self.aux_sum.zero_()
        stride = 1 if sp_always else self.sp_update_stride
        with profiling.span("trainer.sweep"):
            for i in range(idx.shape[0]):
                step(idx[i], self._sp[i % stride == 0])
        mean = self.aux_sum / idx.shape[0]
        return LossAux(mean[0], mean[1])

    def optimize_batches(self, buffer: rb.ReplayBuffer,
                         generator: torch.Generator, num_batches: int,
                         batch_size: int, graphed: Optional[bool] = None
                         ) -> LossAux:
        """RL: ``num_batches`` minibatches drawn uniformly from the filled
        buffer (``trainer.py:140-160``), with fresh TD targets when the
        trainer recomputes them."""
        idx = rb.sample_indices(buffer, generator, (num_batches, batch_size))
        return self.optimize(buffer, idx, use_td=self.rl_recomputes_td,
                             graphed=graphed)

    @torch.no_grad()
    def update_target(self) -> None:
        """Hard target update, in place."""
        torch._foreach_copy_(list(self.target.parameters()), self.params)

    # ------------------------------------------------------------ state i/o
    def state_dict(self) -> dict:
        """A snapshot (copies) of the state a checkpoint holds."""
        def copies(module):
            return {k: v.clone() for k, v in module.state_dict().items()}

        return {"params": copies(self.net),
                "target_params": copies(self.target),
                "optimizer": self.optimizer_name,
                "learning_rate": self.learning_rate,
                "optimizer_state": [
                    {k: v.clone() for k, v in self.optimizer.state[p].items()}
                    for p in self.params]}

    @torch.no_grad()
    def load_state(self, state: dict, keep_optimizer: bool = False) -> None:
        """Load a ``state_dict`` into the live tensors in place: the
        parameters, the target, the optimizer's moments and step count.

        By default the optimizer is made anew if the state's kind or rate
        differ (a snapshot comes back whole). ``keep_optimizer`` keeps the
        trainer's kind and rate, as the reference restores a checkpoint
        into an optimizer made from its config (``train_loop.py:184-188``),
        and refuses a state of another kind, whose moments do not fit."""
        if keep_optimizer:
            if state["optimizer"] != self.optimizer_name:
                raise ValueError(
                    f"the checkpoint holds {state['optimizer']} state; the "
                    f"trainer's optimizer is {self.optimizer_name}")
        elif (state["optimizer"], state["learning_rate"]) != (
                self.optimizer_name, self.learning_rate):
            self.set_learning_rate(state["learning_rate"],
                                   state["optimizer"])
        self.net.load_state_dict(state["params"])
        self.target.load_state_dict(state["target_params"])
        for p, saved in zip(self.params, state["optimizer_state"]):
            for k, t in self.optimizer.state[p].items():
                t.copy_(saved[k])


class VNRLTrainer(MPRLTrainer):
    """Value-only trainer (``trainer.py:168-183``): fits the targets stored
    at collection time."""

    rl_recomputes_td = False

    def loss_fn(self, batch: rb.Transition, update_sp, use_td: bool = False,
                params: Optional[dict] = None) -> tuple[Tensor, LossAux]:
        w = batch.valid
        denom = self.denominator(w)
        v = self._nets(params, batch.robot, batch.humans)
        value_loss = (w * (v - batch.value) ** 2).sum() / denom
        return value_loss, LossAux(value_loss,
                                   torch.zeros((), device=v.device))
