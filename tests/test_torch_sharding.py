"""The port's data- and tensor-parallel train step and collection
(``parallel/sharding.py``) against the JAX package's one-device step and
against the port's own one-device step and collection, on the CPU (the
ranks as threads of a ``make_mesh(data, model, device="cpu")``).

- ``param_spec`` is the reference's rule on the same flax shapes, and the
  ``nn.Linear`` weights it shards in the port are exactly the flax kernels
  the reference shards (every 2-D parameter of the MP-RGL nets is one; the
  port shards the LSTM's gate layers by the same rule).
- One Adam step at (data, model) = (4, 2), (2, 1) and (1, 2) equals the
  JAX ``MPRLTrainer.train_step`` on one device (the setup of the JAX
  package's ``tests/test_parallel.py::test_sharded_train_step``) and the
  port's one-device step: value loss rel 1e-4, parameters atol 1e-4, the
  limits of that test. Batches: 32 rows whose shards hold different
  numbers of valid rows (the loss divides by the global count), and 30
  rows, which do not divide by 4 (``torch.tensor_split``).
- A batch whose gradient norm passes 10: the clip binds over the sharded
  tree as on one device.
- After a step every rank of an axis holds the same bits.
- The collection split over data equals the one-device collection, every
  field bit for bit, at ε = 0.5 with the global draws.
- ``LoopOptions.mesh``'s divisibility error is the reference's (the
  train CLI on a mesh and as processes: ``test_torch_sharding_cli.py``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu.configs.base import (
    EnvConfig as JEnvConfig, MPRLConfig as JMPRLConfig,
    PolicyConfig as JPolicyConfig)
from relationalgraphlearning_tpu.parallel.mesh import make_mesh as jmesh
from relationalgraphlearning_tpu.parallel.sharding import (
    param_spec as jparam_spec)
from relationalgraphlearning_tpu.policies import make_policy as jmake
from relationalgraphlearning_tpu.training import trainer as jtr
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, MPRLConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.parallel import sharding
from relationalgraphlearning_tpu_torch.parallel.mesh import make_mesh
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training import trainer as ttr

from test_torch_trainer import _batch, _jax_batch, _np_tree, _torch_batch

LOSS_REL, PARAM_ATOL = 1e-4, 1e-4   # tests/test_parallel.py:142-147
MESHES = [(4, 2), (2, 1), (1, 2)]


def _step_setup(lr=1e-3, optimizer="adam"):
    """The JAX package's test_sharded_train_step setup: linear humans,
    planning depth 1, no action clip; the port's policy on its weights."""
    jenv = JEnvConfig(human_policy="linear")
    jpcfg = JPolicyConfig(mprl=JMPRLConfig(planning_depth=1,
                                           do_action_clip=False))
    pol_j = jmake("model_predictive_rl", jpcfg, jenv)
    params = pol_j.init_params(jax.random.PRNGKey(0))
    jtrainer = jtr.MPRLTrainer(pol_j, optimizer=optimizer, learning_rate=lr)
    env = EnvConfig(human_policy="linear")
    pcfg = PolicyConfig(mprl=MPRLConfig(planning_depth=1,
                                        do_action_clip=False))

    def port_trainer():
        pol = ModelPredictiveRLPolicy(pcfg, env, device="cpu")
        pol.load_flax(_np_tree(params))
        trainer = ttr.MPRLTrainer(pol, optimizer=optimizer,
                                  learning_rate=lr)
        trainer.update_target()
        return trainer

    return pol_j, jtrainer, params, port_trainer


def _flax_params(trainer):
    return {k: v.detach() for k, v in trainer.net.named_parameters()}


def _close(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("model", [1, 2, 4, 3])
def test_param_spec_is_the_reference_rule(model):
    mesh = jmesh(data=8 // model if 8 % model == 0 else 2, model=model)
    for shape in [(9, 32), (32, 150), (150, 100), (100, 1), (7, 33),
                  (64,), (), (4, 4, 4), (13, 64)]:
        want = jparam_spec(jnp.zeros(shape), mesh)
        got = sharding.param_spec(shape, model)
        assert tuple(want) == got, (shape, model, want, got)


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_linears_are_the_kernels_the_reference_shards(model):
    """Each flax leaf marked by the reference's spec (ones where sharded,
    zeros where replicated), converted to the port's names: the marked
    tensors are the ``nn.Linear`` weights the port shards."""
    _, _, params, port_trainer = _step_setup()
    mesh = jmesh(data=8 // model, model=model)
    marks = jax.tree.map(
        lambda x: np.full(x.shape, float(tuple(jparam_spec(x, mesh))
                                         == (None, "model")), np.float32),
        params)
    converted = mprl_networks_from_flax(marks)
    want = {k for k, v in converted.items() if bool((v == 1.0).all())}
    got = sharding._sharded_names(port_trainer().net, model)
    assert got == want and got


# ------------------------------------------------------------- the step
def _gathered_grads(par):
    """The step's gradients (summed over data, clipped), whole."""
    names = sharding._sharded_names(par.base.net, par.model)
    return {n: torch.cat([par.ranks[m].params[i].grad
                          for m in range(par.model)])
            if n in names else par.ranks[0].params[i].grad
            for i, n in enumerate(par.ranks[0].names)}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("data, model", MESHES)
@pytest.mark.parametrize("rows", [32, 30])
def test_sharded_step_equals_one_device(data, model, rows, optimizer):
    """SGD end to end: the step's losses and parameters against the JAX
    one-device step and the port's. Adam: the losses, the summed
    gradients against JAX's (rtol 1e-5, atol 1e-6, the trainer test's),
    and the update against the port's one-device Adam on those gradients
    (its first step divides each gradient by its own magnitude plus 1e-8,
    which turns a float32 rounding of a gradient near 1e-8 into a step
    difference of up to the learning rate; ``test_torch_trainer.py`` holds
    Adam to JAX the same way)."""
    lr = 0.01 if optimizer == "sgd" else 1e-3
    pol_j, jtrainer, params, port_trainer = _step_setup(lr, optimizer)
    b = _batch(11, k=rows)
    parts = np.array_split(b["valid"], data)
    if data > 1:                  # the shards' valid counts differ
        assert len({float(p.sum()) for p in parts}) > 1
    state = jtrainer.init(params)
    state_ref, aux_ref = jtrainer.train_step(state, _jax_batch(b),
                                             jnp.asarray(1.0))

    one = port_trainer()
    aux_one = one.train_step(_torch_batch(b), torch.tensor(1.0))
    par = sharding.make_parallel_train_step(
        port_trainer(), make_mesh(data, model, device="cpu"))
    aux = par(_torch_batch(b), 1.0)

    for got in (aux.value_loss, aux_one.value_loss):
        assert float(got) == pytest.approx(float(aux_ref.value_loss),
                                           rel=LOSS_REL)
    assert float(aux.predictor_loss) == pytest.approx(
        float(aux_ref.predictor_loss), rel=LOSS_REL)
    if optimizer == "sgd":
        want = mprl_networks_from_flax(_np_tree(state_ref.params))
        _close(_flax_params(par), want, f"({data}, {model}) vs JAX")
        _close(_flax_params(par), _flax_params(one),
               f"({data}, {model}) vs the port's one-device step")
    else:
        grads_j, _ = jax.grad(jtrainer.loss_fn, has_aux=True)(
            params, _jax_batch(b), jnp.asarray(1.0))
        grads = _gathered_grads(par)
        for k, w in mprl_networks_from_flax(_np_tree(grads_j)).items():
            np.testing.assert_allclose(grads[k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        ref = port_trainer()
        with torch.no_grad():
            for n, p in zip(ref.names, ref.params):
                p.grad.copy_(grads[n])
        ref.apply_grads()
        _close(_flax_params(par), _flax_params(ref),
               f"({data}, {model}) Adam vs one device on its gradients")
    _ranks_agree(par)


def _ranks_agree(par):
    """Every rank of an axis holds the same bits: a replicated leaf on all
    ranks, a sharded one on the data ranks of its model index; the shards
    of data rank 0 are the trainer's whole parameters."""
    names = sharding._sharded_names(par.base.net, par.model)
    ranks = par.ranks
    for i, n in enumerate(ranks[0].names):
        for r, rt in enumerate(ranks):
            ref = ranks[r % par.model]
            assert torch.equal(rt.params[i], ref.params[i]), (n, r)
            if n not in names:
                assert torch.equal(rt.params[i], ranks[0].params[i]), (n, r)
            for k, t in rt.optimizer.state[rt.params[i]].items():
                assert torch.equal(
                    t, ref.optimizer.state[ref.params[i]][k]), (n, r, k)
        whole = torch.cat([ranks[m].params[i] for m in range(par.model)]) \
            if n in names else ranks[0].params[i]
        assert torch.equal(whole, par.base.params[i]), n


def test_clip_binds_over_the_sharded_tree():
    """Values 60× the net's scale: the global norm passes 10 and the clip
    scales the step, on one device as on (4, 2); SGD, so the step is the
    clipped gradient itself."""
    pol_j, jtrainer, params, port_trainer = _step_setup(0.01, "sgd")
    b = _batch(12, value_scale=60.0)
    grads, _ = jax.grad(jtrainer.loss_fn, has_aux=True)(
        params, _jax_batch(b), jnp.asarray(1.0))
    assert float(optax.global_norm(grads)) > 10.0
    state_ref, _ = jtrainer.train_step(jtrainer.init(params), _jax_batch(b),
                                       jnp.asarray(1.0))
    par = sharding.make_parallel_train_step(
        port_trainer(), make_mesh(4, 2, device="cpu"))
    par(_torch_batch(b), 1.0)
    _close(_flax_params(par), mprl_networks_from_flax(
        _np_tree(state_ref.params)), "clipped step vs JAX")
    _ranks_agree(par)


def test_optimize_sweeps_and_gathers_like_one_device():
    """``optimize`` over a buffer (each data rank gathering its slice of
    every minibatch), three SGD steps with the predictor every other one,
    against the one-device trainer; ``state_dict`` gathers the shards and
    ``load_state`` scatters them back."""
    from relationalgraphlearning_tpu_torch.training import (
        replay_buffer as rb)
    _, _, _, port_trainer = _step_setup(0.01, "sgd")
    data = _batch(13, k=96)
    buf = rb.push(rb.create(96, 5, device="cpu"), _torch_batch(data))
    idx = torch.arange(96).reshape(3, 32).flip(-1)
    one = port_trainer()
    one.sp_update_stride = 2
    par_base = port_trainer()
    par_base.sp_update_stride = 2
    par = sharding.ParallelTrainer(par_base, make_mesh(2, 2, device="cpu"))
    want = one.optimize(buf, idx, use_td=True)
    got = par.optimize(buf, idx, use_td=True)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=LOSS_REL)
    _close(_flax_params(par), _flax_params(one), "optimize")
    _ranks_agree(par)
    saved = par.state_dict()
    par.ranks[3].params[0].data.add_(1.0)
    par.load_state(saved)
    _ranks_agree(par)
    with pytest.raises(ValueError, match="CUDA"):
        par.optimize(buf, idx, graphed=True)


# ------------------------------------------------------------ collection
@pytest.mark.parametrize("data", [2, 4])
def test_split_collection_equals_one_device(data):
    from test_torch_explorer_collect import _explorers
    cfg, _, _, tex = _explorers("mprl")
    offset = cfg.env.sim.train_seed_offset
    B, K = 4, 12
    gen = torch.Generator().manual_seed(3)
    draws = tex.draws(gen, K, B)
    carry = tex.init_carry(B, offset)
    want_carry, want = tex.collect(carry, K, offset, 0.5, draws,
                                   graphed=False)
    collect = sharding.make_parallel_collect(
        tex, make_mesh(data, device="cpu"), K, offset)
    got_carry, got = collect(carry, 0.5, draws)
    assert bool(want.terminal.any())     # envs reset to their next case
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g, w), name
    for name, g, w in zip(want_carry._fields, got_carry, want_carry):
        assert torch.equal(g, w), name
    with pytest.raises(ValueError, match="not divisible by data axis"):
        collect(tex.init_carry(3 * data + 1, offset))


# ------------------------------------------------------------- the loop
def test_loop_mesh_refuses_a_batch_the_data_axis_does_not_divide(tmp_path):
    from relationalgraphlearning_tpu_torch.configs.base import Config
    from relationalgraphlearning_tpu_torch.training.train_loop import (
        LoopOptions, train)
    with pytest.raises(ValueError, match=r"train_envs=6 not divisible by "
                       r"data axis 4"):
        train(Config(), "model_predictive_rl", str(tmp_path / "out"),
              opts=LoopOptions(train_envs=6,
                               mesh=make_mesh(4, device="cpu")),
              device="cpu")
