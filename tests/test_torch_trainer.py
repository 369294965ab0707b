"""The port's trainers against the JAX package's on the same weights and
minibatch: the losses, the gradients (the flax tree converted with the
weights' mapping), and one optimizer step of each kind (SGD with momentum
0.9, the imitation optimizer, and Adam, the RL one, each behind the global
norm clip at 10) with the optimizer's moments after it. The SGD step is
held end to end (the port's gradients); Adam's step is held from the same
(the reference's) gradients, since its first step divides each gradient
by its own magnitude plus 1e-8 and so turns a float32 rounding of a
gradient near 1e-8 into a step difference of up to the learning rate.

Weights come from the JAX package's ``init_params`` (``mp_separate``'s
nets, or a variant), converted with ``convert.mprl_networks_from_flax``;
the minibatch is made with numpy from a seed. Cases: imitation (the stored
Monte-Carlo value), RL (a TD target from a target net with other weights),
a batch whose gradient norm passes 10 (the clip), ``detach_state_predictor``
on a shared graph model, ``freeze_state_predictor``, ``sp_update_stride=5``
(six steps, the predictor loss in the first and the sixth) and ``VNRLTrainer``,
on MP-RGL's nets and on each one-step baseline's committed weights.
float32 at rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs
from relationalgraphlearning_tpu.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy as JPolicy)
from relationalgraphlearning_tpu.training import replay_buffer as jrb
from relationalgraphlearning_tpu.training import trainer as jtr
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training import trainer as ttr

TOL = dict(rtol=1e-5, atol=1e-6)
N, BATCH = 5, 48

CASES = {
    # name: (mprl overrides, trainer kwargs, use_td, value scale, vnrl)
    "il_mc": ({}, {}, False, 1.0, False),
    "rl_td": ({}, {}, True, 1.0, False),
    "clip": ({}, {}, False, 60.0, False),
    "detach_sp": (dict(share_graph_model=True),
                  dict(detach_state_predictor=True), False, 1.0, False),
    "freeze_sp": ({}, dict(freeze_state_predictor=True), True, 1.0, False),
    "vnrl": ({}, {}, False, 1.0, True),
}


def _batch(seed, k=BATCH, value_scale=1.0, n=N):
    """A minibatch of ``n`` humans as numpy: robots and humans scattered
    over the arena, targets, rewards, validity (some 0) and terminals (some
    1)."""
    rng = np.random.default_rng(seed)
    robot = np.zeros((k, 9), np.float32)
    robot[:, :2] = rng.uniform(-4, 4, (k, 2))
    robot[:, 2:4] = rng.uniform(-1, 1, (k, 2))
    robot[:, 4] = 0.3
    robot[:, 5:7] = rng.uniform(-4, 4, (k, 2))
    robot[:, 7] = 1.0
    robot[:, 8] = rng.uniform(-np.pi, np.pi, k)

    def humans():
        return np.concatenate([rng.uniform(-4, 4, (k, n, 2)),
                               rng.uniform(-1, 1, (k, n, 2)),
                               np.full((k, n, 1), 0.3)], -1)

    next_robot = robot.copy()
    next_robot[:, :2] += rng.uniform(-0.25, 0.25, (k, 2))
    data = dict(robot=robot, humans=humans(),
                value=rng.uniform(-1, 1, k) * value_scale,
                reward=rng.uniform(-0.25, 1, k), next_robot=next_robot,
                next_humans=humans(), valid=(rng.random(k) < 0.8),
                terminal=(rng.random(k) < 0.2))
    return {n: np.asarray(a, np.float32) for n, a in data.items()}


def _jax_batch(b):
    return jrb.Transition(**{n: jnp.asarray(a) for n, a in b.items()})


def _torch_batch(b):
    return rb.Transition(**{n: torch.from_numpy(a.copy())
                            for n, a in b.items()})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_to_tree(got: dict, tree, what):
    want = mprl_networks_from_flax(_np_tree(tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].numpy(), **TOL,
                                   err_msg=f"{what}: {k}")


def _setup(case):
    mprl, kwargs, use_td, scale, vnrl = CASES[case]
    cfg_j, cfg_t = configs("mprl_td", mprl=mprl)
    cfg_j = dataclasses.replace(cfg_j, policy=dataclasses.replace(
        cfg_j.policy, mprl=dataclasses.replace(
            cfg_j.policy.mprl, share_graph_model=mprl.get(
                "share_graph_model", False))))
    pol_j = JPolicy(cfg_j.policy, cfg_j.env)
    params = pol_j.init_params(jax.random.PRNGKey(0))
    target = pol_j.init_params(jax.random.PRNGKey(1)) if use_td else params
    jcls, tcls = ((jtr.VNRLTrainer, ttr.VNRLTrainer) if vnrl
                  else (jtr.MPRLTrainer, ttr.MPRLTrainer))
    pol_t = ModelPredictiveRLPolicy(cfg_t.policy, cfg_t.env, device="cpu")
    pol_t.load_flax(_np_tree(params))
    trainer = tcls(pol_t, **kwargs)
    trainer.target.load_state_dict(mprl_networks_from_flax(
        _np_tree(target)))
    b = _batch(1, value_scale=scale)
    return (pol_j, jcls(pol_j, **kwargs), params, target, trainer, b,
            use_td)


def _grads(trainer):
    return {n: p.grad for n, p in zip(trainer.names, trainer.params)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_grads_and_one_step_of_each_optimizer_match_jax(case):
    pol_j, jtrainer, params, target, trainer, b, use_td = _setup(case)
    jb, tb = _jax_batch(b), _torch_batch(b)
    sp = 1.0

    grads_j, aux_j = jax.grad(jtrainer.loss_fn, has_aux=True)(
        params, jb, jnp.asarray(sp), target_params=target, use_td=use_td)
    aux = trainer.compute_grads(tb, torch.tensor(sp), use_td)
    for got, want in zip(aux, aux_j):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_to_tree(_grads(trainer), grads_j, f"{case}: gradients")
    norm = float(optax.global_norm(grads_j))
    if case == "clip":
        assert norm > 10, norm  # the clip scales this step's gradients
    else:
        assert norm < 10, norm

    start = trainer.state_dict()
    for name, lr in (("sgd", 0.01), ("adam", 1e-3)):
        jtrainer.set_learning_rate(lr, name)
        state = jtr.TrainState(params, target, jtrainer.tx.init(params))
        state, _ = jtrainer.train_step(state, jb, jnp.asarray(sp),
                                       use_td=use_td)
        trainer.load_state(start)
        trainer.set_learning_rate(lr, name)
        if name == "sgd":
            trainer.train_step(tb, torch.tensor(sp), use_td)
        else:
            want = mprl_networks_from_flax(_np_tree(grads_j))
            with torch.no_grad():
                for n, p in zip(trainer.names, trainer.params):
                    p.grad.copy_(want[n])
            trainer.apply_grads()
        _close_to_tree(dict(trainer.net.named_parameters()), state.params,
                       f"{case}: params after one {name} step")
        inner = state.opt_state[1]  # (clip state, optimizer state)
        moments = ({"momentum_buffer": inner[0].trace} if name == "sgd"
                   else {"exp_avg": inner[0].mu, "exp_avg_sq": inner[0].nu})
        for key, tree in moments.items():
            got = {n: trainer.optimizer.state[p][key]
                   for n, p in zip(trainer.names, trainer.params)}
            _close_to_tree(got, tree, f"{case}: {name} {key}")
        if name == "adam":
            assert all(float(trainer.optimizer.state[p]["step"]) == 1
                       for p in trainer.params)


def test_sp_update_stride_counts_the_predictor_every_fifth_step():
    """Six RL steps (TD targets), the predictor loss in the first and the
    sixth only: the reference's ``optimize_batches`` body on the same six
    minibatches against ``MPRLTrainer.optimize`` (SGD, so that six steps
    stay well conditioned; Adam's step is held above)."""
    cfg_j, cfg_t = configs("mprl_td")
    pol_j = JPolicy(cfg_j.policy, cfg_j.env)
    params = pol_j.init_params(jax.random.PRNGKey(0))
    jtrainer = jtr.MPRLTrainer(pol_j, optimizer="sgd", learning_rate=0.01,
                               sp_update_stride=5)
    pol_t = ModelPredictiveRLPolicy(cfg_t.policy, cfg_t.env, device="cpu")
    trainer = ttr.MPRLTrainer(pol_t.load_flax(_np_tree(params)),
                              optimizer="sgd", learning_rate=0.01,
                              sp_update_stride=5)
    trainer.update_target()
    data = _batch(2, k=6 * BATCH)
    buf = rb.push(rb.create(6 * BATCH, N, device="cpu"), _torch_batch(data))
    idx = torch.arange(6 * BATCH).reshape(6, BATCH).flip(-1)

    state = jtrainer.init(params)
    losses = []
    for i in range(6):
        rows = {n: a[idx[i].numpy()] for n, a in data.items()}
        state, aux = jtrainer.train_step(
            state, _jax_batch(rows), jnp.asarray(float(i % 5 == 0)),
            use_td=True)
        losses.append(aux)
    mean = trainer.optimize(buf, idx, use_td=True)
    for got, want in zip(mean, zip(*losses)):
        np.testing.assert_allclose(float(got), float(np.mean(want)), **TOL)
    assert float(losses[1].predictor_loss) == 0.0
    assert float(losses[5].predictor_loss) > 0.0
    _close_to_tree(dict(trainer.net.named_parameters()), state.params,
                   "params after six steps")


def test_update_target_copies_in_place_and_td_target_reads_it():
    cfg_j, cfg_t = configs("mprl_td")
    pol_t = ModelPredictiveRLPolicy(cfg_t.policy, cfg_t.env, device="cpu")
    pol_t.init_params(torch.Generator().manual_seed(0))
    trainer = ttr.MPRLTrainer(pol_t)
    target_tensors = [t for t in trainer.target.parameters()]
    pol_t.init_params(torch.Generator().manual_seed(1))
    b = _torch_batch(_batch(3))
    before = trainer.td_target(b)
    trainer.update_target()
    assert [t for t in trainer.target.parameters()] == target_tensors
    for t, p in zip(trainer.target.parameters(), trainer.params):
        assert torch.equal(t, p) and t.data_ptr() != p.data_ptr()
    after = trainer.td_target(b)
    assert not torch.equal(before, after)
    gamma_bar = 0.9 ** (0.25 * b.robot[:, 7])
    with torch.no_grad():
        v_next = pol_t.value(b.next_robot, b.next_humans)
    want = b.reward + gamma_bar * (1 - b.terminal) * v_next
    torch.testing.assert_close(after, want, rtol=1e-6, atol=1e-7)


def test_clip_is_optax_not_torch_clip_grad_norm():
    grads = [torch.full((3,), 4.0), torch.full((2, 2), 3.0)]
    norm = float(ttr.clip_grad_norm(grads, 10.0))
    assert norm == pytest.approx(np.sqrt(3 * 16 + 4 * 9))
    got = torch.cat([g.reshape(-1) for g in grads])
    want = optax.clip_by_global_norm(10.0).update(
        [jnp.full((3,), 4.0), jnp.full((2, 2), 3.0)], None)[0]
    want = np.concatenate([np.asarray(w).reshape(-1) for w in want])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    small = [torch.full((4,), 0.5)]
    ttr.clip_grad_norm(small, 10.0)
    assert torch.equal(small[0], torch.full((4,), 0.5))


# the one-step baselines: model -> (policy, the weights' converter)
BASELINES = {
    "sarl": ("sarl", "sarl_from_flax"),
    "sarl_om": ("sarl", "sarl_from_flax"),
    "lstm_rl": ("lstm_rl", "lstm_rl_from_flax"),
    "cadrl": ("cadrl", "cadrl_from_flax"),
    "rgl": ("rgl", "value_estimator_from_flax"),
}


@pytest.mark.parametrize("model", BASELINES)
def test_vnrl_on_sarl_matches_jax(model):
    """``VNRLTrainer`` on each one-step baseline (the committed weights of
    ``results/<model>``, at its own config: CADRL with one human): the
    loss, the gradients through the rotation and the value net (SARL's
    attention and occupancy maps, the LSTM over the humans, CADRL's MLP,
    RGL's relation graph), one SGD step and one Adam step (from the
    reference's gradients, as above) and the moments after them, against
    the JAX package's ``VNRLTrainer``."""
    from relationalgraphlearning_tpu.policies.factory import (
        make_policy as jmake)
    from relationalgraphlearning_tpu_torch import checkpoints
    from relationalgraphlearning_tpu_torch import convert
    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)

    policy, converter = BASELINES[model]
    from_flax = getattr(convert, converter)
    cfg_j, cfg_t = configs(model)
    tree = checkpoints.load_flax_tree(model)
    params = jax.tree.map(jnp.asarray, tree)
    pol_j = jmake(policy, cfg_j.policy, cfg_j.env)
    jtrainer = jtr.VNRLTrainer(pol_j)
    pol_t = make_policy(policy, cfg_t.policy, cfg_t.env,
                        device="cpu").load_flax(tree)
    trainer = ttr.VNRLTrainer(pol_t)
    b = _batch(2, n=cfg_t.env.sim.human_num)
    jb, tb = _jax_batch(b), _torch_batch(b)

    def close(got: dict, flax_tree, what):
        want = {f"model.{k}": v
                for k, v in from_flax(_np_tree(flax_tree)).items()}
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), **TOL,
                                       err_msg=f"{what}: {k}")

    grads_j, aux_j = jax.grad(jtrainer.loss_fn, has_aux=True)(
        params, jb, jnp.asarray(1.0))
    aux = trainer.compute_grads(tb, torch.tensor(1.0))
    np.testing.assert_allclose(float(aux.value_loss),
                               float(aux_j.value_loss), **TOL)
    assert float(aux.predictor_loss) == 0.0
    close(_grads(trainer), grads_j, "gradients")
    start = trainer.state_dict()
    for name, lr in (("sgd", 0.01), ("adam", 1e-3)):
        jtrainer.set_learning_rate(lr, name)
        state = jtr.TrainState(params, params, jtrainer.tx.init(params))
        state, _ = jtrainer.train_step(state, jb, jnp.asarray(1.0))
        trainer.load_state(start)
        trainer.set_learning_rate(lr, name)
        if name == "sgd":
            trainer.train_step(tb, torch.tensor(1.0))
        else:
            want = {f"model.{k}": v for k, v in
                    from_flax(_np_tree(grads_j)).items()}
            with torch.no_grad():
                for n, p in zip(trainer.names, trainer.params):
                    p.grad.copy_(want[n])
            trainer.apply_grads()
        close(dict(trainer.net.named_parameters()), state.params,
              f"params after one {name} step")
        inner = state.opt_state[1]
        moments = ({"momentum_buffer": inner[0].trace} if name == "sgd"
                   else {"exp_avg": inner[0].mu, "exp_avg_sq": inner[0].nu})
        for key, t in moments.items():
            close({n: trainer.optimizer.state[p][key]
                   for n, p in zip(trainer.names, trainer.params)}, t,
                  f"{name} {key}")
