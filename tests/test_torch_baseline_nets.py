"""The port's CADRL, SARL and LSTM-RL value nets against the JAX package's
``models/baseline_nets.py``, loaded from the same flax params (fresh ones
from ``init`` and the committed checkpoints' exported weights) and fed the
same seeded rotated rows: rtol 1e-5 / atol 1e-6, SARL's attention weights
included; CADRL at N = 1 and 5; LSTM-RL with tied distances, where the
farthest-first order must break ties as ``jnp.flip(jnp.argsort(da))`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.models import baseline_nets as jbn
from relationalgraphlearning_tpu_torch import checkpoints, convert
from relationalgraphlearning_tpu_torch.models import baseline_nets as tbn

TOL = dict(rtol=1e-5, atol=1e-6)


def _rows(seed=0, B=64, n=5, width=13):
    rng = np.random.default_rng(seed)
    rows = rng.normal(0, 1.5, (B, n, width)).astype(np.float32)
    rows[..., :6] = rows[..., :1, :6]  # the robot's values on every row
    rows[..., 11] = np.abs(rows[..., 11])  # da >= 0
    return rows


def _flax(module, rows, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed),
                                                jnp.asarray(rows)))


@pytest.mark.parametrize("n", [1, 5])
def test_cadrl_matches_jax(n):
    rows = _rows(n=n)
    jnet = jbn.CADRLNet()
    tree = _flax(jnet, rows)
    net = tbn.CADRLNet(13)
    net.load_state_dict(convert.cadrl_from_flax(tree))
    want = np.asarray(jnet.apply(tree, jnp.asarray(rows)))
    got = net(torch.from_numpy(rows)).detach().numpy()
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("width,global_state", [(13, True), (61, True),
                                                (13, False)])
def test_sarl_matches_jax(width, global_state):
    rows = _rows(1, width=width)
    jnet = jbn.SARLNet(with_global_state=global_state)
    tree = _flax(jnet, rows, 1)
    net = tbn.SARLNet(width, with_global_state=global_state)
    net.load_state_dict(convert.sarl_from_flax(tree))
    v_j, w_j = jnet.apply(tree, jnp.asarray(rows))
    v, w = net(torch.from_numpy(rows))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_j), **TOL)
    np.testing.assert_allclose(w.sum(-1).detach().numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("interaction", [False, True])
def test_lstm_rl_matches_jax(ties, interaction):
    rows = _rows(2)
    if ties:  # equal distances, and runs of them, in most states
        rows[:48, :, 11] = np.round(rows[:48, :, 11])
        rows[:16, :, 11] = 1.0
    jnet = jbn.LstmRLNet(with_interaction_module=interaction)
    tree = _flax(jnet, rows, 2)
    net = tbn.LstmRLNet(7, with_interaction_module=interaction)
    net.load_state_dict(convert.lstm_rl_from_flax(tree))
    want = np.asarray(jnet.apply(tree, jnp.asarray(rows)))
    got = net(torch.from_numpy(rows)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lstm_rl_order_breaks_ties_as_jax():
    """Tied distances, each human's row otherwise distinct: only the JAX
    order of the tie gives the JAX value."""
    rows = _rows(3, B=8)
    rows[..., 11] = 2.0
    jnet = jbn.LstmRLNet()
    tree = _flax(jnet, rows, 3)
    net = tbn.LstmRLNet(7)
    net.load_state_dict(convert.lstm_rl_from_flax(tree))
    want = np.asarray(jnet.apply(tree, jnp.asarray(rows)))
    got = net(torch.from_numpy(rows)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    flipped = net(torch.from_numpy(rows[:, ::-1].copy())).detach().numpy()
    assert np.abs(flipped - want).max() > 1e-4  # the order matters


@pytest.mark.parametrize("model,cls,make,width", [
    ("cadrl", jbn.CADRLNet, lambda: tbn.CADRLNet(13), 13),
    ("sarl", jbn.SARLNet, lambda: tbn.SARLNet(13), 13),
    ("sarl_om", jbn.SARLNet, lambda: tbn.SARLNet(61), 61),
    ("lstm_rl", jbn.LstmRLNet, lambda: tbn.LstmRLNet(7), 13)])
def test_committed_weights_match_jax(model, cls, make, width):
    tree = checkpoints.load_flax_tree(model)
    rows = _rows(4, width=width)
    out = cls().apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(rows))
    want = np.asarray(out[0] if isinstance(out, tuple) else out)
    net = make()
    net.load_state_dict(getattr(convert, {
        "cadrl": "cadrl_from_flax", "sarl": "sarl_from_flax",
        "sarl_om": "sarl_from_flax", "lstm_rl": "lstm_rl_from_flax"}[model])(
            tree))
    out = net(torch.from_numpy(rows))
    got = (out[0] if isinstance(out, tuple) else out).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
