"""Port parity: exit labels, the pre-exit predictor (prediction and fit) and
AdamW against the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exits as JEX
from repro.core import preexit as JPE
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.core import exits as TEX
from repro_torch.core import preexit as TPE
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamW as TAdamW

D_IN, HIDDEN, N_EXITS = 24, 16, 4


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol)
        else:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), atol=atol)


def test_optimal_exit_labels_equal():
    rng = np.random.default_rng(0)
    fine = _unit(rng.standard_normal((40, 16)).astype(np.float32))
    noise = rng.standard_normal((N_EXITS, 40, 16)).astype(np.float32)
    scale = np.linspace(2.0, 0.0, N_EXITS, dtype=np.float32)[:, None, None]
    embs = _unit(fine[None] + scale * noise).astype(np.float32)
    want = np.asarray(JEX.optimal_exit_labels(jnp.asarray(embs),
                                              jnp.asarray(fine)))
    got = TEX.optimal_exit_labels(torch.from_numpy(embs),
                                  torch.from_numpy(fine))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1  # the case exercises several exits
    np.testing.assert_array_equal(
        TEX.exit_histogram(got, N_EXITS).numpy(),
        np.asarray(JEX.exit_histogram(jnp.asarray(want), N_EXITS)))
    exits = (1, 2, 3, 4)
    np.testing.assert_allclose(
        float(TEX.mean_exit_depth(got, exits)),
        float(JEX.mean_exit_depth(jnp.asarray(want), exits)), rtol=1e-6)


@pytest.fixture(scope="module")
def fit_case():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((96, D_IN)).astype(np.float32)
    labels = (np.abs(feats[:, :N_EXITS]).argmax(1)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    init = JPE.predictor_init(key, D_IN, HIDDEN, N_EXITS)
    return key, feats, labels, init


def test_predict_exit_equal(fit_case):
    _, feats, _, init = fit_case
    want = np.asarray(JPE.predict_exit(init, jnp.asarray(feats)))
    got = TPE.predict_exit(params_from_jax(_to_np(init)),
                           torch.from_numpy(feats))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        TPE.predictor_logits(params_from_jax(_to_np(init)),
                             torch.from_numpy(feats)).detach().numpy(),
        np.asarray(JPE.predictor_logits(init, jnp.asarray(feats))),
        atol=1e-5)


def test_train_predictor_from_same_init(fit_case):
    key, feats, labels, init = fit_case
    # the reference draws its init from ``key`` inside train_predictor
    want_p, want_s = JPE.train_predictor(key, jnp.asarray(feats),
                                         jnp.asarray(labels),
                                         hidden=HIDDEN, n_exits=N_EXITS,
                                         steps=25, batch=32)
    got_p, got_s = TPE.train_predictor(None, torch.from_numpy(feats),
                                       torch.from_numpy(labels),
                                       hidden=HIDDEN, n_exits=N_EXITS,
                                       steps=25, batch=32,
                                       params=params_from_jax(_to_np(init)))
    _assert_tree_close(got_p, want_p, atol=1e-4)
    np.testing.assert_array_equal(
        TPE.predict_exit(got_p, torch.from_numpy(feats)).numpy(),
        np.asarray(JPE.predict_exit(want_p, jnp.asarray(feats))))
    assert got_s["n_params"] == want_s["n_params"]
    assert abs(got_s["loss"] - want_s["loss"]) < 1e-4


def test_adamw_step_matches():
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = {"a": 3 * rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jopt = JAdamW(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    topt = TAdamW(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_jax(params)
    tstate = topt.init(tp)
    for _ in range(2):  # second step: bias correction and moments carry
        jp, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, grads),
                                     jstate, jp)
        tp, tstate, tm = topt.update(params_from_jax(grads), tstate, tp)
    _assert_tree_close(tp, jp, atol=1e-6)
    _assert_tree_close(tstate.m, jstate.m, atol=1e-6)
    _assert_tree_close(tstate.v, jstate.v, atol=1e-6)
    assert tstate.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
