"""Port parity: P-LoRA healing (``repro_torch.core.healing``) and the
optimizer pieces it needs (AdamW's ``grad_mask``, ``accumulate_grads``)
against the reference, on tests/test_serving.py's small MEM config and the
LM smoke variants, fp32. Both packages start from the reference's LoRA
init (the port's ``plora.lora_init`` is patched to return it, since the two
frameworks draw different numbers from one seed) and draw the same batches
(``np.random.default_rng(0)``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro.core import healing as JH
from repro.core import plora as JP
from repro.data.synthetic import multimodal_pairs
from repro.models import imagebind as JIB
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import accumulate_grads as j_accumulate_grads
from repro_torch.configs import base as TC
from repro_torch.core import healing as TH
from repro_torch.core import plora as TP
from repro_torch.kernels.grad_guard import NO_REFERENCE_GRAD, refuse_grad
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import accumulate_grads as t_accumulate_grads

# the tests/test_serving.py config (fp32)
CFG = MEMConfig(towers=(TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                        TowerConfig("text", 3, 32, 2, 64, 8, 0, vocab=128)),
                embed_dim=32)
RC = RecallConfig(exit_interval=1, superficial_layers=2, predictor_hidden=32,
                  lora_rank=4, query_granularities=2)
TCFG = TC.MEMConfig(towers=(TC.TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                            TC.TowerConfig("text", 3, 32, 2, 64, 8, 0,
                                           vocab=128)),
                    embed_dim=32)
TRC = TC.RecallConfig(exit_interval=1, superficial_layers=2,
                      predictor_hidden=32, lora_rank=4,
                      query_granularities=2)
LR = 1e-3  # HealConfig's


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol):
    if isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0)
        return
    assert sorted(got) == sorted(want)
    for k in got:
        _assert_tree_close(got[k], want[k], atol)


def test_cosine_distill_loss_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((3, 5, 8)).astype(np.float32)
    want = float(JH.cosine_distill_loss(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b)
    tb.requires_grad_()
    got = TH.cosine_distill_loss(ta, tb)
    assert abs(float(got.detach()) - want) <= 1e-6
    ga, gb = torch.autograd.grad(got, (ta, tb), allow_unused=True)
    assert gb is None  # the target is detached, as stop_gradient
    np.testing.assert_allclose(
        ga.numpy(), np.asarray(jax.grad(lambda x: JH.cosine_distill_loss(
            x, jnp.asarray(b)))(jnp.asarray(a))), atol=1e-7)


@pytest.mark.parametrize("hist", [None, np.array([5.0, 1.0, 0.0, 3.0])])
def test_exit_weights_match_reference_arithmetic(hist):
    h = np.ones(4) if hist is None else hist
    w = np.maximum(np.asarray(h, np.float64), 0)
    w = w / max(w.sum(), 1e-9) + 0.1
    want = np.asarray(jnp.asarray(w / w.sum(), jnp.float32))
    np.testing.assert_array_equal(TH.exit_weights(h, 0.1, "cpu").numpy(),
                                  want)


def _tree_pair(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((4, 3, 2)).astype(np.float32),
              "b": {"c": rng.standard_normal((4, 5)).astype(np.float32)}}
    mask = {"a": np.array([1, 0, 0, 1], np.float32).reshape(4, 1, 1),
            "b": {"c": np.array([0, 1, 1, 0], np.float32).reshape(4, 1)}}
    return params, mask


def test_adamw_grad_mask_matches_reference():
    """The mask multiplies the grads before the global norm (so it moves
    the clip), and a masked leaf still moves from the moments of earlier
    unmasked steps (ROADMAP C.4: "frozen" layers drift)."""
    params, mask = _tree_pair(0)
    rng = np.random.default_rng(1)
    jopt = JAdamW(lr=1e-2, weight_decay=0.0, clip_norm=1.0)
    topt = TAdamW(lr=1e-2, weight_decay=0.0, clip_norm=1.0)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    ones = jax.tree.map(np.ones_like, mask)
    for step, m in enumerate((ones, mask, mask)):
        grads = jax.tree.map(
            lambda x: (5 * rng.standard_normal(x.shape)).astype(np.float32),
            params)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                                 grad_mask=jax.tree.map(jnp.asarray, m))
        before = jax.tree.map(lambda x: x, tp)
        tp, ts, tm = topt.update(params_from_jax(grads), ts, tp,
                                 grad_mask=params_from_jax(m))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _assert_tree_close(tp, _np(jp), atol=1e-6)
        _assert_tree_close(ts.m, _np(js.m), atol=1e-6)
        if step == 2:  # masked rows moved all the same (momentum)
            moved = (tp["a"] - before["a"])[1:3].abs().max().item()
            assert moved > 1e-4


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_accumulate_grads_matches_reference(microbatches):
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((6, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((9, 6)).astype(np.float32),
             "y": rng.standard_normal((9, 3)).astype(np.float32)}

    def j_loss(p, bt):
        return jnp.mean((jnp.tanh(bt["x"] @ p["w"] + p["b"]) - bt["y"]) ** 2)

    def t_loss(p, bt):
        return torch.mean((torch.tanh(bt["x"] @ p["w"] + p["b"])
                           - bt["y"]) ** 2)

    jl, jg = j_accumulate_grads(j_loss, jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, batch),
                                microbatches=microbatches)
    tl, tg = t_accumulate_grads(t_loss, params_from_jax(params),
                                params_from_jax(batch),
                                microbatches=microbatches)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, _np(jg), atol=1e-6)
    assert all(t.dtype == torch.float32 for t in (tg["w"], tg["b"]))


def _check_run(t_lora, t_log, j_lora, j_log, init, loss_rtol=1e-4):
    """Per-step losses (first and last of each phase: every step at two
    steps a phase) at ``loss_rtol``; the final LoRA leaves: no element
    further than two Adam steps (2 lr: one step of either sign at an
    element whose gradient is at the two packages' fp32 rounding noise),
    and 99 % of them within 1e-5 (1 % of lr)."""
    assert [p["window"] for p in t_log] == [tuple(p["window"])
                                           for p in j_log]
    for tp_, jp_ in zip(t_log, j_log):
        for key in ("loss_first", "loss_last"):
            np.testing.assert_allclose(tp_[key], jp_[key], rtol=loss_rtol)
    diff, moved = [], []
    for t in j_lora:
        for k in ("a", "b"):
            w = np.asarray(j_lora[t][k])
            assert t_lora[t][k].dtype == torch.float32
            diff.append(np.abs(t_lora[t][k].numpy() - w).ravel())
            moved.append(np.abs(w - init[t][k].numpy()).ravel())
    diff, moved = np.concatenate(diff), np.concatenate(moved)
    assert moved.max() > 2 * LR  # the comparison is of trained leaves
    assert diff.max() <= 2 * LR, diff.max()
    assert np.quantile(diff, 0.99) <= 1e-5, np.quantile(diff, 0.99)


@pytest.fixture(scope="module")
def mem():
    key = jax.random.PRNGKey(0)
    jp = JIB.mem_init(key, CFG, RC)
    return key, jp, params_from_jax(_np(jp))


# the skewed histogram's losses are held at 1e-3: at the first step of its
# window (2, 4) one element of layer 2's wq B has a gradient of 2.3e-7
# (against 0.08 in that leaf, the fp32 noise of the two packages' sums)
# whose sign differs between them, and Adam's first step on a fresh window
# moves every element by about 0.55 lr times its gradient's sign, so the two
# runs part by 1.1e-3 in that element and 1.4e-4 of the next loss
@pytest.mark.parametrize("hist,loss_rtol",
                         [(None, 1e-4), (np.array([1.0, 6.0, 2.0, 1.0]),
                                         1e-3)], ids=["uniform", "skewed"])
def test_heal_tower_matches_reference(mem, monkeypatch, hist, loss_rtol):
    key, jp, tp = mem
    data = multimodal_pairs(0, 48, CFG).items["vision"]
    j_lora, j_log = JH.heal_tower(key, jp, CFG, RC, "vision",
                                  jnp.asarray(data), exit_hist=hist,
                                  heal_cfg=JH.HealConfig(steps_per_phase=2,
                                                         batch=16))
    tcfg = JIB.tower_lm_cfg(CFG.tower("vision"), CFG)
    init = params_from_jax(_np(JP.lora_init(key, tcfg, RC)))
    monkeypatch.setattr(TP, "lora_init", lambda *a, **k: init)
    t_lora, t_log = TH.heal_tower(None, tp, TCFG, TRC, "vision", data,
                                  exit_hist=hist,
                                  heal_cfg=TH.HealConfig(steps_per_phase=2,
                                                         batch=16),
                                  device="cpu")
    _check_run(t_lora, t_log, j_lora, j_log, init, loss_rtol)
    assert all(p["step_s"] > 0 for p in t_log)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_heal_lm_matches_reference(monkeypatch, arch):
    """The MoE config heals through the grouped GEMM's autograd Function,
    whose CPU backward is the plain dX (the expert weights are frozen: no
    dW)."""
    ref = JC.smoke_variant(JC.get_arch(arch))
    port = TC.smoke_variant(TC.get_arch(arch))
    key = jax.random.PRNGKey(0)
    jp = JT.lm_init(key, ref.model, ref.recall)
    tokens = np.random.default_rng(0).integers(
        0, ref.model.vocab, (12, 16)).astype(np.int32)
    hc = dict(steps_per_phase=2, batch=8)
    j_lora, j_log = JH.heal_lm(key, jp, ref.model, ref.recall,
                               jnp.asarray(tokens),
                               heal_cfg=JH.HealConfig(**hc))
    init = params_from_jax(_np(JP.lora_init(key, ref.model, ref.recall)))
    monkeypatch.setattr(TP, "lora_init", lambda *a, **k: init)
    t_lora, t_log = TH.heal_lm(None, params_from_jax(_np(jp)), port.model,
                               port.recall, tokens,
                               heal_cfg=TH.HealConfig(**hc), device="cpu")
    _check_run(t_lora, t_log, j_lora, j_log, init)


def test_refuse_grad_only_under_grad_mode():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient in the "
                                                  "reference"):
        refuse_grad("k", NO_REFERENCE_GRAD, torch.ones(2), x)
    with torch.no_grad():
        refuse_grad("k", NO_REFERENCE_GRAD, x)
    refuse_grad("k", NO_REFERENCE_GRAD, torch.ones(2), None, 3)
