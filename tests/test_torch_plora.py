"""Port parity: P-LoRA's schema, windows, phase plan and merge
(``repro_torch.core.plora``) against the reference's ``repro.core.plora``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import plora as JP
from repro.models import imagebind as JIB
from repro.models import transformer as JT
from repro_torch.configs import base as TC
from repro_torch.core import plora as TP
from repro_torch.models import imagebind as TIB
from repro_torch.models.convert import params_from_jax

LM_ARCHS = ["qwen2-1.5b", "qwen3-moe-30b-a3b", "minitron-8b", "deepseek-67b",
            "moonshot-v1-16b-a3b"]
TOWERS = ["vision", "text", "audio", "imu"]


def _shapes(schema):
    return {t: {k: tuple(d.shape) for k, d in ab.items()}
            for t, ab in schema.items()}


@pytest.mark.parametrize("tower", TOWERS)
def test_schema_matches_reference_for_recall_imagebind_towers(tower):
    ref, port = JC.get_arch("recall-imagebind"), TC.get_arch(
        "recall-imagebind")
    jcfg = JIB.tower_lm_cfg(ref.model.tower(tower), ref.model)
    tcfg = TIB.tower_lm_cfg(port.model.tower(tower), port.model)
    ours = TP.lora_schema(tcfg, port.recall)
    assert _shapes(ours) == _shapes(JP.lora_schema(jcfg, ref.recall))
    assert sorted(ours) == sorted(port.recall.lora_targets)
    assert TP.lora_n_params(tcfg, port.recall) == \
        JP.lora_n_params(jcfg, ref.recall)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_schema_matches_reference_for_lm_configs(arch):
    ref, port = JC.get_arch(arch), TC.get_arch(arch)
    ours = TP.lora_schema(port.model, port.recall)
    assert _shapes(ours) == _shapes(JP.lora_schema(ref.model, ref.recall))
    # a MoE layer has no dense MLP: LoRA only on the attention projections
    assert ("w_gate" in ours) == (port.model.moe is None)
    assert TP.lora_n_params(port.model, port.recall) == \
        JP.lora_n_params(ref.model, ref.recall)


def test_lora_init_is_identity_at_start():
    port = TC.smoke_variant(TC.get_arch("qwen2-1.5b"))
    gen = torch.Generator().manual_seed(0)
    lora = TP.lora_init(gen, port.model, port.recall, device="cpu")
    schema = TP.lora_schema(port.model, port.recall)
    for t, ab in lora.items():
        assert ab["a"].dtype == torch.float32
        assert tuple(ab["a"].shape) == schema[t]["a"].shape
        assert bool((ab["b"] == 0).all()) and bool(ab["a"].abs().sum() > 0)
    half = TP.lora_init(gen, port.model, port.recall, dtype=torch.bfloat16,
                        device="cpu")
    assert half["wq"]["a"].dtype == torch.bfloat16


def _small_lora(seed=0):
    ref = JC.smoke_variant(JC.get_arch("qwen2-1.5b"))
    rng = np.random.default_rng(seed)
    return {t: {k: rng.standard_normal(d.shape).astype(np.float32)
                for k, d in ab.items()}
            for t, ab in JP.lora_schema(ref.model, ref.recall).items()}


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 3), (0, 4), (3, 4), (2, 2)])
def test_window_mask_matches_reference(lo, hi):
    lora = _small_lora()
    want = JP.window_mask(jax.tree.map(jnp.asarray, lora), lo, hi)
    got = TP.window_mask(params_from_jax(lora), lo, hi)
    for t in lora:
        for k in ("a", "b"):
            g, w = got[t][k], np.asarray(want[t][k])
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
            # broadcasts over its leaf: layer l scaled by [lo <= l < hi]
            masked = (params_from_jax(lora)[t][k] * g).numpy()
            np.testing.assert_array_equal(masked[lo:hi], lora[t][k][lo:hi])
            assert not masked[:lo].any() and not masked[hi:].any()


HISTS = [np.ones(8), np.array([10, 0, 0, 0, 0, 0, 0, 0]),
         np.array([0, 0, 0, 0, 0, 0, 0, 5]), np.array([1, 2, 8, 3, 1, 0, 1, 1]),
         np.zeros(8), np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]),
         np.ones(7)]


@pytest.mark.parametrize("hist", HISTS, ids=lambda h: "-".join(
    str(int(x)) for x in h))
@pytest.mark.parametrize("min_step,max_step", [(1, 4), (2, 3), (1, 1)])
def test_schedule_steps_and_phases_match_reference(hist, min_step, max_step):
    rc_j = JC.RecallConfig(exit_interval=4, plora_min_step=min_step,
                           plora_max_step=max_step)
    rc_t = TC.RecallConfig(exit_interval=4, plora_min_step=min_step,
                           plora_max_step=max_step)
    steps = TP.schedule_steps(hist, rc_t)
    assert steps == JP.schedule_steps(hist, rc_j)
    exits = list(rc_t.exit_layers(4 * len(hist)))
    assert exits == list(rc_j.exit_layers(4 * len(hist)))
    phases = TP.plora_phases(exits, steps)
    assert phases == JP.plora_phases(exits, steps)
    # the windows tile [0, L)
    assert phases[0][0] == 0 and phases[-1][1] == exits[-1]
    assert all(a[1] == b[0] for a, b in zip(phases, phases[1:]))


def test_recall_imagebind_vision_tower_plan_has_six_phases():
    """The heal path's plan: 8 exits, uniform histogram -> steps
    [1, 1, 1, 1, 2, 4] -> windows of 4, 4, 4, 4, 8 and 8 layers."""
    rc = TC.get_arch("recall-imagebind").recall
    exits = list(rc.exit_layers(32))
    steps = TP.schedule_steps(np.ones(len(exits)), rc)
    assert steps == [1, 1, 1, 1, 2, 4]
    assert TP.plora_phases(exits, steps) == [(0, 4), (4, 8), (8, 12),
                                             (12, 16), (16, 24), (24, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_is_bit_equal_to_reference(dtype):
    ref = JC.smoke_variant(JC.get_arch("qwen2-1.5b"))
    rc_j = ref.recall
    rc_t = TC.smoke_variant(TC.get_arch("qwen2-1.5b")).recall
    jp = JT.lm_init(jax.random.PRNGKey(3), ref.model, rc_j)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    lora = _small_lora(seed=1)
    want = JP.merge_lora(jp, jax.tree.map(jnp.asarray, lora), rc_j)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    got = TP.merge_lora(tp, params_from_jax(lora), rc_t)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    n_changed = 0
    for path, leaf in flat:
        node, orig = got, tp
        for key in path:
            node, orig = node[key.key], orig[key.key]
        assert node.dtype == orig.dtype
        w = np.asarray(leaf.astype(jnp.float32))
        np.testing.assert_array_equal(node.float().numpy(), w)
        n_changed += int(not torch.equal(node, orig))
    assert n_changed == 7  # the seven targets, no other leaf
    # the inputs are left as they were
    np.testing.assert_array_equal(
        tp["layers"]["attn"]["wq"].float().numpy(),
        np.asarray(jp["layers"]["attn"]["wq"].astype(jnp.float32)))
