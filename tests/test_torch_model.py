"""Port parity: the MEM encoder, with the reference's params carried across
by ``params_from_jax``, computes what the reference computes (fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro.models import imagebind as JIB
from repro.models import transformer as JT
from repro_torch.configs import base as TC
from repro_torch.models import imagebind as TIB
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

# the tests/test_serving.py config, fp32
CFG = MEMConfig(towers=(TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                        TowerConfig("text", 3, 32, 2, 64, 8, 0, vocab=128)),
                embed_dim=32, dtype="float32")
RC = RecallConfig(exit_interval=1, superficial_layers=2, predictor_hidden=32,
                  lora_rank=4, query_granularities=2)
TCFG = TC.MEMConfig(towers=(TC.TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                            TC.TowerConfig("text", 3, 32, 2, 64, 8, 0,
                                           vocab=128)),
                    embed_dim=32, dtype="float32")
TRC = TC.RecallConfig(exit_interval=1, superficial_layers=2,
                      predictor_hidden=32, lora_rank=4,
                      query_granularities=2)
ATOL = 1e-4  # embeddings (unit norm)


def _assert_hidden_close(got, want):
    """Hidden states (magnitude up to ~40): one layer agrees to ~1e-6 of the
    tensor's scale, and the random-init residual stream amplifies that
    roundoff ~3x a layer; hold the max error to 1e-4 of the scale."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def both():
    jp = JIB.mem_init(jax.random.PRNGKey(0), CFG, RC)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    inputs = {"vision": rng.standard_normal((5, 12, 16)).astype(np.float32),
              "text": rng.integers(0, 140, (5, 8)).astype(np.int32)}
    return jp, tp, inputs


def test_config_copy_matches_reference():
    for t_port, t_ref in zip(TCFG.towers, CFG.towers):
        assert t_port.__dict__ == t_ref.__dict__
    assert TRC.exit_layers(4) == RC.exit_layers(4)
    from repro.configs.base import get_arch, smoke_variant
    ref = get_arch("recall-imagebind")
    port = TC.get_arch("recall-imagebind")
    for spec_ref, spec_port in ((ref, port),
                                (smoke_variant(ref), TC.smoke_variant(port))):
        assert spec_port.arch_id == spec_ref.arch_id
        assert [t.__dict__ for t in spec_port.model.towers] == \
            [t.__dict__ for t in spec_ref.model.towers]
        assert spec_port.model.embed_dim == spec_ref.model.embed_dim
        assert spec_port.model.dtype == spec_ref.model.dtype
        assert spec_port.recall.__dict__ == spec_ref.recall.__dict__


def test_param_tree_matches_reference(both):
    jp, tp, _ = both
    ours = TIB.mem_init(torch.Generator().manual_seed(0), TCFG, TRC,
                        device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node_t, node_o = tp, ours
        for key in path:
            node_t, node_o = node_t[key.key], node_o[key.key]
        assert tuple(node_t.shape) == tuple(leaf.shape) == tuple(node_o.shape)
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("modality", ["vision", "text"])
def test_tower_forward_and_exits(both, modality):
    jp, tp, inputs = both
    x = inputs[modality]
    j = JIB.tower_forward(jp, CFG, RC, modality, jnp.asarray(x))
    t = TIB.tower_forward(tp, TCFG, TRC, modality, torch.from_numpy(x))
    _assert_hidden_close(t["h"].numpy(), j["h"])
    _assert_hidden_close(t["pooled"].numpy(), j["pooled"])
    ja = JIB.mem_embed_all_exits(jp, CFG, RC, modality, jnp.asarray(x))
    ta = TIB.mem_embed_all_exits(tp, TCFG, TRC, modality, torch.from_numpy(x))
    assert ta["exits"] == ja["exits"]
    np.testing.assert_allclose(ta["exit_embs"].numpy(),
                               np.asarray(ja["exit_embs"]), atol=ATOL)
    # exit_embedding on its own, and a coarse mem_embed at exit 2
    e_j = JT.exit_embedding(jp["towers"][modality], j["pooled"][1])
    e_t = TT.exit_embedding(tp["towers"][modality], t["pooled"][1])
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=ATOL)
    c_j = JIB.mem_embed(jp, CFG, RC, modality, jnp.asarray(x), exit_layer=2)
    c_t = TIB.mem_embed(tp, TCFG, TRC, modality, torch.from_numpy(x),
                        exit_layer=2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)


def test_mem_refine_from_cached_state(both):
    jp, tp, inputs = both
    x = inputs["vision"]
    N = RC.superficial_layers
    h_j = JIB.tower_forward(jp, CFG, RC, "vision", jnp.asarray(x),
                            layer_end=N)["h"]
    h = np.array(h_j)
    r_j = JIB.mem_refine(jp, CFG, RC, "vision", jnp.asarray(h), N)
    r_t = TIB.mem_refine(tp, TCFG, TRC, "vision", torch.from_numpy(h), N)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=ATOL)
    full = TIB.mem_embed(tp, TCFG, TRC, "vision", torch.from_numpy(x))
    np.testing.assert_allclose(r_t.numpy(), full.numpy(), atol=ATOL)


def test_info_nce(both):
    jp, tp, inputs = both
    rng = np.random.default_rng(1)
    za = rng.standard_normal((6, 32)).astype(np.float32)
    zb = rng.standard_normal((6, 32)).astype(np.float32)
    want = JIB.info_nce(jnp.asarray(za), jnp.asarray(zb), jp["logit_scale"])
    got = TIB.info_nce(torch.from_numpy(za), torch.from_numpy(zb),
                       tp["logit_scale"])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _tower_lora(modality, seed, scale=0.05):
    """A non-zero LoRA (numpy, the reference's schema) for one tower."""
    from repro.core import plora as JP
    tcfg = JIB.tower_lm_cfg(CFG.tower(modality), CFG)
    rng = np.random.default_rng(seed)
    return {t: {k: (scale * rng.standard_normal(d.shape)).astype(np.float32)
                for k, d in ab.items()}
            for t, ab in JP.lora_schema(tcfg, RC).items()}


@pytest.mark.parametrize("modality", ["vision", "text"])
def test_tower_forward_with_lora_matches_reference(both, modality):
    """tower_forward, mem_embed_all_exits and a coarse mem_embed with a
    non-zero LoRA (every target) against the reference: embeddings at
    1e-5, hidden states as without a LoRA; the LoRA moves the embeddings
    by far more."""
    jp, tp, inputs = both
    x = inputs[modality]
    lora = _tower_lora(modality, seed=3)
    jl, tl = jax.tree.map(jnp.asarray, lora), params_from_jax(lora)
    j = JIB.tower_forward(jp, CFG, RC, modality, jnp.asarray(x), lora=jl)
    t = TIB.tower_forward(tp, TCFG, TRC, modality, torch.from_numpy(x),
                          lora=tl)
    _assert_hidden_close(t["h"].numpy(), j["h"])
    _assert_hidden_close(t["pooled"].numpy(), j["pooled"])
    ja = JIB.mem_embed_all_exits(jp, CFG, RC, modality, jnp.asarray(x),
                                 lora=jl)
    ta = TIB.mem_embed_all_exits(tp, TCFG, TRC, modality, torch.from_numpy(x),
                                 lora=tl)
    np.testing.assert_allclose(ta["exit_embs"].numpy(),
                               np.asarray(ja["exit_embs"]), atol=1e-5)
    j0 = JIB.mem_embed_all_exits(jp, CFG, RC, modality, jnp.asarray(x))
    assert np.abs(np.asarray(j0["exit_embs"])
                  - np.asarray(ja["exit_embs"])).max() > 1e-2
    c_j = JIB.mem_embed(jp, CFG, RC, modality, jnp.asarray(x), exit_layer=2,
                        lora=jl)
    c_t = TIB.mem_embed(tp, TCFG, TRC, modality, torch.from_numpy(x),
                        exit_layer=2, lora=tl)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)


def test_mem_refine_with_lora_resumes_the_healed_prefix(both):
    """Refinement from a cached layer-N state with the LoRA (its layers
    [N, L)) against the reference, and equal to the full healed forward
    (the shared suite's prefix property, paper §3.3)."""
    jp, tp, inputs = both
    x = inputs["vision"]
    N = RC.superficial_layers
    lora = _tower_lora("vision", seed=4)
    jl, tl = jax.tree.map(jnp.asarray, lora), params_from_jax(lora)
    h = np.array(JIB.tower_forward(jp, CFG, RC, "vision", jnp.asarray(x),
                                   layer_end=N, lora=jl)["h"])
    r_j = JIB.mem_refine(jp, CFG, RC, "vision", jnp.asarray(h), N, lora=jl)
    r_t = TIB.mem_refine(tp, TCFG, TRC, "vision", torch.from_numpy(h), N,
                         lora=tl)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5)
    full = TIB.mem_embed(tp, TCFG, TRC, "vision", torch.from_numpy(x),
                         lora=tl)
    np.testing.assert_allclose(r_t.numpy(), full.numpy(), atol=1e-5)


# the same towers in bf16: the reference promotes the vision tower (fp32
# stub features) and refinement (fp32 cached activations) to fp32, while
# the text tower (a bf16 token lookup) runs in bf16
CFG16 = MEMConfig(towers=CFG.towers, embed_dim=32, dtype="bfloat16")
TCFG16 = TC.MEMConfig(towers=TCFG.towers, embed_dim=32, dtype="bfloat16")
ATOL_BF16 = 4 * 2.0 ** -8  # text embeddings: a few bf16 steps of unit norm


def test_bf16_config_keeps_reference_dtypes():
    jp = JIB.mem_init(jax.random.PRNGKey(1), CFG16, RC)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert tp["towers"]["vision"]["proj_in"].dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    vis = rng.standard_normal((4, 12, 16)).astype(np.float32)
    txt = rng.integers(0, 128, (4, 8)).astype(np.int32)
    for modality, x, atol in (("vision", vis, ATOL), ("text", txt, ATOL_BF16)):
        j = JIB.mem_embed_all_exits(jp, CFG16, RC, modality, jnp.asarray(x))
        t = TIB.mem_embed_all_exits(tp, TCFG16, TRC, modality,
                                    torch.from_numpy(x))
        assert t["pooled"].dtype == \
            {"bfloat16": torch.bfloat16, "float32": torch.float32}[
                str(j["pooled"].dtype)]
        np.testing.assert_allclose(t["exit_embs"].numpy(),
                                   np.asarray(j["exit_embs"]), atol=atol)
    # refinement resumes from an fp32 hidden state (the dequantized cache)
    N = RC.superficial_layers
    h = np.array(JIB.tower_forward(jp, CFG16, RC, "vision", jnp.asarray(vis),
                                   layer_end=N)["h"], np.float32)
    r_j = JIB.mem_refine(jp, CFG16, RC, "vision", jnp.asarray(h), N)
    r_t = TIB.mem_refine(tp, TCFG16, TRC, "vision", torch.from_numpy(h), N)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=ATOL)
