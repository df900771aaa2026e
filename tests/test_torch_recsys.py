"""Port parity: the recsys models (``models/recsys.py``: the embedding bags,
DLRM, BST, SASRec, DIEN, ``user_vector``, ``retrieval_scores``) and the
layer helpers they use, against the reference on the CPU, fp32, inputs
from numpy seeds and the reference's params carried across. Outputs are
held within 1e-5 relative, gradients within 1e-5 of each leaf's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RecsysConfig as JRecsysConfig
from repro.models import layers as JL
from repro.models import recsys as JR
from repro_torch.configs.base import RecsysConfig
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import value_and_grad
from torch_train_common import (torch_threads,  # noqa: F401 (autouse)
                                leaf_errs, to_np)

# tests/test_models_other.py's RECSYS_CASES
CASES = {
    "dlrm": dict(kind="dlrm", embed_dim=16, table_vocabs=(50, 30, 40),
                 n_dense=13, bot_mlp=(32, 16), top_mlp=(32, 16, 1)),
    "bst": dict(kind="bst", embed_dim=16, seq_len=8, item_vocab=100,
                n_heads=4, n_blocks=1, mlp=(32, 16)),
    "sasrec": dict(kind="sasrec", embed_dim=16, seq_len=8, item_vocab=100,
                   n_heads=1, n_blocks=2),
    "dien": dict(kind="dien", embed_dim=8, seq_len=10, item_vocab=100,
                 gru_dim=12, mlp=(20, 8)),
}


def recsys_batch(cfg, B=4, seed=0):
    """A batch of ``cfg``'s inputs drawn with numpy (the reference test's
    fields and ranges), with a few ids past the tables to exercise the
    clamp."""
    rng = np.random.default_rng(seed)
    ints = lambda hi, shape: rng.integers(0, hi, shape).astype(np.int32)
    label = (rng.random(B) < 0.3).astype(np.float32)
    if cfg.kind == "dlrm":
        sparse = ints(30, (B, len(cfg.table_vocabs)))
        sparse[0, 1] = 77  # past table 1's 30 rows: clamped
        return {"dense": rng.standard_normal((B, cfg.n_dense)).astype(
            np.float32), "sparse": sparse, "label": label}
    base = {"hist": ints(cfg.item_vocab, (B, cfg.seq_len)),
            "target": ints(cfg.item_vocab, (B,)), "label": label}
    base["hist"][0, 0] = cfg.item_vocab + 5
    if cfg.kind == "bst":
        base["other"] = rng.standard_normal((B, JR.BST_OTHER_DIM)).astype(
            np.float32)
    if cfg.kind == "sasrec":
        base["pos"] = ints(cfg.item_vocab, (B, cfg.seq_len))
        base["neg"] = ints(cfg.item_vocab, (B, cfg.seq_len))
    if cfg.kind == "dien":
        base["hist_cate"] = ints(16, (B, cfg.seq_len))
        base["target_cate"] = ints(16, (B,))
    return base


def assert_grads(got, want, tol, what):
    """Each gradient leaf within ``tol`` of its scale (its largest
    |element| in ``want``). An attention's key bias ``bk`` adds q·bk to
    every score of a query's row, which the softmax ignores: its true
    gradient is 0 and both packages' are rounding noise (1e-8 against a
    ``wk`` gradient of 0.2 in the BST case), so it is held within ``tol``
    of its block's ``wk`` gradient scale instead."""
    errs = leaf_errs(got, want)
    for path in [p for p in errs if p.endswith("/attn/bk")]:
        node_g, node_w = got, want
        for k in path.strip("/").split("/")[:-1]:
            node_g, node_w = node_g[k], node_w[k]
        diff = np.abs(node_g["bk"].double().numpy() - node_w["bk"]).max()
        errs[path] = diff / np.abs(node_w["wk"]).max()
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]:.2e}"


def _rel(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    return err / max(np.abs(want).max(), 1e-30)


def test_embedding_bag_modes_match_reference():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[1, 2, 3], [4, 4, 0], [12, -3, 9]], np.int32)
    mask = np.array([[1, 1, 0], [1, 0, 0], [1, 1, 1]], np.float32)
    for m in (mask, None):
        for mode in ("sum", "mean"):
            want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                    None if m is None else jnp.asarray(m),
                                    mode=mode)
            got = TR.embedding_bag(torch.as_tensor(table),
                                   torch.as_tensor(ids),
                                   None if m is None else torch.as_tensor(m),
                                   mode=mode)
            assert _rel(got, want) <= 1e-6, (mode, m is None)
    with pytest.raises(ValueError):
        TR.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                         mode="max")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(mode):
    """Flat ids grouped by segment, weighted; segment ids -1 and 5 lie
    outside the 4 bags and are dropped, id 11 is clamped into the table;
    the table's gradient too."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([1, 2, 4, 11, 3, 3, 0, 7], np.int32)
    seg = np.array([0, 0, 1, 3, 5, -1, 3, 3], np.int32)
    w = rng.random(8).astype(np.float32)
    co = rng.standard_normal((4, 4)).astype(np.float32)

    def jf(t):
        out = JR.embedding_bag_ragged(t, jnp.asarray(ids), jnp.asarray(seg),
                                      4, jnp.asarray(w), mode=mode)
        return jnp.sum(out * co), out

    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    got = TR.embedding_bag_ragged(tt, torch.as_tensor(ids),
                                  torch.as_tensor(seg), 4,
                                  torch.as_tensor(w), mode=mode)
    tg, = torch.autograd.grad((got * torch.as_tensor(co)).sum(), tt)
    assert _rel(got, want) <= 1e-6
    assert _rel(tg, jg) <= 1e-6


def test_segment_sum_drops_out_of_range_ids_as_the_reference():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((9, 3)).astype(np.float32)
    seg = np.array([0, 2, 2, -1, 4, 6, 1, 0, 5], np.int32)
    want = JL.segment_sum(jnp.asarray(data), jnp.asarray(seg), 5)
    got = TL.segment_sum(torch.as_tensor(data), torch.as_tensor(seg), 5)
    assert _rel(got, want) <= 1e-6 and got.shape == (5, 3)


@pytest.mark.parametrize("causal", [False, True])
def test_block_layers_match_reference(causal):
    """layernorm, attn_project_qkv, multihead_attention (head dims 4 and
    the GQA grouping), attn_output against the reference's."""
    rng = np.random.default_rng(4)
    B, S, d, H, KV = 3, 7, 16, 4, 2
    hd = d // H
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    p = {"wq": rng.standard_normal((d, H, hd)), "wk": rng.standard_normal(
        (d, KV, hd)), "wv": rng.standard_normal((d, KV, hd)),
        "wo": rng.standard_normal((H, hd, d)), "bq": rng.standard_normal(
            (H, hd)), "bk": rng.standard_normal((KV, hd)),
        "bv": rng.standard_normal((KV, hd))}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    s, b = (1 + 0.1 * rng.standard_normal((2, d))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    assert _rel(TL.layernorm(tx, torch.as_tensor(s), torch.as_tensor(b)),
                JL.layernorm(jx, jnp.asarray(s), jnp.asarray(b))) <= 1e-6
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    jq = JL.attn_project_qkv(jp, jx, rope_theta=0.0, positions=pos)
    tq = TL.attn_project_qkv(tp, tx, rope_theta=0.0, positions=None)
    for g, w in zip(tq, jq):
        assert _rel(g, w) <= 1e-6
    assert torch.equal(TL.attention_scores_mask(S, S, causal=causal,
                                                window=3),
                       torch.as_tensor(np.array(JL.attention_scores_mask(
                           S, S, causal=causal, window=3))))
    mask = JL.attention_scores_mask(S, S, causal=causal)
    jo = JL.multihead_attention(*jq, mask=mask)
    to = TL.multihead_attention(*tq, mask=TL.attention_scores_mask(
        S, S, causal=causal))
    assert _rel(to, jo) <= 1e-5
    assert _rel(TL.attn_output(tp, to), JL.attn_output(jp, jo)) <= 1e-5


@pytest.fixture(scope="module")
def recsys_cases():
    """{kind: (ref cfg, port cfg, ref params (numpy), batch, the
    reference's outputs)}: its forward, loss and gradient, user_vector
    and retrieval_scores over 20 candidates, one jitted call a case."""
    out = {}
    for kind, kw in CASES.items():
        jcfg, tcfg = JRecsysConfig(**kw), RecsysConfig(**kw)
        p = JR.recsys_init(jax.random.PRNGKey(0), jcfg)
        batch = recsys_batch(jcfg)

        @jax.jit
        def ref(p, b, jcfg=jcfg):
            (loss, _), g = jax.value_and_grad(
                lambda q: JR.recsys_loss(q, jcfg, b), has_aux=True)(p)
            return {"forward": JR.recsys_forward(p, jcfg, b), "loss": loss,
                    "grads": g, "user": JR.user_vector(p, jcfg, b),
                    "scores": JR.retrieval_scores(p, jcfg, b, 20)}

        want = to_np(ref(p, {k: jnp.asarray(v) for k, v in batch.items()}))
        out[kind] = (jcfg, tcfg, to_np(p), batch, want)
    return out


@pytest.mark.parametrize("kind", list(CASES))
def test_recsys_model_matches_reference(recsys_cases, kind):
    """forward, recsys_loss's value and gradient, user_vector and
    retrieval_scores."""
    jcfg, tcfg, p, batch, want = recsys_cases[kind]
    tp = params_from_jax(p)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    assert _rel(TR.recsys_forward(tp, tcfg, tb), want["forward"]) <= 1e-5
    loss, grads = value_and_grad(
        lambda q, b: TR.recsys_loss(q, tcfg, b)[0], tp, tb)
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    assert_grads(grads, want["grads"], 1e-5, f"{kind} gradient")
    assert _rel(TR.user_vector(tp, tcfg, tb), want["user"]) <= 1e-5
    assert _rel(TR.retrieval_scores(tp, tcfg, tb, 20), want["scores"]) \
        <= 1e-5


def test_recsys_schema_and_init_match_reference_shapes():
    for kw in CASES.values():
        jp = JR.recsys_init(jax.random.PRNGKey(0), JRecsysConfig(**kw))
        tp = TR.recsys_init(torch.Generator().manual_seed(0),
                            RecsysConfig(**kw), device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
            _shapes(tp), kw["kind"]


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    return {k: _shapes(v) for k, v in tree.items()}
