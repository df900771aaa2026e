"""Port parity: GatedGCN (``models/gnn.py``) against the reference on the
CPU, fp32: the forward (h, e, logits, pooled), the loss and its gradient
with and without remat, padded edges, the exit embeddings, the
prefix-refine resume and the batched loss (the reference's ``vmap``, run
by the port as one disjoint union), with out-of-range ids. Inputs from
numpy seeds, the reference's params carried across; outputs within 1e-5
relative, gradients within 1e-5 of each leaf's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JGNNConfig
from repro.configs.base import RecallConfig as JRecallConfig
from repro.models import gnn as JG
from repro_torch.configs.base import GNNConfig, RecallConfig
from repro_torch.models import gnn as TG
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import value_and_grad
from torch_train_common import (torch_threads,  # noqa: F401 (autouse)
                                assert_leaves, to_np)

KW = dict(n_layers=3, d_hidden=16, d_feat=8, n_classes=5)
JCFG, TCFG = JGNNConfig(**KW), GNNConfig(**KW)
JRC = JRecallConfig(exit_interval=1, superficial_layers=1)
TRC = RecallConfig(exit_interval=1, superficial_layers=1)


def graph_np(N=32, E=96, F=8, C=5, seed=0, bad_ids=False):
    """A random graph as numpy arrays (the reference test's shapes), some
    labels -1 and two nodes masked; ``bad_ids`` puts a src and a dst past
    N and a dst below 0."""
    rng = np.random.default_rng(seed)
    g = {"node_feat": rng.standard_normal((N, F)).astype(np.float32),
         "src": rng.integers(0, N, E).astype(np.int32),
         "dst": rng.integers(0, N, E).astype(np.int32),
         "node_mask": np.ones(N, np.float32),
         "edge_mask": (rng.random(E) < 0.9).astype(np.float32),
         "labels": rng.integers(-1, C, N).astype(np.int32)}
    g["node_mask"][:2] = 0.0
    if bad_ids:
        g["src"][3], g["dst"][5], g["dst"][7] = N + 4, N + 1, -2
    return g


def jgraph(g):
    return JG.Graph(*[jnp.asarray(g[f]) for f in JG.Graph._fields])


def tgraph(g):
    return TG.Graph(*[torch.as_tensor(g[f]) for f in TG.Graph._fields])


def _rel(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    return err / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def params():
    p = JG.gnn_init(jax.random.PRNGKey(0), JCFG, JRC, embed_out=16)
    return p, params_from_jax(to_np(p))


@pytest.mark.parametrize("bad_ids", [False, True])
def test_gnn_forward_matches_reference(params, bad_ids):
    jp, tp = params
    g = graph_np(bad_ids=bad_ids)
    want = JG.gnn_forward(jp, JCFG, JRC, jgraph(g), collect_pooled=True)
    got = TG.gnn_forward(tp, TCFG, TRC, tgraph(g), collect_pooled=True)
    for k in ("h", "e", "logits", "pooled"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= 1e-5, k


@pytest.fixture(scope="module")
def ref_loss_grad(params):
    """The reference's gnn_loss value and gradient on ``graph_np(seed=1,
    bad_ids=True)``, jitted."""
    jp, _ = params
    g = jgraph(graph_np(seed=1, bad_ids=True))
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda q: JG.gnn_loss(q, JCFG, JRC, g), has_aux=True))(jp)
    return float(loss), float(m["acc"]), to_np(grads)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_gnn_loss_and_grads_match_reference(params, ref_loss_grad, remat):
    _, tp = params
    loss_w, acc_w, grads_w = ref_loss_grad
    g = tgraph(graph_np(seed=1, bad_ids=True))
    metrics = {}

    def fn(q, g):
        loss, m = TG.gnn_loss(q, TCFG, TRC, g, remat=remat)
        metrics.update(m)
        return loss

    loss, grads = value_and_grad(fn, tp, g)
    assert abs(float(loss) - loss_w) <= 1e-5 * abs(loss_w)
    assert float(metrics["acc"]) == pytest.approx(acc_w)
    assert_leaves(grads, grads_w, 1e-5, f"gnn gradient (remat={remat})")


def test_remat_gives_the_same_bits(params):
    _, tp = params
    g = tgraph(graph_np(seed=2))
    runs = [value_and_grad(lambda q, g, r=r: TG.gnn_loss(
        q, TCFG, TRC, g, remat=r)[0], tp, g) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert_leaves(runs[1][1], to_np(runs[0][1]), 0.0, "remat gradient")


def test_padded_edges_do_not_contribute(params):
    """The same graph with 32 masked junk edges appended (the reference
    test's case): h within 1e-5, and equal to the reference's."""
    jp, tp = params
    g = graph_np(E=64)
    g["edge_mask"][:] = 1.0
    rng = np.random.default_rng(9)
    pad = dict(g, src=np.concatenate([g["src"], rng.integers(0, 32, 32)
                                      .astype(np.int32)]),
               dst=np.concatenate([g["dst"], rng.integers(0, 32, 32)
                                   .astype(np.int32)]),
               edge_mask=np.concatenate([g["edge_mask"],
                                         np.zeros(32, np.float32)]))
    o1 = TG.gnn_forward(tp, TCFG, TRC, tgraph(g))["h"]
    o2 = TG.gnn_forward(tp, TCFG, TRC, tgraph(pad))["h"]
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    want = JG.gnn_forward(jp, JCFG, JRC, jgraph(pad))["h"]
    assert _rel(o2, want) <= 1e-5


def test_exit_embeddings_match_reference(params):
    jp, tp = params
    g = graph_np(seed=3)
    want = JG.gnn_exit_embeddings(jp, JCFG, JRC, jgraph(g))
    got = TG.gnn_exit_embeddings(tp, TCFG, TRC, tgraph(g))
    assert got.shape == (3, 16)
    assert _rel(got, want) <= 1e-5
    torch.testing.assert_close(torch.linalg.norm(got, dim=-1),
                               torch.ones(3), rtol=1e-5, atol=0)


def test_prefix_refine_resume_is_bit_equal(params):
    """Rounds [0, 2), then [2, 3) from the cached h and e: the full
    forward's h bit for bit (the reference's invariant)."""
    _, tp = params
    g = tgraph(graph_np(seed=4))
    part = TG.gnn_forward(tp, TCFG, TRC, g, layer_end=2)
    resumed = TG.gnn_forward(tp, TCFG, TRC, g, layer_start=2,
                             h_state=part["h"], e_state=part["e"])
    full = TG.gnn_forward(tp, TCFG, TRC, g)
    assert torch.equal(resumed["h"], full["h"])
    assert torch.equal(resumed["e"], full["e"])


def _batched_np(G=3, seed=5):
    gs = [graph_np(N=12, E=30, seed=seed + i, bad_ids=(i == 1))
          for i in range(G)]
    return {k: np.stack([g[k] for g in gs]) for k in gs[0]}


@pytest.fixture(scope="module")
def ref_batched(params):
    jp, _ = params
    b = _batched_np()
    gs = JG.Graph(*[jnp.asarray(b[f]) for f in JG.Graph._fields])
    out = JG.gnn_forward_batched(jp, JCFG, JRC, gs, collect_pooled=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q: JG.gnn_loss_batched(q, JCFG, JRC, gs)[0]))(jp)
    return b, to_np(out), float(loss), to_np(grads)


def test_batched_forward_matches_reference(params, ref_batched):
    """Three graphs, the second with a src and a dst past its 12 nodes
    and a dst below 0: as one union each graph's ids clamp into its own
    range and its out-of-range messages are dropped, as under vmap."""
    _, tp = params
    b, want, _, _ = ref_batched
    gs = TG.Graph(*[torch.as_tensor(b[f]) for f in TG.Graph._fields])
    got = TG.gnn_forward_batched(tp, TCFG, TRC, gs, collect_pooled=True)
    for k in ("h", "e", "logits", "pooled"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= 1e-5, k


def test_batched_loss_and_grads_match_reference(params, ref_batched):
    _, tp = params
    b, _, loss_w, grads_w = ref_batched
    gs = TG.Graph(*[torch.as_tensor(b[f]) for f in TG.Graph._fields])
    loss, grads = value_and_grad(
        lambda q, g: TG.gnn_loss_batched(q, TCFG, TRC, g)[0], tp, gs)
    assert abs(float(loss) - loss_w) <= 1e-5 * abs(loss_w)
    assert_leaves(grads, grads_w, 1e-5, "batched gnn gradient")
