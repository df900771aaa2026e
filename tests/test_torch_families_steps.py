"""Port parity: ``launch.steps.build_step`` for the recsys and GNN
families and ``launch.train`` on them, against the reference's jitted
steps on a (1, 1) mesh with ``Auto`` axes. Every smoke cell of ``bst``,
``dien``, ``dlrm-mlperf``, ``gatedgcn`` and ``sasrec``, plus a retrieval
cell of each recsys arch and the ``graph_mini`` and ``graph_batched``
kinds at smoke size: the reference's params and batches carried across;
per step the loss, gradient norm and lr, then the moments and the updated
params (``torch_train_common.check_steps`` at its 1e-4, the LM and MEM
steps' tolerance), or the serve and retrieval outputs within 1e-5 (ids
compared only where scores are apart). SASRec's smoke step is the
noisiest in fp32 (its leaves' gradients nearly cancel, in both
packages): its moments after two steps are held at 1e-4 on all but one
element in 16 (``SASREC_TIES``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.distributed.mesh_utils import sharding_ctx
from repro.launch import steps as JS
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro_torch.configs import base as TC
from repro_torch.data import sampler as TSa
from repro_torch.data import synthetic as TSYN
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTR
from repro_torch.models import gnn as TG
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamW, _leaves
from torch_train_common import (torch_threads,  # noqa: F401 (autouse)
                                check_steps, mesh11, to_np)

RECSYS = ["bst", "dien", "dlrm-mlperf", "sasrec"]
SASREC_TIES = 1 / 16


@pytest.mark.parametrize("arch", RECSYS + ["gatedgcn"])
def test_family_configs_and_smoke_variants_match_reference(arch):
    """The five configs field for field (the Criteo-1TB vocabularies,
    GatedGCN's four shapes), their smoke variants (recsys keeps its
    RecallConfig, gnn takes exit_interval 1) and shapes."""
    full = (TC.get_arch(arch), JC.get_arch(arch))
    for port, ref in (full, _pair(arch)[::-1]):
        assert (port.arch_id, port.family, port.source, port.notes) == \
            (ref.arch_id, ref.family, ref.source, ref.notes)
        assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
        assert dataclasses.asdict(port.recall) == \
            dataclasses.asdict(ref.recall)
        assert [dataclasses.asdict(s) for s in port.shapes] == \
            [dataclasses.asdict(s) for s in ref.shapes]


def test_registry_matches_reference():
    assert TC.list_archs() == JC.list_archs()
    assert TC.all_cells() == JC.all_cells()
    assert [dataclasses.asdict(s) for s in TC.recsys_shapes()] == \
        [dataclasses.asdict(s) for s in JC.recsys_shapes()]


def _pair(arch):
    return JC.smoke_variant(JC.get_arch(arch)), \
        TC.smoke_variant(TC.get_arch(arch))


def _recsys_batches(spec, B, n, seed=0):
    data = TTR.make_train_data(spec, None, B * n, seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
            for i in range(n)]


def _ref_fn(bundle, *args):
    with sharding_ctx(mesh11(), bundle.rules):
        return jax.jit(bundle.fn)(*args)


def _ref_train(bundle, params, batches, as_input):
    opt = jax.tree.map(lambda ab: jnp.zeros(ab.shape, ab.dtype),
                       bundle.abstract_args[1])
    fn = jax.jit(bundle.fn)
    metrics = []
    with sharding_ctx(mesh11(), bundle.rules):
        for b in batches:
            params, opt, m = fn(params, opt, as_input(b))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_np(params), opt


def _port_train(bundle, params, batches, as_input):
    opt = AdamW().init(params)
    metrics = []
    for b in batches:
        params, opt, m = bundle.fn(params, opt, as_input(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params, opt


def _attn_nodes(tree):
    """Each attention block's dict of leaves (the one holding ``bk``)."""
    if not isinstance(tree, dict):
        return []
    if "bk" in tree:
        return [tree]
    return [n for k in tree for n in _attn_nodes(tree[k])]


def _without_bk(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _without_bk(v) for k, v in tree.items() if k != "bk"}


def check_recsys_steps(got, want, tol, ties=0.0):
    """``check_steps`` on every leaf but the attention's key bias ``bk``.
    Its gradient is 0 in exact arithmetic (q·bk shifts a softmax row by a
    constant) and rounding noise in both packages, which Adam scales into
    steps of up to lr: its moments are held within ``tol`` of its block's
    ``wk`` moment scale and the param within lr a step of the
    reference's."""
    (tm, tp, to), (jm, jp, jo) = got, want
    jmo, jvo = to_np(jo.m), to_np(jo.v)
    check_steps((tm, _without_bk(tp), to._replace(m=_without_bk(to.m),
                                                  v=_without_bk(to.v))),
                (jm, _without_bk(jp), jo._replace(m=_without_bk(jmo),
                                                  v=_without_bk(jvo))),
                tol=tol, ties=ties)
    for g, w in ((to.m, jmo), (to.v, jvo)):
        for gn, wn in zip(_attn_nodes(g), _attn_nodes(w)):
            assert np.abs(gn["bk"].double().numpy() - wn["bk"]).max() <= \
                tol * np.abs(wn["wk"]).max()
    lr = sum(m["lr"] for m in jm)
    for gn, wn in zip(_attn_nodes(tp), _attn_nodes(jp)):
        assert np.abs(gn["bk"].double().numpy() - wn["bk"]).max() <= lr


def _recsys_init(ref):
    return JR.recsys_init(jax.random.PRNGKey(1), ref.model)


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_train_step_matches_reference(arch):
    """smoke_train (batch 16), 2 steps; the step updates the params and
    moments it is given in place (the reference donates them)."""
    ref, port = _pair(arch)
    shape = ref.shape("smoke_train")
    jb = JS.build_step(ref, shape, mesh11())
    tb = TS.build_step(port, port.shape("smoke_train"), device="cpu")
    assert tb.model_flops == jb.model_flops
    keys = set(jb.abstract_args[2])
    assert set(tb.meta["inputs"]) == keys
    for k, (shp, _) in tb.meta["inputs"].items():
        assert shp == jb.abstract_args[2][k].shape
    batches = [{k: v for k, v in b.items() if k in keys}
               for b in _recsys_batches(port, 16, 2)]
    p = _recsys_init(ref)
    want = _ref_train(jb, p, batches,
                      lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    tp = params_from_jax(to_np(p))
    got = _port_train(tb, tp, batches,
                      lambda b: {k: torch.as_tensor(v) for k, v in b.items()})
    check_recsys_steps(got, want, tol=1e-4,
                       ties=SASREC_TIES if arch == "sasrec" else 0.0)
    assert all(a is b for a, b in zip(_leaves(got[1]), _leaves(tp)))


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_serve_and_retrieval_match_reference(arch):
    """smoke_serve (batch 8): sigmoid outputs in (0, 1) within 1e-5;
    retrieval (2 queries over a 300-row candidate bank, top 100): the
    scores within 1e-5, the ids where the scores are apart."""
    ref, port = _pair(arch)
    p = _recsys_init(ref)
    tp = params_from_jax(to_np(p))
    batch = _recsys_batches(port, 8, 1, seed=4)[0]
    jb = JS.build_step(ref, ref.shape("smoke_serve"), mesh11())
    tb = TS.build_step(port, port.shape("smoke_serve"), device="cpu")
    assert tb.model_flops == jb.model_flops
    feed = {k: batch[k] for k in jb.abstract_args[1]}
    want = np.asarray(_ref_fn(jb, p, {k: jnp.asarray(v)
                                      for k, v in feed.items()}))
    got = tb.fn(tp, {k: torch.as_tensor(v) for k, v in feed.items()})
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)

    shape = JC.ShapeConfig("r", "retrieval", global_batch=2,
                           n_candidates=300)
    jr = JS.build_step(ref, shape, mesh11())
    tr = TS.build_step(port, TC.ShapeConfig("r", "retrieval", global_batch=2,
                                            n_candidates=300), device="cpu")
    assert tr.model_flops == jr.model_flops
    assert tr.meta["inputs"]["cand_bank"][0] == \
        jr.abstract_args[1]["cand_bank"].shape
    D = tr.meta["inputs"]["cand_bank"][0][1]
    feed = {k: batch[k][:2] for k in jr.abstract_args[1] if k in batch}
    feed["cand_bank"] = np.random.default_rng(5).standard_normal(
        (300, D)).astype(np.float32)
    ws, wi = _ref_fn(jr, p, {k: jnp.asarray(v) for k, v in feed.items()})
    gs, gi = tr.fn(tp, {k: torch.as_tensor(v) for k, v in feed.items()})
    ws, wi = np.asarray(ws), np.asarray(wi)
    assert gs.shape == ws.shape == (2, 100)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5, atol=1e-6)
    apart = np.abs(np.diff(ws, axis=1)) > 1e-5 * np.abs(ws).max()
    sep = np.concatenate([apart[:, :1], apart[:, 1:] & apart[:, :-1],
                          apart[:, -1:]], axis=1)
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(gi.numpy()[sep], wi[sep])


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------


def _graph_full(N, E, d_feat, n_classes, seed):
    g = TSYN.sbm_graph(seed, N, n_classes, d_feat, avg_degree=E / (2 * N))
    e = len(g["src"])
    pad = lambda a: np.concatenate([a, np.zeros(E - e, a.dtype)])
    return {"node_feat": g["node_feat"], "src": pad(g["src"]),
            "dst": pad(g["dst"]), "node_mask": np.ones(N, np.float32),
            "edge_mask": pad(np.ones(e, np.float32)), "labels": g["labels"]}


def _graph_mini(batch_nodes, fanout, d_feat, n_classes, seed):
    """A sampled subgraph: node features and labels gathered by node id,
    the labels of the seeds only (-1 elsewhere)."""
    g = TSYN.sbm_graph(seed, 200, n_classes, d_feat)
    csr = TSa.CSRGraph.from_edges(g["src"], g["dst"], 200)
    rng = np.random.default_rng(seed)
    sub = TSa.sample_subgraph(csr, rng.choice(200, batch_nodes,
                                              replace=False), fanout, rng)
    labels = np.full(len(sub.node_ids), -1, np.int32)
    labels[sub.seed_local] = g["labels"][sub.node_ids[sub.seed_local]]
    return {"node_feat": g["node_feat"][sub.node_ids], "src": sub.src,
            "dst": sub.dst, "node_mask": sub.node_mask,
            "edge_mask": sub.edge_mask, "labels": labels}


def _graph_batched(G_, N, E, d_feat, n_classes, seed):
    gs = [_graph_full(N, E, d_feat, n_classes, seed + i) for i in range(G_)]
    return {k: np.stack([g[k] for g in gs]) for k in gs[0]}


GNN_CELLS = {
    "smoke_graph": None,
    "mini": JC.ShapeConfig("mini", "graph_mini", batch_nodes=6,
                           fanout=(3, 2), d_feat=8),
    "batched": JC.ShapeConfig("batched", "graph_batched", n_nodes=12,
                              n_edges=40, global_batch=3, d_feat=8),
}


@pytest.mark.parametrize("cell", list(GNN_CELLS))
def test_gnn_train_step_matches_reference(cell):
    ref, port = _pair("gatedgcn")
    jshape = GNN_CELLS[cell] or ref.shape("smoke_graph")
    tshape = TC.ShapeConfig(**dataclasses.asdict(jshape))
    jb = JS.build_step(ref, jshape, mesh11())
    tb = TS.build_step(port, tshape, device="cpu")
    assert tb.model_flops == jb.model_flops
    for f, ab in zip(JG.Graph._fields, jb.abstract_args[2]):
        assert tb.meta["inputs"][f][0] == ab.shape, f
    cfg, C = jb.meta["cfg"], ref.model.n_classes
    if jshape.kind == "graph_full":
        make = lambda s: _graph_full(jshape.n_nodes, jshape.n_edges,
                                     cfg.d_feat, C, s)
    elif jshape.kind == "graph_mini":
        make = lambda s: _graph_mini(jshape.batch_nodes, jshape.fanout,
                                     cfg.d_feat, C, s)
    else:
        make = lambda s: _graph_batched(jshape.global_batch, jshape.n_nodes,
                                        jshape.n_edges, cfg.d_feat, C, s)
    batches = [make(s) for s in (1, 2)]
    assert batches[0]["node_feat"].shape == tb.meta["inputs"][
        "node_feat"][0]
    p = JG.gnn_init(jax.random.PRNGKey(2), cfg, ref.recall,
                    embed_out=min(1024, cfg.d_hidden * 8))
    want = _ref_train(jb, p, batches, lambda b: JG.Graph(
        *[jnp.asarray(b[f]) for f in JG.Graph._fields]))
    got = _port_train(tb, params_from_jax(to_np(p)), batches,
                      lambda b: TG.Graph(*[torch.as_tensor(b[f])
                                           for f in TG.Graph._fields]))
    check_steps(got, want)


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------


def test_train_loop_trains_smoke_dlrm():
    """tests/test_train_loop.py's recsys case through the port: 20 steps
    of smoke dlrm-mlperf, finite, the last losses no higher than the
    first; the first step's loss that of the reference's step from the
    same init on the same batch."""
    spec = TC.smoke_variant(TC.get_arch("dlrm-mlperf"))
    out = TTR.train_loop(spec, "smoke_train", device="cpu", steps=20,
                         n_data=256, log_every=0)
    assert np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-5:]) <= np.mean(out["losses"][:5]) + 0.05
    assert set(out["params"]["tables"]) == {f"t{i:02d}" for i in range(26)}


def test_init_params_and_make_train_data_by_family():
    """init_params gives each family's schema (a gnn at its shape's input
    width); make_train_data refuses the gnn family with ValueError("gnn"),
    as the reference's does."""
    g = TC.get_arch("gatedgcn")
    smoke = TC.smoke_variant(g)
    p = TTR.init_params(smoke, 0, "cpu", smoke.shape("smoke_graph"))
    assert p["w_in"].shape == (8, 16) and p["exit_head"]["proj"].shape == \
        (16, 128)
    with pytest.raises(ValueError, match="gnn"):
        TTR.make_train_data(g, g.shape("full_graph_sm"), 4)
    with pytest.raises(ValueError, match="gnn"):
        TTR.train_loop(smoke, "smoke_graph", device="cpu", steps=1)
    rs = TC.smoke_variant(TC.get_arch("sasrec"))
    assert set(TTR.make_train_data(rs, rs.shape("smoke_train"), 8)) == {
        "hist", "target", "label", "pos", "neg"}
