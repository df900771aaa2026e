"""The recsys and GNN families' data: the port's numpy copies of
``data.synthetic`` (``criteo_like``, ``sbm_graph``, ``seq_recsys``) and of
``data.sampler`` give arrays equal to the reference's, bit for bit, on the
same seeds."""
import numpy as np
import pytest

from repro.configs import base as JC
from repro.data import sampler as JSa
from repro.data import synthetic as JS
from repro_torch.configs import base as TC
from repro_torch.data import sampler as TSa
from repro_torch.data import synthetic as TS


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "bst", "sasrec", "dien"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_recsys_data_is_bit_equal(arch, smoke):
    """At the smoke config and at the full one (its vocabularies: the
    Criteo-1TB tables, 1M-4M items), 64 examples."""
    j, t = JC.get_arch(arch), TC.get_arch(arch)
    if smoke:
        j, t = JC.smoke_variant(j), TC.smoke_variant(t)
    gen = "criteo_like" if arch == "dlrm-mlperf" else "seq_recsys"
    _same(getattr(TS, gen)(7, 64, t.model), getattr(JS, gen)(7, 64, j.model))


def test_sbm_graph_is_bit_equal():
    _same(TS.sbm_graph(3, 500, 7, 16), JS.sbm_graph(3, 500, 7, 16))
    _same(TS.sbm_graph(4, 300, 5, 8, avg_degree=3.0, homophily=0.5),
          JS.sbm_graph(4, 300, 5, 8, avg_degree=3.0, homophily=0.5))


@pytest.mark.parametrize("seeds,fanout", [(16, (3, 2)), (64, (15, 10)),
                                          (5, (4,))])
def test_sampler_is_bit_equal(seeds, fanout):
    """``CSRGraph.from_edges`` (a sparse graph: some nodes have no
    in-edge, and their sampled edges are masked), ``max_sizes`` and
    ``sample_subgraph``."""
    g = JS.sbm_graph(0, 400, 5, 8, avg_degree=1.0)
    jg = JSa.CSRGraph.from_edges(g["src"], g["dst"], 400)
    tg = TSa.CSRGraph.from_edges(g["src"], g["dst"], 400)
    _same(tg.indptr, jg.indptr)
    _same(tg.indices, jg.indices)
    deg = np.diff(jg.indptr)
    assert tg.n_nodes == jg.n_nodes == 400 and (deg == 0).any() \
        and deg[-1] > 0
    assert TSa.max_sizes(seeds, fanout) == JSa.max_sizes(seeds, fanout)
    pick = np.random.default_rng(1).choice(400, seeds, replace=False)
    want = JSa.sample_subgraph(jg, pick, fanout, np.random.default_rng(2))
    got = TSa.sample_subgraph(tg, pick, fanout, np.random.default_rng(2))
    for f in ("node_ids", "node_mask", "src", "dst", "edge_mask",
              "seed_local"):
        _same(getattr(got, f), getattr(want, f))


def test_sampler_fails_as_the_reference_at_a_trailing_isolated_node():
    """A node with no in-edge past the last edge of the CSR: the
    reference's sampler indexes one past ``indices`` and raises
    IndexError; the copy keeps that (ROADMAP C.4)."""
    src, dst = np.array([1, 2, 0]), np.array([0, 1, 2])
    for mod in (JSa, TSa):
        g = mod.CSRGraph.from_edges(src, dst, 4)
        with pytest.raises(IndexError):
            mod.sample_subgraph(g, np.array([3]), (2,),
                                np.random.default_rng(0))


def test_minibatch_lg_sizes():
    """``minibatch_lg``'s padded subgraph: 1,024 seeds, fanout (15, 10)."""
    shape = TC.get_arch("gatedgcn").shape("minibatch_lg")
    assert TSa.max_sizes(shape.batch_nodes, shape.fanout) == (169984, 168960)
