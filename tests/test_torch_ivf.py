"""Port parity for the IVF pruned-search path: the same insert stream and
queries through the reference's index / store / query engine and the
port's (CPU tensors: the plain versions of the kernels), plus the sync
re-cluster interleavings of the port's store, enumerated."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro.core.store import EmbeddingStore as JStore
from repro.data.synthetic import clustered_sphere, multimodal_pairs
from repro.index import pruned_scan as JP
from repro.index.ivf import IVFIndex as JIndex
from repro.kernels.retrieval_topk.ops import pow2_bucket as j_pow2_bucket
from repro.models import imagebind as JIB
from repro.serving.engine import EmbeddingEngine as JEngine
from repro.serving.query import QueryEngine as JQuery
from repro_torch.configs import base as TC
from repro_torch.core.store import EmbeddingStore as TStore
from repro_torch.data.synthetic import clustered_sphere as t_clustered_sphere
from repro_torch.index import pruned_scan as TP
from repro_torch.index.ivf import IVFIndex as TIndex
from repro_torch.kernels.retrieval_topk import ops as topk_ops
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import EmbeddingEngine as TEngine
from repro_torch.serving.query import QueryEngine as TQuery

E = 32
TOL = 1e-5  # fp32 dots of unit vectors, another summation order


def _corpus(seed, n, n_centers=6):
    return clustered_sphere(np.random.default_rng(seed), n, n_centers, E,
                            spread=0.12)[0]


def _assert_same_topk(got, want, tol=TOL):
    """Scores within ``tol``; uids equal where the scores are separated."""
    (u_g, s_g), (u_w, s_w) = got, want
    assert u_g.shape == u_w.shape
    np.testing.assert_allclose(s_g, s_w, atol=tol, rtol=0)
    sep = np.ones(s_w.shape, bool)
    d = np.abs(np.diff(s_w, axis=1)) > tol
    sep[:, 1:] &= d
    sep[:, :-1] &= d
    sep[:, -1] = False
    np.testing.assert_array_equal(u_g[sep], u_w[sep])


@pytest.mark.parametrize("n,centers,spread", [(50, 4, 0.12), (300, 9, 0.03)])
def test_clustered_sphere_matches_reference(n, centers, spread):
    want = clustered_sphere(np.random.default_rng(n), n, centers, 64,
                            spread=spread)
    got = t_clustered_sphere(np.random.default_rng(n), n, centers, 64,
                             spread=spread)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m,floor", [(1, 1), (5, 10), (8192, 1), (9000, 1),
                                     (12289, 64), (21000, 1)])
def test_pow2_bucket_matches_reference(m, floor):
    assert topk_ops.pow2_bucket(m, floor=floor) == j_pow2_bucket(m,
                                                                 floor=floor)


def _stream(index_cls, data, *, auto_grow):
    """One insert/upgrade/delete stream with re-cluster jobs, driven straight
    on an index as the store's hooks drive it."""
    idx = index_cls(E, n_clusters=4, nprobe=2, seed=3, train_batch=32,
                    auto_grow=auto_grow, max_clusters=16)
    idx.ensure_capacity(512)
    dense = np.zeros((512, E), np.float32)
    n = 0
    for lo in range(0, 240, 40):             # inserts, training as they come
        rows = np.arange(lo, lo + 40)
        dense[rows] = data[rows]
        n = lo + 40
        idx.observe(data[rows])
        idx.assign_rows(rows, data[rows], n)
        if idx.needs_recluster():
            job = idx.begin_recluster(dense)
            index_cls.compute_assignments(job)
            idx.assign_rows([3, 7], data[[300, 301]], n)  # lands mid-compute
            dense[[3, 7]] = data[[300, 301]]
            idx.commit_recluster(job, n)
    for row in (5, 100, None):               # deletes: swap-with-last
        row = n - 1 if row is None else row
        idx.on_delete(row, n - 1)
        dense[row] = dense[n - 1]
        n -= 1
    idx.check_consistency(n)
    return idx, dense, n


@pytest.mark.parametrize("auto_grow", [False, True])
def test_ivf_index_matches_reference_on_one_stream(auto_grow):
    data = _corpus(0, 320)
    (ji, jd, n), (ti, td, tn) = (_stream(JIndex, data, auto_grow=auto_grow),
                                 _stream(TIndex, data, auto_grow=auto_grow))
    assert tn == n and ti.n_reclusters == ji.n_reclusters > 0
    np.testing.assert_array_equal(ti.centroids, ji.centroids)
    np.testing.assert_array_equal(ti._assign, ji._assign)
    for got, want in zip(ti.posting_lists(), ji.posting_lists()):
        np.testing.assert_array_equal(got, want)
    assert ti.stats() == ji.stats()
    if auto_grow:
        assert ti.n_grows == ji.n_grows > 0
    q = _corpus(1, 9)
    np.testing.assert_array_equal(TP.select_probes(ti.centroids, q, 3),
                                  JP.select_probes(ji.centroids, q, 3))
    np.testing.assert_array_equal(ti.candidate_rows(q, 5),
                                  ji.candidate_rows(q, 5))
    np.testing.assert_array_equal(ti.candidate_union(q), ji.candidate_union(q))
    uids = np.arange(n) + 1000
    got = TP.pruned_search_numpy(td, n, uids, ti, q, 7, nprobe=2)
    want = JP.pruned_search_numpy(jd, n, uids, ji, q, 7, nprobe=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TP.recall_at_k(got[0], want[0][:, ::-1]) == \
        JP.recall_at_k(got[0], want[0][:, ::-1]) == 1.0


def test_build_candidate_rows_matches_reference():
    rows = np.array([4, 9, 1, 0, 7, 3, 8], np.int32)
    offs = np.array([0, 2, 2, 5, 7])
    probes = np.array([[0, 2], [1, 3], [3, 1]], np.int32)
    for w in (1, 9):
        np.testing.assert_array_equal(
            TP.build_candidate_rows(rows, offs, probes, min_width=w),
            JP.build_candidate_rows(rows, offs, probes, min_width=w))


# -- the store's impl='ivf' -----------------------------------------------


def _both_stores(n=200, **ivf_kw):
    data = _corpus(2, n + 8)
    js, ts = JStore(E, capacity=8), TStore(E, capacity=8, device="cpu")
    for st in (js, ts):
        st.attach_ivf(**{"n_clusters": 5, "nprobe": 2, "min_rows": 64,
                         "train_batch": 32, **ivf_kw})
        for lo in range(0, n, 50):
            st.add_batch(np.arange(lo, lo + 50), data[lo:lo + 50],
                         np.zeros(50), np.ones(50))
        st.upgrade_batch([3, 50, 111], data[n:n + 3])
        st.delete_batch([7, 120, n - 1])
    return js, ts


@pytest.mark.parametrize("strategy", ["union", "gathered"])
@pytest.mark.parametrize("nprobe,k", [(2, 10), (1, 80), (5, 10)])
def test_store_ivf_matches_reference(strategy, nprobe, k):
    js, ts = _both_stores()
    q = _corpus(3, 11)
    counts = (topk_ops.launches, topk_ops.launches_gathered)
    want = js.search_batch(q, k, impl="ivf", nprobe=nprobe, strategy=strategy)
    got = ts.search_batch(q, k, impl="ivf", nprobe=nprobe, strategy=strategy)
    _assert_same_topk(got, want)
    assert (got[0] == -1).sum() == (want[0] == -1).sum()  # sentinel padding
    assert ts.ivf_fallbacks == js.ivf_fallbacks == 0
    ts.ivf_index.check_consistency(len(ts), ts.rows_of(ts.uids()))
    np.testing.assert_array_equal(ts.ivf_index._assign, js.ivf_index._assign)
    # CPU tensors take the plain versions: no launch is counted
    assert (topk_ops.launches, topk_ops.launches_gathered) == counts
    if nprobe == 5:  # every cluster probed: the exhaustive scan's result
        _assert_same_topk(got, ts.search_batch(q, k, impl="device"))


def test_store_dense_impls_match_reference():
    js, ts = _both_stores()
    q = _corpus(4, 6)
    for impl in ("pallas", "xla"):
        want = js.search_batch(q, 9, impl=impl)
        got = ts.search_batch(q, 9, impl=impl)
        _assert_same_topk(got, want)
    assert ts.upload_calls == js.upload_calls == 2
    assert ts.upload_bytes == js.upload_bytes == 2 * ts._dense.nbytes


def test_untrained_index_falls_back_to_the_exhaustive_scan():
    for st in (JStore(E), TStore(E, device="cpu")):
        st.attach_ivf(n_clusters=16, min_rows=1)
        st.add_batch(np.arange(8), _corpus(5, 8), np.zeros(8), np.ones(8))
        assert not st.ivf_index.trained
        u, _ = st.search_batch(_corpus(6, 2), 3, impl="ivf")
        assert u.shape == (2, 3) and st.ivf_fallbacks == 1


def test_auto_cuts_over_at_min_rows():
    ts = TStore(E, device="cpu")
    ts.attach_ivf(n_clusters=4, min_rows=64, train_batch=32)
    ts.add_batch(np.arange(40), _corpus(7, 40), np.zeros(40), np.ones(40))
    assert ts.resolve_impl("auto") == "numpy"  # a CPU store stays on numpy
    ts.device = torch.device("cuda")  # what a store put on a card resolves to
    assert ts.ivf_index.trained and ts.resolve_impl("auto") == "device"
    ts.add_batch(np.arange(40, 64), _corpus(8, 24), np.zeros(24),
                 np.ones(24))
    assert ts.resolve_impl("auto") == "ivf"
    bare = TStore(E, device="cpu")
    bare.device = torch.device("cuda")
    assert bare.resolve_impl("auto") == "device"


def test_padding_slots_are_dropped_by_retrieval():
    """k far above a probed cluster's population: the pruned scan pads with
    (uid -1, score -1e30), and speculative retrieval drops those slots."""
    from repro_torch.core.retrieval import speculative_retrieve
    data = _corpus(11, 100)
    st = TStore(E, capacity=16, device="cpu")
    st.attach_ivf(n_clusters=4, nprobe=1, min_rows=1, train_batch=64)
    st.add_batch(np.arange(100), data, np.zeros(100), np.ones(100))
    for strategy in ("union", "gathered"):
        u, s = st.search_batch(data[:1], 90, impl="ivf", strategy=strategy)
        assert (u == -1).any() and (s[u == -1] <= -1e29).all()
    res = speculative_retrieve(st, [data[0]], data[0], k=90, final_k=90,
                               impl="ivf")
    assert -1 not in res.uids.tolist() and len(res.uids) > 0


def test_serve_cli_with_ivf_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--smoke", "--device", "cpu", "--n-items", "48",
                          "--n-queries", "4", "--index", "ivf",
                          "--index-clusters", "8", "--index-min-rows", "16",
                          "--nprobe", "4", "--search-impl", "ivf"])
    assert len(results) == 4
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("ivf index:")]
    assert len(line) == 1 and "'trained': True" in line[0]
    assert "'n_unassigned': 0" in line[0] and line[0].endswith("fallbacks=0")


# -- the query engine --------------------------------------------------------

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


def test_query_engine_ivf_matches_reference():
    jp = JIB.mem_init(jax.random.PRNGKey(0), CFG, RC)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    items = multimodal_pairs(1, 48, CFG).items
    ivf = dict(index="ivf", index_clusters=4, index_min_rows=16, nprobe=2,
               search_impl="ivf")
    je = JEngine(jp, CFG, RC, policy="fixed", fixed_exit=2, max_batch=16,
                 store=JStore(CFG.embed_dim), fw_kw=dict(block_q=8, block_kv=8))
    te = TEngine(tp, TCFG, TRC, policy="fixed", fixed_exit=2, max_batch=16,
                 store=TStore(TCFG.embed_dim, device="cpu"), device="cpu")
    jq = JQuery(jp, CFG, RC, store=je.store, refine_fn=je.refine_fn(),
                fw_kw=dict(block_q=8, block_kv=8), **ivf)
    tq = TQuery(tp, TCFG, TRC, store=te.store, refine_fn=te.refine_fn(),
                device="cpu", **ivf)
    for eng in (je, te):  # the index trains on the drain's inserts
        eng.submit_batch(np.arange(48), items["vision"])
        eng.drain()
    np.testing.assert_array_equal(te.store.ivf_index._assign,
                                  je.store.ivf_index._assign)
    j_res = jq.query_batch(items["text"][:6], k=8)
    t_res = tq.query_batch(items["text"][:6], k=8)
    for jr, tr in zip(j_res, t_res):
        assert tr.n_refined == jr.n_refined
        assert sorted(tr.filtered_uids.tolist()) == \
            sorted(jr.filtered_uids.tolist())
        _assert_same_topk((tr.uids[None], tr.scores[None]),
                          (jr.uids[None], jr.scores[None]), tol=1e-4)
    assert te.store.ivf_fallbacks == je.store.ivf_fallbacks == 0
    assert tq.search_impl == "ivf"


def test_query_engine_resolves_auto_per_call():
    """'auto' follows the store as it grows past the index's min_rows."""
    tp = params_from_jax(jax.tree.map(
        np.asarray, JIB.mem_init(jax.random.PRNGKey(0), CFG, RC)))
    st = TStore(E, device="cpu")
    tq = TQuery(tp, TCFG, TRC, store=st, device="cpu", index="ivf",
                index_clusters=4, index_min_rows=64)
    assert tq.search_impl == "numpy"
    st.device = torch.device("cuda")
    st.add_batch(np.arange(32), _corpus(9, 32), np.zeros(32), np.ones(32))
    assert tq.search_impl == "device"
    st.add_batch(np.arange(32, 64), _corpus(10, 32), np.zeros(32),
                 np.ones(32))
    assert tq.search_impl == "ivf"


# -- sync re-cluster interleavings ------------------------------------------
#
# Even with the sync bank refresh, IVF re-clustering is concurrent: a job's
# compute phase holds no lock, so writers land inside it. Three actors, one
# step per schedule token: W applies the next scripted mutation; C advances
# a re-cluster job by one phase (ivf_recluster_begin under the lock, the
# unlocked compute_assignments, ivf_recluster_commit); S scans with
# impl='ivf' at nprobe = C, which also runs a due job inline when C holds
# none. After every token the posting-list contract holds, and every scan's
# (uid, score) set equals that of an oracle store replayed to the same
# mutation prefix. (The reference's R and A actors belong to the async
# refresh, which is not ported yet.)


def _script(rng):
    return [("add", np.arange(1000, 1006),
             rng.standard_normal((6, E)).astype(np.float32)),
            ("upgrade", np.array([3, 17, 29]),
             rng.standard_normal((3, E)).astype(np.float32)),
            ("delete", np.array([5, 11]), None)]


def _apply(st, m):
    kind, uids, payload = m
    if kind == "add":
        st.add_batch(uids, payload, np.zeros(len(uids)), np.ones(len(uids)))
    elif kind == "upgrade":
        st.upgrade_batch(uids, payload)
    else:
        st.delete_batch(uids)


class SyncReclusterScenario:
    def __init__(self, *, n_initial=40, n_queries=3, k=5, clusters=4, seed=0):
        rng = np.random.default_rng(seed)
        self.init = rng.standard_normal((n_initial, E)).astype(np.float32)
        self.queries = rng.standard_normal((n_queries, E)).astype(np.float32)
        self.script = _script(rng)
        self.k, self.clusters = k, clusters
        self._oracle = {}

    def build_store(self, prefix):
        st = TStore(E, capacity=8, device="cpu")
        n = len(self.init)
        st.add_batch(np.arange(n), self.init, np.zeros(n), np.ones(n))
        st.attach_ivf(n_clusters=self.clusters, nprobe=self.clusters,
                      min_rows=1, train_batch=64)
        for m in self.script[:prefix]:
            _apply(st, m)
        return st

    def scan(self, st):
        u, s = st.search_batch(self.queries, self.k, impl="ivf")
        order = np.argsort(u, axis=1, kind="stable")  # clustering-free order
        return (np.take_along_axis(u, order, axis=1),
                np.take_along_axis(s, order, axis=1))

    def oracle(self, prefix):
        if prefix not in self._oracle:
            self._oracle[prefix] = self.scan(self.build_store(prefix))
        return self._oracle[prefix]

    @staticmethod
    def check(st):
        st.ivf_index.check_consistency(len(st), st.rows_of(st.uids()))

    def run(self, tokens):
        st = self.build_store(0)
        writes, job, phase, reclusters = 0, None, 0, 0
        for t in tokens:
            if t == "W":
                _apply(st, self.script[writes])
                writes += 1
            elif t == "C":
                if phase == 0:
                    job = st.ivf_recluster_begin()
                    phase = 0 if job is None else 1
                elif phase == 1:
                    st.ivf_index.compute_assignments(job)
                    phase = 2
                else:
                    st.ivf_recluster_commit(job)
                    job, phase, reclusters = None, 0, reclusters + 1
            else:
                u, s = self.scan(st)
                want = self.oracle(writes)
                assert np.array_equal(u, want[0]) and \
                    np.array_equal(s, want[1]), (
                        f"scan after {writes} writes diverged from the "
                        f"oracle under schedule {tokens!r}")
            self.check(st)
        if job is not None:  # finish the job in flight (its lock is held)
            if phase == 1:
                st.ivf_index.compute_assignments(job)
            st.ivf_recluster_commit(job)
            reclusters += 1
            self.check(st)
        u, s = self.scan(st)
        assert np.array_equal(u, self.oracle(writes)[0]) and \
            np.array_equal(s, self.oracle(writes)[1])
        return reclusters


def _interleavings(counts):
    """Every distinct ordering of ``counts[actor]`` tokens per actor, in
    lexicographic order."""
    pool = "".join(a * c for a, c in sorted(counts.items()))
    return sorted(set("".join(p) for p in itertools.permutations(pool)))


def test_enumerated_sync_recluster_interleavings():
    scen = SyncReclusterScenario()
    # {C:3, S:3, W:3}: 9!/(3!3!3!) = 1680 schedules; stride to 168
    schedules = _interleavings({"W": 3, "S": 3, "C": 3})[::10]
    assert len(schedules) == 168
    reclusters = sum(scen.run(s) for s in schedules)
    assert reclusters > 0  # the C actor did run jobs
