"""Port parity for the whole serving slice: the reference's params and its
trained pre-exit predictor are carried across, the same items go through
both EmbeddingEngine.drain()s and the same queries through both
QueryEngine.query_batch()es (device-bank search on both sides; the port's
runs the plain versions of its kernels on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro.configs.base import get_arch, smoke_variant
from repro.core import exits as EX
from repro.core import preexit as PE
from repro.core.quantize import dequantize_int4_np
from repro.core.store import EmbeddingStore as JStore
from repro.data.synthetic import multimodal_pairs
from repro.models import imagebind as IB
from repro.serving.engine import EmbeddingEngine as JEngine
from repro.serving.query import QueryEngine as JQuery
from repro_torch.configs import base as TC
from repro_torch.core.store import EmbeddingStore as TStore
from repro_torch.data.synthetic import multimodal_pairs as t_multimodal_pairs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.retrieval_topk import ops as topk_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import EmbeddingEngine as TEngine
from repro_torch.serving.query import QueryEngine as TQuery

# the tests/test_serving.py config (fp32)
CFG = MEMConfig(towers=(TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                        TowerConfig("text", 3, 32, 2, 64, 8, 0, vocab=128)),
                embed_dim=32)
RC = RecallConfig(exit_interval=1, superficial_layers=2, predictor_hidden=32,
                  lora_rank=4, query_granularities=2)
FW = dict(block_q=8, block_kv=8)
TCFG = TC.MEMConfig(towers=(TC.TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                            TC.TowerConfig("text", 3, 32, 2, 64, 8, 0,
                                           vocab=128)),
                    embed_dim=32)
TRC = TC.RecallConfig(exit_interval=1, superficial_layers=2,
                      predictor_hidden=32, lora_rank=4,
                      query_granularities=2)
TOL = 1e-4


@pytest.fixture(scope="module")
def service():
    key = jax.random.PRNGKey(0)
    params = IB.mem_init(key, CFG, RC)
    data = multimodal_pairs(0, 96, CFG)
    vis = jnp.asarray(data.items["vision"])
    out = IB.mem_embed_all_exits(params, CFG, RC, "vision", vis, **FW)
    labels = EX.optimal_exit_labels(out["exit_embs"], out["exit_embs"][-1])
    sup = IB.tower_forward(params, CFG, RC, "vision", vis,
                           layer_end=RC.superficial_layers, **FW)["pooled"][-1]
    predictor, _ = PE.train_predictor(key, sup, labels,
                                      n_exits=len(out["exits"]), hidden=32,
                                      steps=80)
    return (params, predictor, params_from_jax(jax.tree.map(np.asarray, params)),
            params_from_jax(jax.tree.map(np.asarray, predictor)))


def _record_inserts(store):
    seen = {}
    add = store.add_batch

    def spy(uids, embs, exit_idxs, exit_layers, **kw):
        for u, e, layer in zip(np.asarray(uids), np.asarray(embs),
                               np.asarray(exit_layers)):
            seen[int(u)] = (np.array(e, np.float32), int(layer))
        return add(uids, embs, exit_idxs, exit_layers, **kw)
    store.add_batch = spy
    return seen


def test_drain_and_query_batch_match_reference(service):
    params, predictor, t_params, t_predictor = service
    items = multimodal_pairs(1, 40, CFG).items
    js, ts = JStore(CFG.embed_dim), TStore(TCFG.embed_dim, device="cpu")
    j_seen, t_seen = _record_inserts(js), _record_inserts(ts)
    je = JEngine(params, CFG, RC, predictor_params=predictor, max_batch=16,
                 store=js, fw_kw=FW)
    te = TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                 max_batch=16, store=ts, device="cpu")
    counts = [m.launches for m in (flash_ops, topk_ops, rms_ops)]
    for eng in (je, te):
        eng.submit_batch(np.arange(40), items["vision"])
        eng.drain()
    assert sorted(t_seen) == sorted(j_seen) == list(range(40))
    layers = [j_seen[u][1] for u in range(40)]
    assert [t_seen[u][1] for u in range(40)] == layers
    assert len(set(layers)) > 1  # several exit groups were exercised
    for u in range(40):
        np.testing.assert_allclose(t_seen[u][0], j_seen[u][0], atol=TOL)
    assert te.stats.avg_layers == je.stats.avg_layers

    jq = JQuery(params, CFG, RC, store=js, refine_fn=je.refine_fn(),
                fw_kw=FW, search_impl="device")
    tq = TQuery(t_params, TCFG, TRC, store=ts, refine_fn=te.refine_fn(),
                search_impl="device", device="cpu")
    assert tq.granularities == jq.granularities
    queries = items["text"][:8]
    j_res = jq.query_batch(queries, k=10)
    t_res = tq.query_batch(queries, k=10)
    for jr, tr in zip(j_res, t_res):
        assert tr.n_refined == jr.n_refined
        assert sorted(tr.filtered_uids.tolist()) == \
            sorted(jr.filtered_uids.tolist())
        np.testing.assert_allclose(tr.scores, jr.scores, atol=TOL)
        gap = np.abs(np.diff(jr.scores)) > TOL
        sep = np.ones(len(jr.scores), bool)
        sep[1:] &= gap
        sep[:-1] &= gap
        np.testing.assert_array_equal(tr.uids[sep], jr.uids[sep])
    assert sum(r.n_refined for r in t_res) > 0
    np.testing.assert_array_equal(ts.is_fine(np.arange(40)),
                                  js.is_fine(np.arange(40)))
    # the CPU tensors took the plain versions: no kernel launched
    assert [m.launches for m in (flash_ops, topk_ops, rms_ops)] == counts


def _vision_lora(seed=3, scale=0.05):
    """A non-zero vision-tower LoRA (numpy, the reference's schema)."""
    from repro.core import plora as JP
    tcfg = IB.tower_lm_cfg(CFG.tower("vision"), CFG)
    rng = np.random.default_rng(seed)
    return {t: {k: (scale * rng.standard_normal(d.shape)).astype(np.float32)
                for k, d in ab.items()}
            for t, ab in JP.lora_schema(tcfg, RC).items()}


@pytest.mark.parametrize("policy", ["recall", "branchynet"])
def test_drain_and_query_batch_with_lora_match_reference(service, policy):
    """EmbeddingEngine(lora=) and QueryEngine(lora=None) in both packages:
    the same exits, stored embeddings, query results and upgrades; the
    LoRA reaches the superficial pass, the continuations, the BranchyNet
    exits and the refinement."""
    params, predictor, t_params, t_predictor = service
    lora = _vision_lora()
    jl, tl = jax.tree.map(jnp.asarray, lora), params_from_jax(lora)
    items = multimodal_pairs(4, 32, CFG).items
    js, ts = JStore(CFG.embed_dim), TStore(TCFG.embed_dim, device="cpu")
    j_seen, t_seen = _record_inserts(js), _record_inserts(ts)
    je = JEngine(params, CFG, RC, lora=jl, predictor_params=predictor,
                 policy=policy, max_batch=16, store=js, fw_kw=FW)
    te = TEngine(t_params, TCFG, TRC, lora=tl, predictor_params=t_predictor,
                 policy=policy, max_batch=16, store=ts, device="cpu")
    for eng in (je, te):
        eng.submit_batch(np.arange(32), items["vision"])
        eng.drain()
    assert [t_seen[u][1] for u in range(32)] == [j_seen[u][1]
                                                for u in range(32)]
    for u in range(32):
        np.testing.assert_allclose(t_seen[u][0], j_seen[u][0], atol=TOL)
    jq = JQuery(params, CFG, RC, store=js, refine_fn=je.refine_fn(),
                fw_kw=FW, search_impl="device")
    tq = TQuery(t_params, TCFG, TRC, store=ts, refine_fn=te.refine_fn(),
                search_impl="device", device="cpu")
    j_res = jq.query_batch(items["text"][:6], k=8)
    t_res = tq.query_batch(items["text"][:6], k=8)
    for jr, tr in zip(j_res, t_res):
        assert tr.n_refined == jr.n_refined
        np.testing.assert_allclose(tr.scores, jr.scores, atol=TOL)
    assert sum(r.n_refined for r in t_res) > 0
    np.testing.assert_array_equal(ts.is_fine(np.arange(32)),
                                  js.is_fine(np.arange(32)))
    # the healed suite moved the stored embeddings
    ps = TStore(TCFG.embed_dim, device="cpu")
    p_seen = _record_inserts(ps)
    plain = TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                    policy=policy, max_batch=16, store=ps, device="cpu")
    plain.submit_batch(np.arange(32), items["vision"])
    plain.drain()
    assert max(np.abs(t_seen[u][0] - p_seen[u][0]).max()
               for u in range(32)) > 1e-2


def test_build_service_hands_the_one_lora_to_both_engines(service):
    """build_service(lora=) passes the one suite to the calibration and to
    both engines, as the reference does: the text tower of the query
    engine runs the vision tower's LoRA (its first layers; here the towers
    share their widths, at recall-imagebind's full width they do not:
    ROADMAP C.4)."""
    from repro.launch.serve import build_service as j_build
    from repro_torch.configs.base import ArchSpec
    from repro_torch.launch.serve import build_service as t_build
    params, _, t_params, _ = service
    lora = _vision_lora(seed=5)
    jl, tl = jax.tree.map(jnp.asarray, lora), params_from_jax(lora)
    j_eng, j_query, j_info = j_build(
        type("S", (), {"model": CFG, "recall": RC})(), n_train=48,
        params=params, lora=jl, fw_kw=FW)
    t_eng, t_query, t_info = t_build(ArchSpec("t", "mem", TCFG, (),
                                              recall=TRC), n_train=48,
                                     params=t_params, lora=tl, device="cpu")
    assert t_eng.lora is tl and t_query.lora is tl
    np.testing.assert_array_equal(t_info["labels"], np.asarray(j_info["labels"]))
    texts = multimodal_pairs(6, 5, CFG).items["text"]
    got = t_query._all_exits(texts)
    want = np.asarray(j_query._jit_all_exits(jnp.asarray(texts)))
    np.testing.assert_allclose(got, want, atol=TOL)
    unhealed = IB.mem_embed_all_exits(params, CFG, RC, "text",
                                      jnp.asarray(texts), **FW)["exit_embs"]
    assert np.abs(np.asarray(unhealed) - got).max() > 1e-2


def test_engine_policies_and_single_query(service):
    _, _, t_params, t_predictor = service
    items = multimodal_pairs(2, 12, CFG).items
    for policy in ("full", "fixed", "branchynet"):
        eng = TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                      policy=policy, max_batch=8, device="cpu",
                      store=TStore(TCFG.embed_dim, device="cpu"))
        eng.submit_batch(np.arange(12), items["vision"])
        stats = eng.drain()
        assert stats.n_embedded == 12 and len(eng.store) == 12
    q = TQuery(t_params, TCFG, TRC, store=eng.store, refine_fn=eng.refine_fn(),
               device="cpu")
    assert q.search_impl == "numpy"  # auto on a CPU store
    r = q.query(items["text"][0], k=5)
    assert 0 < len(r.uids) <= 5 and np.all(np.diff(r.scores) <= 0)


def test_cuda_requested_without_card_raises(service):
    _, _, t_params, _ = service
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(t_params, TCFG, TRC, policy="full")


@pytest.mark.parametrize("n", [5, 40])
def test_multimodal_pairs_match_reference(n):
    for cfg, tcfg in ((CFG, TCFG),
                      (smoke_variant(get_arch("recall-imagebind")).model,
                       TC.smoke_variant(TC.get_arch("recall-imagebind")).model)):
        want = multimodal_pairs(3, n, cfg)
        got = t_multimodal_pairs(3, n, tcfg)
        assert sorted(got.items) == sorted(want.items)
        for m in want.items:
            np.testing.assert_array_equal(got.items[m], want.items[m])
        np.testing.assert_array_equal(got.difficulty, want.difficulty)


def test_serve_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--smoke", "--device", "cpu", "--n-items", "24",
                          "--n-queries", "4", "--search-impl", "device"])
    assert len(results) == 4
    out = capsys.readouterr().out
    assert "embedded 24 items" in out and "device bank:" in out


def test_serve_cli_sharded_bank_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--smoke", "--device", "cpu", "--n-items", "24",
                          "--n-queries", "4", "--search-impl", "device",
                          "--search-shards", "2"])
    assert len(results) == 4
    out = capsys.readouterr().out
    assert "'n_shards': 2" in out and "'n': 24" in out


def test_search_shards_take_the_first_cards_or_raise(monkeypatch):
    from repro_torch.launch import serve
    assert serve.search_devices("cpu", "device", 3) == ["cpu"] * 3
    assert serve.search_devices("cpu", "device", 0) is None
    assert serve.search_devices("cpu", "numpy", 2) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert serve.search_devices("cuda", "device", 2) == ["cuda:0",
                                                         "cuda:1"]
    with pytest.raises(ValueError, match="needs 3 cards, 2 visible"):
        serve.search_devices("cuda", "device", 3)


def test_query_engine_with_search_devices_matches_reference(service):
    """``QueryEngine(search_devices=...)`` shards the bank (three CPU
    shards here; the reference's over its one device) and serves the
    device scan: query_batch as the reference's and as the port's
    one-shard engine."""
    params, predictor, t_params, t_predictor = service
    items = multimodal_pairs(6, 40, CFG).items
    js = JStore(CFG.embed_dim)
    stores = [TStore(TCFG.embed_dim, device="cpu") for _ in range(2)]
    je = JEngine(params, CFG, RC, predictor_params=predictor, max_batch=16,
                 store=js, fw_kw=FW)
    tes = [TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                   max_batch=16, store=st, device="cpu") for st in stores]
    for eng in (je, *tes):
        eng.submit_batch(np.arange(40), items["vision"])
        eng.drain()
    jq = JQuery(params, CFG, RC, store=js, refine_fn=je.refine_fn(),
                fw_kw=FW, search_devices=jax.devices())
    sharded = TQuery(t_params, TCFG, TRC, store=stores[0],
                     refine_fn=tes[0].refine_fn(), search_impl="auto",
                     search_devices=["cpu"] * 3, device="cpu")
    one = TQuery(t_params, TCFG, TRC, store=stores[1],
                 refine_fn=tes[1].refine_fn(), search_impl="device",
                 device="cpu")
    assert sharded.search_impl == jq.search_impl == "device"
    assert stores[0].device_bank.n_shards == 3
    assert stores[1].device_bank.n_shards == 1
    queries = items["text"][:8]
    j_res = jq.query_batch(queries, k=10)
    for t_res in (sharded.query_batch(queries, k=10),
                  one.query_batch(queries, k=10)):
        for jr, tr in zip(j_res, t_res):
            assert tr.n_refined == jr.n_refined
            assert sorted(tr.filtered_uids.tolist()) == \
                sorted(jr.filtered_uids.tolist())
            np.testing.assert_allclose(tr.scores, jr.scores, atol=TOL)
    assert len(stores[0].device_bank) == 40


def test_engine_submit_matches_reference(service):
    """Items queued one at a time with ``submit`` drain as the reference's
    do, and as the same items queued with ``submit_batch``."""
    params, predictor, t_params, t_predictor = service
    items = multimodal_pairs(7, 12, CFG).items["vision"]
    js = JStore(CFG.embed_dim)
    ts, tb = (TStore(TCFG.embed_dim, device="cpu") for _ in range(2))
    je = JEngine(params, CFG, RC, predictor_params=predictor, store=js,
                 fw_kw=FW)
    te, tbe = (TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                       store=st, device="cpu") for st in (ts, tb))
    for u in range(12):
        je.submit(u, items[u])
        te.submit(u, items[u])
    tbe.submit_batch(np.arange(12), items)
    for eng in (je, te, tbe):
        eng.drain()
    assert te.stats.n_embedded == je.stats.n_embedded == 12
    np.testing.assert_array_equal(ts.uids(), js.uids())
    np.testing.assert_array_equal(ts.uids(), tb.uids())
    np.testing.assert_array_equal(ts.dense_matrix(), tb.dense_matrix())
    np.testing.assert_allclose(ts.dense_matrix(), js.dense_matrix(),
                               atol=TOL)
    assert [e.exit_layer for e in ts.entries] == \
        [e.exit_layer for e in js.entries]


def _drained_pair(service, n_items, seed, **query_kw):
    """The same items drained through both packages' engines, with query
    engines over the two stores (device-bank search)."""
    params, predictor, t_params, t_predictor = service
    items = multimodal_pairs(seed, n_items, CFG).items
    js, ts = JStore(CFG.embed_dim), TStore(TCFG.embed_dim, device="cpu")
    je = JEngine(params, CFG, RC, predictor_params=predictor, max_batch=16,
                 store=js, fw_kw=FW)
    te = TEngine(t_params, TCFG, TRC, predictor_params=t_predictor,
                 max_batch=16, store=ts, device="cpu")
    for eng in (je, te):
        eng.submit_batch(np.arange(n_items), items["vision"])
        eng.drain()
    jq = JQuery(params, CFG, RC, store=js, refine_fn=je.refine_fn(),
                fw_kw=FW, search_impl="device", **query_kw)
    tq = TQuery(t_params, TCFG, TRC, store=ts, refine_fn=te.refine_fn(),
                search_impl="device", device="cpu", **query_kw)
    return items, (js, je, jq), (ts, te, tq)


def test_act_cache_bytes_and_refinement_match_reference(service):
    """The drain hands the port's store its hidden states as a tensor
    (quantized by int4_cache.ops where they lie). Given the reference
    drain's own hidden states, the port's store caches the same packed
    bytes and scales, bit for bit. Through the two drains, whose hidden
    states differ in the last bits (another summation order), the packed
    bytes, shapes and layers are equal for every uid and the scales within
    1e-5 relative; the refinement hook, which dequantizes on the engine's
    device, gives the reference's fine embeddings."""
    seen = []
    add = JStore.add_batch

    def spy(self, uids, embs, exit_idxs, exit_layers, **kw):
        seen.append((np.array(uids), np.array(kw["cached_hs"])))
        return add(self, uids, embs, exit_idxs, exit_layers, **kw)

    JStore.add_batch = spy
    try:
        _, (js, je, _), (ts, te, _) = _drained_pair(service, 24, seed=4)
    finally:
        JStore.add_batch = add
    same = TStore(TCFG.embed_dim, device="cpu")
    for uids, hs in seen:
        same.add_batch(uids, np.zeros((len(uids), TCFG.embed_dim)),
                       [0] * len(uids), [1] * len(uids),
                       cached_hs=torch.from_numpy(hs))
    assert sorted(ts._act_cache) == sorted(js._act_cache) == list(range(24))
    for u in range(24):
        (pj, sj, shj, lj), (pt, st_, sht, lt) = js._act_cache[u], \
            ts._act_cache[u]
        assert np.array_equal(same._act_cache[u][0], pj)
        assert np.array_equal(same._act_cache[u][1], sj)
        assert pt.dtype == np.int8 and np.array_equal(pt, pj)
        # absmax of hidden states that differ in the last bits
        np.testing.assert_allclose(st_, sj, rtol=1e-5, atol=0)
        assert sht == shj and lt == lj
    assert ts.storage_bytes() == js.storage_bytes()
    assert ts.act_d2h_bytes == 0  # CPU tensors: nothing left a device
    uids = np.arange(0, 24, 3)
    want, got = je.refine_fn()(uids), te.refine_fn()(uids)
    assert sorted(got) == sorted(want) == uids.tolist()
    for u in uids.tolist():
        np.testing.assert_allclose(got[u], want[u], atol=TOL)
    assert te.stats.refine_h2d_bytes == 0  # nothing went to a device
    # the public accessor still returns dequantized numpy, as the reference
    for u, (h, layer) in ts.cached_activations(uids).items():
        h_j, layer_j = js.cached_activations([u])[u]
        assert layer == layer_j and h.dtype == np.float32
        assert np.array_equal(h, dequantize_int4_np(*ts._act_cache[u][:2]))
        np.testing.assert_allclose(h, h_j, rtol=1e-5, atol=0)


def test_query_batch_with_async_bank_refresh_matches_reference(service):
    """QueryEngine(bank_refresh="async", freshness="fresh") on both
    packages, each with a background refresh thread: every scan blocks for
    an epoch, so both serve what the sync engines serve, and the
    refinements' upgrades land in a later epoch. (A bound of
    max_lag_rows=0 is not enough for that under a real thread: rows an
    in-flight epoch has taken count as published, in both packages.)"""
    items, (js, _, jq), (ts, _, tq) = _drained_pair(
        service, 32, seed=5, bank_refresh="async", bank_max_lag_rows=0,
        freshness="fresh")
    try:
        assert ts.bank_refresher is not None and tq.freshness == "fresh"
        queries = items["text"][:6]
        for _ in range(2):  # the second batch scans the upgraded rows
            j_res = jq.query_batch(queries, k=10)
            t_res = tq.query_batch(queries, k=10)
            for jr, tr in zip(j_res, t_res):
                assert tr.n_refined == jr.n_refined
                assert sorted(tr.filtered_uids.tolist()) == \
                    sorted(jr.filtered_uids.tolist())
                np.testing.assert_allclose(tr.scores, jr.scores, atol=TOL)
        assert ts.bank_refresher.n_blocking == 2  # one fused scan a batch
    finally:
        js.set_bank_refresh("sync")
        ts.set_bank_refresh("sync")
    assert len(ts.device_bank) == len(ts) == 32
    np.testing.assert_array_equal(ts.is_fine(np.arange(32)),
                                  js.is_fine(np.arange(32)))


def test_serve_cli_async_refresh_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--smoke", "--device", "cpu", "--n-items", "24",
                          "--n-queries", "4", "--search-impl", "device",
                          "--bank-refresh", "async",
                          "--bank-max-lag-rows", "8"])
    assert len(results) == 4
    out = capsys.readouterr().out
    assert "bank refresh: async, epochs=" in out
