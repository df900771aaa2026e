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


@pytest.mark.parametrize("kw", [dict(bank_refresh="async"),
                                dict(freshness="stale"),
                                dict(search_devices=["cuda:0", "cuda:1"])],
                         ids=lambda kw: next(iter(kw)))
def test_query_engine_refuses_unported_features(service, kw):
    _, _, t_params, _ = service
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TQuery(t_params, TCFG, TRC, store=TStore(TCFG.embed_dim, device="cpu"),
               device="cpu", **kw)
