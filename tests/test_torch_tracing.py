"""The port's spans (``repro_torch.tracing``): a no-op without a profiler;
under one, every span of a drain, a query batch and a prefill recorded
inside its parent's time range, every recorded name in ``SPANS``, and the
store's bits the same with and without the profiler."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs import base as TC
from repro_torch.core import preexit as PE
from repro_torch.core.store import EmbeddingStore
from repro_torch.data.synthetic import multimodal_pairs
from repro_torch.launch.steps import build_step
from repro_torch.models import imagebind as IB
from repro_torch.models.transformer import lm_init
from repro_torch.serving.engine import EmbeddingEngine
from repro_torch.serving.query import QueryEngine

# the size of tests/test_torch_serving.py's service
CFG = TC.MEMConfig(towers=(TC.TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                           TC.TowerConfig("text", 3, 32, 2, 64, 8, 0,
                                          vocab=128)),
                   embed_dim=32)
RC = TC.RecallConfig(exit_interval=1, superficial_layers=2,
                     predictor_hidden=32, lora_rank=4, query_granularities=2)
FAMILIES = ("engine.", "store.", "layer.", "lm.", "query.", "mla.", "moe.",
            "kda.")
DRAIN_LAYERS = {"layer.attn", "layer.mlp", "layer.pool", "layer.exit_head"}
# a span -> the spans one of which must hold it (a test's own range for the
# outermost)
PARENTS = {"engine.drain": ("test.drain",),
           "store.add_batch": ("engine.drain",),
           "query.embed": ("test.query",), "query.filter": ("test.query",),
           "query.verify": ("test.query",), "query.refine": ("test.query",),
           "query.match": ("test.query",),
           "lm.embed": ("test.step",), "lm.caches": ("test.step",),
           "layer.kv_write": ("test.step",),
           "layer.exit_head": ("engine.continue", "test.step",
                               "query.embed", "query.refine")}
for _n in tracing.SPANS:
    if _n.startswith("engine.") and _n != "engine.drain":
        PARENTS[_n] = ("engine.drain",)
    elif _n.startswith("store.") and _n != "store.add_batch":
        PARENTS[_n] = ("store.add_batch",)
    elif _n in ("layer.attn", "layer.mlp", "layer.pool"):
        PARENTS[_n] = ("engine.superficial", "engine.continue", "test.step",
                       "query.embed", "query.refine")
    elif _n.startswith(("mla.", "kda.")):   # an MLA or KDA attention half
        PARENTS[_n] = ("layer.attn",)
    elif _n.startswith("moe."):     # a dropless MoE layer
        PARENTS[_n] = ("layer.mlp",)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(store):
    gen = torch.Generator().manual_seed(0)
    params = IB.mem_init(gen, CFG, RC, device="cpu")
    n_exits = len(RC.exit_layers(4))
    pred = PE.predictor_init(gen, 32, 32, n_exits, device="cpu")
    pred["b1"][-1] = 10.0   # every photo past the superficial layers
    return EmbeddingEngine(params, CFG, RC, predictor_params=pred,
                           max_batch=16, store=store, device="cpu")


def _items():
    return multimodal_pairs(1, 40, CFG).items


def _ranges(prof):
    """name -> [(start, end, thread)] of the trace's host ranges."""
    out = {}
    for e in prof.events():
        tr = e.time_range
        out.setdefault(e.name, []).append((tr.start, tr.end, e.thread))
    return out


def _check_nesting(ranges):
    ours = {n for n in ranges if n.startswith(FAMILIES)}
    assert ours <= set(tracing.SPANS), ours - set(tracing.SPANS)
    for name in ours:
        parents = [r for p in PARENTS[name] for r in ranges.get(p, [])]
        for a, b, th in ranges[name]:
            assert any(pa <= a and b <= pb and pt == th
                       for pa, pb, pt in parents), (name, PARENTS[name])
    return ours


def _store_bits(store):
    n = len(store)
    acts = {u: (p.tobytes(), s.tobytes(), shape, layer)
            for u, (p, s, shape, layer) in store._act_cache.items()}
    return (store._packed[:n].tobytes(), store._scales[:n].tobytes(),
            store._meta[:n].tobytes(), acts)


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("engine.drain") is tracing.span("layer.mlp")
    with tracing.span("engine.drain") as s:
        assert s is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("engine.drain"), record_function)


def test_span_names_are_unique_and_in_the_families():
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    assert all(n.startswith(FAMILIES) for n in tracing.SPANS)
    assert set(PARENTS) == set(tracing.SPANS)


def test_drain_and_query_spans_nest_and_leave_the_store_unchanged():
    items = _items()
    plain = _engine(EmbeddingStore(32, device="cpu"))
    plain.submit_batch(np.arange(40), items["vision"])
    plain.drain()

    traced = _engine(EmbeddingStore(32, device="cpu"))
    query = QueryEngine(traced.params, CFG, RC, store=traced.store,
                        refine_fn=traced.refine_fn(), search_impl="device",
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.submit_batch(np.arange(40), items["vision"])
        with record_function("test.drain"):
            traced.drain()
        drained = _store_bits(traced.store)
        with record_function("test.query"):
            res = query.query_batch(items["text"][:4], k=5)
        with record_function("test.query"):
            query.query(items["text"][4], k=5)
    ranges = _ranges(prof)
    ours = _check_nesting(ranges)
    want = {n for n in tracing.SPANS if n.startswith(("engine.", "store.",
                                                      "query."))}
    assert want | DRAIN_LAYERS <= ours, (want | DRAIN_LAYERS) - ours
    assert len(ranges["engine.continue"]) == \
        len(ranges["engine.to_host"]) == len(ranges["store.add_batch"]) >= 3
    assert len(ranges["engine.upload"]) == \
        len(ranges["engine.superficial"]) == 3    # 40 photos, max_batch 16
    assert sum(r.n_refined for r in res) > 0
    assert drained == _store_bits(plain.store)
    assert traced.stats.layers_executed == plain.stats.layers_executed


def test_prefill_step_spans_nest():
    spec = TC.smoke_variant(TC.get_arch("qwen2-1.5b"))
    params = lm_init(torch.Generator().manual_seed(0), spec.model,
                     spec.recall, device="cpu")
    step = build_step(spec, TC.ShapeConfig("p", "prefill", 2, 16),
                      device="cpu", pad_to=32).fn
    tokens = torch.randint(0, spec.model.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    plain = step(params, tokens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            out = step(params, tokens)
    ranges = _ranges(prof)
    ours = _check_nesting(ranges)
    want = {n for n in tracing.SPANS if n.startswith(("layer.", "lm."))}
    assert ours == want
    L = spec.model.n_layers
    for name in ("layer.attn", "layer.mlp", "layer.kv_write", "layer.pool"):
        assert len(ranges[name]) == L
    for key in ("k_cache", "v_cache", "exit_embs"):
        assert torch.equal(out[key], plain[key])


def test_mla_prefill_step_spans_nest():
    """An MLA config's prefill: the mla.* spans inside layer.attn (the
    latent write too), the moe.* spans inside the MoE layers' layer.mlp,
    and no layer.kv_write (the latent cache is written in the layer)."""
    spec = TC.smoke_variant(TC.get_arch("moonlight-16b-a3b"))
    params = lm_init(torch.Generator().manual_seed(0), spec.model,
                     spec.recall, device="cpu")
    step = build_step(spec, TC.ShapeConfig("p", "prefill", 2, 16),
                      device="cpu", pad_to=32).fn
    tokens = torch.randint(0, spec.model.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    plain = step(params, tokens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            out = step(params, tokens)
    ranges = _ranges(prof)
    ours = _check_nesting(ranges)
    want = {n for n in tracing.SPANS
            if n.startswith(("layer.", "lm.", "mla.", "moe."))}
    assert ours == want - {"layer.kv_write"}
    L, k = spec.model.n_layers, spec.model.first_k_dense
    for name in ("layer.attn", "layer.mlp", "layer.pool", "mla.q",
                 "mla.kv_down", "mla.latent_write", "mla.kv_up"):
        assert len(ranges[name]) == L
    for name in ("moe.route", "moe.experts", "moe.shared"):
        assert len(ranges[name]) == L - k
    for key in ("latent_cache", "exit_embs"):
        assert torch.equal(out[key], plain[key])


def test_kda_prefill_step_spans_nest():
    """A hybrid's prefill (kimi-linear's smoke variant: 3 KDA layers, then
    an MLA one): the kda.* spans inside the KDA layers' layer.attn, the
    mla.* spans inside the MLA layer's, once a layer each."""
    spec = TC.smoke_variant(TC.get_arch("kimi-linear-48b-a3b"))
    m = spec.model
    params = lm_init(torch.Generator().manual_seed(0), m, spec.recall,
                     device="cpu")
    step = build_step(spec, TC.ShapeConfig("p", "prefill", 2, 16),
                      device="cpu", pad_to=32).fn
    tokens = torch.randint(0, m.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    plain = step(params, tokens)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            out = step(params, tokens)
    ranges = _ranges(prof)
    ours = _check_nesting(ranges)
    want = {n for n in tracing.SPANS
            if n.startswith(("layer.", "lm.", "mla.", "moe.", "kda."))}
    assert ours == want - {"layer.kv_write"}
    n_kda = len(m.kda_layers)
    for name in ("layer.attn", "layer.mlp", "layer.pool"):
        assert len(ranges[name]) == m.n_layers
    for name in ("kda.proj", "kda.conv", "kda.gate", "kda.chunk",
                 "kda.out", "kda.state_write"):
        assert len(ranges[name]) == n_kda
    for name in ("mla.q", "mla.kv_down", "mla.latent_write", "mla.kv_up"):
        assert len(ranges[name]) == m.n_layers - n_kda
    for key in ("latent_cache", "kda_state", "conv_state", "exit_embs"):
        assert torch.equal(out[key], plain[key])
