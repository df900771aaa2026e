"""The program's spans, on the torch profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
torch profiler records, and returns one shared no-op context otherwise:
spans record exactly when an operator runs a profiler, with no flag of
their own. The profiler keeps them with its host and device events on one
clock (Kineto), so a reader of its trace can charge device time and the
device's idle time to the span that launched or waited.

``SPANS`` names every span the program opens, each under its layer.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()

SPANS = (
    # serving/engine drain (EmbeddingEngine.drain)
    "engine.drain",         # the whole call
    "engine.collect",       # queue -> one stacked host batch
    "engine.upload",        # one max_batch slice of photos to the device
    "engine.superficial",   # the first N layers of one slice
    "engine.predict",       # the exit decision, back on the host
    "engine.plan",          # plan_exit_groups
    "engine.continue",      # one exit group: gather, layers to its exit, head
    "engine.to_host",       # the group's embeddings to the host
    "engine.kick_refresh",  # the device bank's async refresh kicked
    # core/store activation cache (EmbeddingStore.add_batch)
    "store.add_batch",      # the whole call
    "store.quantize_rows",  # host int4 of the embedding rows
    "store.quantize_acts",  # int4 of the cached activations
    "store.acts_to_host",   # their packed bytes and scales to the host
    "store.insert",         # the locked bookkeeping
    # models/transformer layers
    "layer.attn",           # norm1, q/k/v (biases, RoPE), flash, out, residual
    "layer.mlp",            # norm2, the SwiGLU or MoE block, residual
    "layer.kv_write",       # a layer's k/v into the caches
    "layer.pool",           # a layer's pooled state
    "layer.exit_head",      # exit_embedding
    "lm.embed",             # the token lookup
    "lm.caches",            # prefill's zeroed KV caches
    # models/transformer MLA (inside layer.attn)
    "mla.q",                # q = x W_q, RoPE on its rope part
    "mla.kv_down",          # [c_kv | k_pe] = x W_kv_a, c_kv's norm, RoPE
    "mla.latent_write",     # the tokens' latent rows into the cache
    "mla.kv_up",            # [k_nope | v] = c_kv W_kv_b (decode: absorbed)
    # models/attention KDA layers (inside layer.attn)
    "kda.proj",             # [q | k | v] = x [W_q | W_k | W_v]
    "kda.conv",             # the short convolutions, SiLU, q and k L2-normed
    "kda.gate",             # the log-decay g and beta
    "kda.chunk",            # the recurrence (prefill: the chunked kernel)
    "kda.out",              # the gated per-head RMSNorm and W_o
    "kda.state_write",      # the state and the conv tail into the caches
    # models/moe dropless layer (inside layer.mlp)
    "moe.route",            # sigmoid router, biased top-k, weights
    "moe.experts",          # the grouped GEMMs and the weighted sum
    "moe.shared",           # the shared experts' SwiGLU
    # serving/query and core/retrieval rounds
    "query.embed",          # the query tower's pass
    "query.filter",         # round 1, the store scan
    "query.verify",         # round 2
    "query.refine",         # round 3
    "query.match",          # the fine re-ranking
)


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
