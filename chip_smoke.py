#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the port's CUDA kernels
from the sources in this checkout (``nvcc``, sm_90a; the Triton rmsnorm
compiles at its first launch), holds each kernel against its plain PyTorch
version at the serving path's shapes, then serves RECALL end to end at the
full width of ``recall-imagebind`` (random weights from a seed) and checks
that every kernel ran on that path. It ends with one JSON line of kernel
measurements and one ``{"ok": true, ...}`` line. Any failed phase or
tolerance exits non-zero; without a CUDA device it exits non-zero at once.
It never imports JAX or the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, *, reps: int = 10, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def _topk_case(Q, N, E, k, *, n_valid, normalize, gen):
    import torch
    from repro_torch.core.quantize import quantize_int4
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_cuda)
    dev = "cuda"
    bank = torch.randn((N, E), generator=gen, device=dev)
    bank = bank / bank.norm(dim=1, keepdim=True)  # stored embeddings are unit
    packed, scales = quantize_int4(bank)
    del bank
    q = torch.randn((Q, E), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    s_k, i_k = retrieval_topk_int4_cuda(q, packed, scales, k,
                                        normalize=normalize, n_valid=n_valid)
    kk = min(k + 1, N)  # one more plain entry, to see the k-th entry's gap
    s_p, i_p = R.retrieval_topk_int4_reference(q, packed, scales, kk,
                                               normalize=normalize,
                                               n_valid=n_valid, block_n=65536)
    torch.cuda.synchronize()
    tol = 1e-5  # fp32 dot of unit vectors, another summation order
    err = (s_k - s_p[:, :k]).abs().max().item()
    if not err <= tol:
        _fail(f"retrieval_topk_int4 Q={Q} N={N} E={E} k={k} n_valid="
              f"{n_valid} normalize={normalize}: score err {err} > {tol}")
    # ids must agree wherever the plain scores are separated by > tol
    sp = s_p.double()
    gap = torch.full_like(sp, float("inf"))
    gap[:, 1:] = (sp[:, 1:] - sp[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], (sp[:, :-1] - sp[:, 1:]).abs())
    resolved = gap[:, :k] > tol
    if kk == k:  # no entry after the k-th: leave the last one unresolved
        resolved[:, -1] = False
    bad = (i_k.long() != i_p[:, :k].long()) & resolved
    if bad.any():
        _fail(f"retrieval_topk_int4 Q={Q} N={N} k={k}: {int(bad.sum())} ids "
              "differ at separated scores")
    return q, packed, scales, err


def check_topk(gen):
    import torch
    from repro_torch.core.quantize import dequantize_int4
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_cuda)
    # side cases first (small): scalar byte path (E/2 % 16 != 0), n_valid
    # < k, normalize=True, k at its limit
    for Q, N, E, k, nv, nz in [(37, 50_001, 1024, 64, 50_001 - 999, True),
                               (5, 3_000, 200, 1, 3_000, False),
                               (3, 100, 64, 10, 5, False),
                               (19, 9_000, 2048, 10, 8_999, True)]:
        _topk_case(Q, N, E, k, n_valid=nv, normalize=nz, gen=gen)
        print(f"  topk side case Q={Q} N={N} E={E} k={k} n_valid={nv} "
              f"normalize={nz}: ok")
    # ragged serving-size case: N not a multiple of the 4096-row chunk
    N = (1 << 20) - 777
    _, _, _, err_r = _topk_case(192, N, 1024, 10, n_valid=N - 12345,
                                normalize=False, gen=gen)
    print(f"  topk ragged Q=192 N={N} n_valid={N - 12345}: err {err_r:.3e}")
    # the serving path's shape: 64 queries x 3 granularities, 2^20 rows
    Q, N, E, k = 192, 1 << 20, 1024, 10
    q, packed, scales, err = _topk_case(Q, N, E, k, n_valid=N,
                                        normalize=False, gen=gen)
    ms = time_ms(lambda: retrieval_topk_int4_cuda(q, packed, scales, k,
                                                  n_valid=N), reps=5)
    plain_ms = time_ms(lambda: R.retrieval_topk_int4_reference(
        q, packed, scales, k, n_valid=N, block_n=65536), reps=1, trials=3)
    lib_ms = time_ms(lambda: torch.topk(q @ dequantize_int4(packed, scales).T,
                                        k), reps=1, trials=3)
    n_bytes = Q * E * 4 + N * (E // 2 + 4) + Q * k * 8
    b_ms, b_by = bound_ms(n_bytes, 2.0 * Q * N * E, "fp32")
    print(f"  topk Q={Q} N={N} E={E} k={k}: max_abs_err {err:.3e} (tol 1e-5) "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk "
          f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return {"name": "retrieval_topk_int4", "route": "cuda",
            "source": "src/repro_torch/kernels/retrieval_topk/csrc/topk_int4.cu",
            "replaces": "src/repro/kernels/retrieval_topk/kernel.py:63",
            "max_abs_err": max(err, err_r), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def _flash_case(B, Sq, Skv, H, KV, D, dtype, *, causal, window, q_offset,
                gen, tol, lse_tol):
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_fwd_reference
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_k, l_k = flash_fwd_cuda(q, k, v, **kw)
    o_p, l_p = attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (o_k.float() - o_p.float()).abs().max().item()
    lerr = (l_k - l_p).abs().max().item()
    if not (err <= tol and lerr <= lse_tol):
        _fail(f"flash_attention B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
              f"{dtype} {kw}: out err {err} (tol {tol}), lse err {lerr} "
              f"(tol {lse_tol})")
    return q, k, v, err


def check_flash(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_fwd_reference
    # f32 side cases: GQA, causal, window, q_offset, every head dim
    for B, Sq, Skv, H, KV, D, causal, window, qoff in [
            (2, 77, 130, 8, 4, 128, True, 0, 53),
            (3, 100, 100, 4, 2, 64, True, 17, 0),
            (2, 33, 257, 6, 3, 80, False, 0, 0)]:
        _flash_case(B, Sq, Skv, H, KV, D, torch.float32, causal=causal,
                    window=window, q_offset=qoff, gen=gen, tol=1e-5,
                    lse_tol=1e-5)
        print(f"  flash f32 side case B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} "
              f"D={D} causal={causal} window={window} q_offset={qoff}: ok")
    rows = []
    for tower, S, D in (("vision", 257, 80), ("text", 78, 64)):
        B, H = 64, 16
        # bf16 output: one rounding of values of |o| < 4 is < 2e-2
        q, k, v, err = _flash_case(B, S, S, H, H, D, torch.bfloat16,
                                   causal=False, window=0, q_offset=0,
                                   gen=gen, tol=2e-2, lse_tol=1e-3)
        ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=False))
        plain_ms = time_ms(lambda: attention_fwd_reference(q, k, v,
                                                           causal=False),
                           reps=2, trials=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        n_bytes = 4 * B * S * H * D * 2 + B * H * S * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * B * H * S * S * D, "bf16")
        print(f"  flash {tower} B={B} S={S} H={H} D={D} bf16: max_abs_err "
              f"{err:.3e} (tol 2e-2) kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        rows.append({"name": f"flash_attention_fwd[{tower}]", "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/csrc/"
                               "flash_fwd.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:31",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


def check_rmsnorm(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    out = {}
    for rows_, D, dtype in ((333, 1024, torch.float32), (7, 32, torch.float32),
                            (64 * 257, 1280, torch.bfloat16)):
        x = torch.randn((rows_, D), generator=gen, device="cuda").to(dtype)
        s = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(dtype)
        y_k = rmsnorm_triton(x, s, 1e-6)
        y_p = rmsnorm_reference(x, s, 1e-6)
        torch.cuda.synchronize()
        # f32: rsqrt rounding; bf16: at most one output rounding step
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        err = (y_k.float() - y_p.float()).abs().max().item()
        lim = rel * max(1.0, y_p.float().abs().max().item())
        if not err <= lim:
            _fail(f"rmsnorm ({rows_}, {D}) {dtype}: err {err} > {lim}")
        out = dict(x=x, s=s, err=err, lim=lim)
        print(f"  rmsnorm ({rows_}, {D}) {dtype}: max_abs_err {err:.3e} "
              f"(tol {lim:.3e})")
    x, s, err = out["x"], out["s"], out["err"]
    ms = time_ms(lambda: rmsnorm_triton(x, s, 1e-6), reps=20)
    plain_ms = time_ms(lambda: rmsnorm_reference(x, s, 1e-6), reps=20)
    lib_ms = time_ms(lambda: F.rms_norm(x, (x.shape[-1],), s, 1e-6), reps=20)
    n = x.numel()
    b_ms, b_by = bound_ms(2 * n * 2 + s.numel() * 2, 4.0 * n, "fp32")
    print(f"  rmsnorm {tuple(x.shape)} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {b_ms:.4f} "
          f"ms ({b_by})")
    return {"name": "rmsnorm", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:11",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def kernel_phase():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernels vs plain versions:")
    rows = [check_topk(gen)]
    rows += check_flash(gen)
    rows.append(check_rmsnorm(gen))
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the serving path, end to end
# ---------------------------------------------------------------------------


def _kernel_ops():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.retrieval_topk import ops as topk_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    return {"retrieval_topk_int4": topk_ops, "flash_attention_fwd": flash_ops,
            "rmsnorm": rms_ops}


def _reset_launches(ops) -> None:
    for m in ops.values():
        m.launches = 0
    ops["flash_attention_fwd"].launches_by_head_dim.clear()


def _read_launches(ops, cfg) -> dict:
    """Each kernel row's own count; the flash rows split by their tower's
    head dim."""
    flash = ops["flash_attention_fwd"]
    out = {"retrieval_topk_int4": ops["retrieval_topk_int4"].launches,
           "rmsnorm": ops["rmsnorm"].launches}
    dims = {tower: cfg.tower(tower).d_model // cfg.tower(tower).n_heads
            for tower in ("vision", "text")}
    if len(set(dims.values())) != 2:
        _fail(f"towers share a head dim {dims}: flash launches cannot be "
              "split by tower")
    for tower, D in dims.items():
        out[f"flash_attention_fwd[{tower}]"] = flash.launches_by_head_dim.get(
            D, 0)
    if sum(flash.launches_by_head_dim.values()) != flash.launches:
        _fail(f"flash launches {flash.launches} != per head dim "
              f"{flash.launches_by_head_dim}")
    return out


def _fp32_tree(tree):
    if isinstance(tree, dict):
        return {k: _fp32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _fan_in_d(params):
    """The same weights with the attention projections rescaled to fan-in
    d (``wq/wk/wv`` by sqrt(H/d), ``wo`` by 1/sqrt(H)): attention logits of
    O(1) instead of the init's ~80."""
    out = dict(params, towers=dict(params["towers"]))
    for name, tp in params["towers"].items():
        a = dict(tp["layers"]["attn"])
        _, d, H, _ = a["wq"].shape
        for w in ("wq", "wk", "wv"):
            a[w] = a[w] * (H / d) ** 0.5
        a["wo"] = a["wo"] / H ** 0.5
        out["towers"][name] = dict(tp, layers=dict(tp["layers"], attn=a))
    return out


def check_fp32_end_to_end(params, spec, vision, text):
    """Full-width forward of both towers (4 items each) in fp32, once through
    the kernels and once through the plain versions, compared at every exit.

    Two weight sets. On the serving weights (the reference's init) two
    correct fp32 paths part with depth: the line prints how far a one-ulp
    change of the first layer's input moves the plain path's exits, next to
    the kernels' distance. With the attention projections at fan-in d
    (``_fan_in_d``) that floor stays near 1e-6, and the kernels must agree
    within 1e-4 at every exit, which a fault in how they are wired between
    layers (layout, strides, head order) would break."""
    import dataclasses
    from unittest import mock
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.models import imagebind as IB
    from repro_torch.models import layers, transformer as T
    tol = 1e-4  # unit-norm embeddings, as the CPU parity tests hold them
    cfg32 = dataclasses.replace(spec.model, dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def exit_embs(p, modality, h0, plain):
        with mock.patch.object(T, "flash_attention", attention_reference
                               if plain else T.flash_attention), \
                mock.patch.object(layers, "rmsnorm_op", rmsnorm_reference
                                  if plain else layers.rmsnorm_op):
            pooled = IB.tower_forward(p, cfg32, spec.recall, modality, None,
                                      h_state=h0)["pooled"]
            ex = spec.recall.exit_layers(cfg32.tower(modality).n_layers)
            return T.exit_embedding(p["towers"][modality],
                                    pooled[[e - 1 for e in ex]],
                                    cfg32.norm_eps)

    res, bad = {}, {}
    with torch.no_grad():
        for weights in ("serving init", "fan-in d"):
            p = _fp32_tree(params)
            if weights == "fan-in d":
                p = _fan_in_d(p)
            for modality, items in (("vision", vision), ("text", text)):
                t = cfg32.tower(modality)
                h0 = IB._frontend(p["towers"][modality], t,
                                  torch.as_tensor(items).cuda(), torch.float32)
                ulp = torch.randint(0, 2, h0.shape, generator=gen,
                                    device="cuda") * 2.0 - 1.0
                got = exit_embs(p, modality, h0, plain=False)
                want = exit_embs(p, modality, h0, plain=True)
                moved = exit_embs(p, modality, h0 * (1 + 2.0 ** -23 * ulp),
                                  plain=True)
                if got.dtype != torch.float32 or not torch.isfinite(got).all():
                    _fail(f"fp32 {modality} forward ({weights}): dtype "
                          f"{got.dtype} or non-finite exit embeddings")
                err = (got - want).abs().amax(dim=(1, 2)).tolist()
                floor = (moved - want).abs().amax(dim=(1, 2)).tolist()
                res[(weights, modality)] = (err, floor)
                if weights == "fan-in d" and not max(err) <= tol:
                    bad[modality] = err
            del p
    torch.cuda.empty_cache()
    print("  fp32 full-width forward, kernels vs plain versions, 4 items per "
          "tower, max abs err at each exit [plain vs plain after a one-ulp "
          "change of the input]:")
    for (weights, modality), (err, floor) in res.items():
        print(f"    {weights:12s} {modality:6s} "
              + " ".join(f"{e:.1e}[{f:.1e}]" for e, f in zip(err, floor))
              + (f" (tol {tol:.0e})" if weights == "fan-in d" else
                 " (not gated: two correct paths part here)"))
    if bad:
        _fail(f"fp32 end-to-end exit embeddings on fan-in d weights, kernels "
              f"vs plain: {bad} > {tol}")


def check_calls_vs_plain(params, spec, vision, text):
    """Every kernel call of one full-width forward of both towers (4 items
    each) against its plain version on the same real activations.

    The random-init towers' attention is near one-hot (q/k weights are
    (d, H, hd) with fan-in taken as H, so logits have a std of ~80), which
    makes end-to-end outputs of two correct paths decorrelate with depth;
    the calls themselves must agree to one bf16 step of their output's
    scale."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.models import imagebind as IB
    from repro_torch.models import layers, transformer as T
    rel_tol = 2.0 ** -7
    worst, calls = {}, {}

    def both(name, kernel_fn, plain_fn):
        def run(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            scale = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item() / scale
            worst[name] = max(worst.get(name, 0.0), err)
            calls[name] = calls.get(name, 0) + 1
            if not err <= rel_tol:
                _fail(f"{name} call {calls[name]} {tuple(args[0].shape)}: "
                      f"error {err:.3e} of the output's scale > {rel_tol}")
            return got
        return run

    with torch.no_grad(), \
            mock.patch.object(T, "flash_attention",
                              both("flash_attention_fwd",
                                   flash_ops.flash_attention,
                                   attention_reference)), \
            mock.patch.object(layers, "rmsnorm_op",
                              both("rmsnorm", rms_ops.rmsnorm_op,
                                   rmsnorm_reference)):
        for modality, items in (("vision", vision), ("text", text)):
            IB.mem_embed_all_exits(params, spec.model, spec.recall, modality,
                                   torch.as_tensor(items).cuda())
    print(f"  kernel calls of a full-width forward (4 vision + 4 text items) "
          f"vs plain versions on the same activations: {calls}, worst error "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" of the output's scale (tol {rel_tol:.2e})")


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data import synthetic as SYN
    from repro_torch.launch.serve import build_service
    spec = get_arch("recall-imagebind")
    cfg = spec.model
    n_items, n_queries, k = 512, 64, 10
    print(f"serve recall-imagebind (bf16, full width; vision "
          f"{cfg.tower('vision').n_layers}L d={cfg.tower('vision').d_model}, "
          f"text {cfg.tower('text').n_layers}L d={cfg.tower('text').d_model}"
          f"): {n_items} items, {n_queries} queries, k={k}")
    data = SYN.multimodal_pairs(1, n_items, cfg)
    ops = _kernel_ops()
    _reset_launches(ops)
    t0 = time.perf_counter()
    engine, query, info = build_service(spec, n_train=256, seed=0,
                                        device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.submit_batch(np.arange(n_items), data.items["vision"])
    stats = engine.drain()
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = query.query_batch(data.items["text"][:n_queries], k=k)
    torch.cuda.synchronize()
    t_query = time.perf_counter() - t0
    launches = _read_launches(ops, cfg)

    print(f"  build_service (init, 256-item calibration, predictor fit): "
          f"{t_build:.2f} s; predictor {info['predictor']}")
    print(f"  drain: {stats.n_embedded} items in {t_drain:.3f} s = "
          f"{stats.n_embedded / t_drain:.1f} items/s, avg layers "
          f"{stats.avg_layers:.2f}/{cfg.tower('vision').n_layers}")
    n_ref = sum(r.n_refined for r in results)
    print(f"  query_batch: {n_queries} queries in {t_query:.3f} s = "
          f"{t_query / n_queries * 1e3:.2f} ms/query, {n_ref} refinements, "
          f"rounds/query {results[0].per_round_s}")
    bank = engine.store.device_bank
    print(f"  device bank: {bank.stats()}")
    print(f"  kernel launches on the serving path: {launches}")

    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        _fail(f"kernels never launched on the serving path: {missing}")
    if len(engine.store) != n_items or len(bank) != n_items:
        _fail(f"store holds {len(engine.store)} rows, bank {len(bank)}")
    for b, r in enumerate(results):
        if not (1 <= len(r.uids) <= k and np.isfinite(r.scores).all()
                and len(set(r.uids.tolist())) == len(r.uids)
                and np.all(np.diff(r.scores) <= 0)
                and np.all(np.abs(r.scores) <= 1 + 1e-3)
                and engine.store.contains(r.uids).all()):
            _fail(f"query {b}: malformed result {r.uids} {r.scores}")
    if n_ref == 0:
        _fail("no candidate was refined")
    # the device bank's scan against the host numpy scan of the same store
    qg = query.embed_query_batch(data.items["text"][:n_queries])
    qg = qg.reshape(-1, cfg.embed_dim)
    u_d, s_d = engine.store.search_batch(qg, k, impl="device")
    u_n, s_n = engine.store.search_batch(qg, k, impl="numpy")
    err = np.abs(s_d - s_n).max()
    sep = np.ones_like(s_n, bool)
    sep[:, 1:] &= np.abs(np.diff(s_n, axis=1)) > 1e-5
    sep[:, :-1] &= np.abs(np.diff(s_n, axis=1)) > 1e-5
    sep[:, -1] = False
    if not (err <= 1e-5 and np.array_equal(u_d[sep], u_n[sep])):
        _fail(f"device bank scan vs numpy scan: score err {err}")
    print(f"  device-bank scan vs numpy scan ({qg.shape[0]} queries x "
          f"{n_items} rows): max score err {err:.2e} (tol 1e-5), ids equal "
          "where separated")
    check_calls_vs_plain(engine.params, spec, data.items["vision"][:4],
                         data.items["text"][:4])
    check_fp32_end_to_end(engine.params, spec, data.items["vision"][:4],
                          data.items["text"][:4])
    profile_phase(engine, query, data.items["vision"][:64],
                  data.items["text"][n_queries:n_queries + 16])
    return launches


_LAYERS = (("flash_fwd_kernel", "attention (flash kernel)"),
           ("topk_int4", "int4 scan (top-k kernel)"),
           ("rmsnorm", "rmsnorm (Triton kernel)"),
           ("gemm", "matmul (cuBLAS)"), ("sm90_", "matmul (cuBLAS)"),
           ("nvjet", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"))


def _layer_of(kernel_name: str) -> str:
    for key, layer in _LAYERS:
        if key in kernel_name:
            return layer
    return "other (elementwise, copies, sort)"


def profile_phase(engine, query, items, texts):
    """Where the device time goes: one more drain batch and one more query
    batch under torch.profiler, device time summed by kernel and by layer,
    and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for what, fn in (
            ("drain of 64 items", lambda: (engine.submit_batch(
                np.arange(10_000, 10_000 + len(items)), items),
                engine.drain())),
            ("query_batch of 16 queries", lambda: query.query_batch(texts,
                                                                    k=10))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_layer, total = {}, 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            by_layer[_layer_of(ev.key)] = by_layer.get(_layer_of(ev.key),
                                                       0.0) + us / 1e3
            total += us / 1e3
        if total == 0.0:
            _fail(f"profiler saw no device time for the {what}")
        shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.0%})" for k, v in
                           sorted(by_layer.items(), key=lambda kv: -kv[1]))
        print(f"  profile {what}: wall {wall * 1e3:.1f} ms, device busy "
              f"{total:.1f} ms ({total / (wall * 1e3):.0%}); {shares}")
        out[what] = (wall, total, by_layer)
    return out


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    built = ", ".join(f"lib{n}.so {s:.1f}s" for n, s in build.BUILD_LOG)
    print(f"kernel build: {built or 'up to date'} "
          f"(wall {time.perf_counter() - t0:.1f}s, {build.BUILD_DIR})")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        _fail(f"no src/repro_torch next to {Path(__file__).name}: run it "
              "from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a "
              "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build_phase()
    rows = kernel_phase()
    launches = serve_phase()
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
