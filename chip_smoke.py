#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the port's CUDA kernels
from the sources in this checkout (one ``nvcc`` per source, all at once,
sm_90a; the Triton rmsnorm compiles at its first launch), and holds each
kernel against its plain PyTorch version at its path's shapes (the int4
activation-cache kernels bit for bit; the grouped GEMM's side cases through
both of its kernels, wgmma and mma.sync; the bf16 flash kernel against the
plain variant that rounds P to bf16 per key tile, as the TPU kernel does,
within one bf16 step of each element at max(|o|, 1); MLA's 192/128
forward, ``flash_fwd_mla``, the same way at the moonlight.prefill_8k
cell's shape and side shapes). Then it drives eleven paths, each with
every launch counter set to 0 just before it and read just after:

  * serve: RECALL end to end at the full width of ``recall-imagebind``
    (random weights from a seed): drain (the activation cache quantized on
    the card), then query_batch (exhaustive int4 scan, refinement
    dequantized on the card); afterwards one more query_batch through an
    IVF-indexed engine (the pruned union scan), and one of 16 queries
    through ``QueryEngine(search_devices=["cuda:0"] * 4)`` against the
    one-shard engine over two stores drained alike (equal bit for bit);
  * heal: P-LoRA healing of the vision tower at full width and depth
    (``core.healing.heal_tower``, batch 32, 2 steps in each of its six
    phases) through the flash-attention and RMSNorm backward kernels, which
    are first held against their plain versions and timed; one step's
    backward calls held call by call, and a step's LoRA gradient against
    autograd of plain float64 ops; RECALL served with the healed LoRA
    (drain, query_batch); ``heal_lm`` on qwen2-1.5b at full width and
    depth, one of its steps profiled, and on qwen3-moe-30b-a3b at full
    width and 16 of its 48 layers, through the grouped GEMM's dX kernel
    (whose two backward kernels are first held against their plain
    versions and float64 products, and timed);
  * train: ``launch.train.train_loop`` on qwen2-1.5b at full width and
    depth (3 steps of 8 x 4,096 tokens, 8 microbatches, remat; one
    microbatch's kernel calls, forward, recompute and backward, held call
    by call; a profiled step), a checkpoint round trip on a 2-layer qwen2
    at full width (restored bit for bit, the restarted step's loss equal to
    an uninterrupted run's), recall-imagebind's contrastive step over all
    four towers at full width (batch 256, remat, 2 steps, a profiled
    step), and qwen3-moe-30b-a3b at full width and 3 of its 48 layers (2
    ``train_loop`` steps of 8 x 4,096 tokens, remat; its first step held
    to the plain grouped-GEMM backward, one microbatch's grouped-GEMM
    backward calls to their plain versions, a profiled step);
  * IVF: a 2^17-row ``clustered_sphere`` store at E = 1024 with an online
    IVF index (256 clusters, nprobe 8), queried through both pruned
    strategies and the dense fp32 path, held against the numpy oracles and
    the exhaustive device scan;
  * async: the serving engines with ``bank_refresh="async"`` over a store
    preloaded with 2^17 rows; a writer thread inserts rows and drains
    items while a query thread scans and runs a query_batch; every policy
    read stays within the row bound, and after the refresher stops a fresh
    scan equals a sync store's scan of the same mutations, bit for bit;
  * shard: the device bank row-sharded four ways on the one card, against
    a one-shard bank, bit for bit, each scan launching once a shard: the
    exhaustive int4 scan over 2^20 rows (both timed), the union and
    gathered pruned scans on the IVF phase's configuration, the dense scan
    of a 2^18-row fp32 store, and an async refresh whose writer crosses a
    capacity doubling (rows move between shards);
  * LM: qwen2-1.5b at full width and depth (random weights from a seed)
    through ``launch.steps.build_step``: a prefill of 32 prompts of 2,048
    into a 32,768-token cache, then 32 greedy decode steps (read apart:
    the prefill's counters and the decode window's), then 8 steps over
    caches of seeded K/V filled to lengths of 16,384-32,768; then the exit
    API over 8 x 2,048 tokens (``encode_exits``; ``encode_at`` at every
    exit; ``refine_from`` two exits' cached activations, equal bit for bit
    to the full pass; exact launches; each held call by call);
  * MoE: qwen3-moe-30b-a3b at full width and 16 of its 48 layers, 16
    prompts of 1,024 into a 4,096-token cache, then 16 decode steps, with
    the expert loads and the assignments the capacity drops;
  * moonlight: moonlight-16b-a3b at full width and depth (MLA, DeepSeek-V3
    routing without drops): a prefill of 2 x 1,024 held call by call, 2
    decode steps through its latent cache, then the moonlight.prefill_8k
    cell's step (8 x 8,192), with 27 ``flash_fwd_mla`` launches and 78
    grouped GEMMs a step;
  * families: the recsys and GNN families through ``build_step`` and
    ``train_loop``. Every step kind of the five archs' smoke variants on
    the card against the CPU (1e-5 of scale); dlrm-mlperf (its five big
    tables capped at 4M rows to train, 16M to serve), bst, sasrec and
    dien at full width: a train step twice from the init (the same
    bits), 3 ``train_loop`` steps at batch 65,536, ``serve_p99``,
    ``serve_bulk`` and a 1M-candidate retrieval; gatedgcn's
    ``full_graph_sm``, ``minibatch_lg`` (sampled from a Reddit-sized SBM
    graph) and ``molecule`` steps, twice each (the same bits), and its
    exit embeddings through the RMSNorm kernel (one launch a call, held
    to the plain version);
  * mesh: the mesh and sharding layer on meshes of cuda:0 entries.
    qwen2-1.5b's bf16 params placed on (data 2, model 2) by
    ``make_shardings``, each piece its slice bit for bit, saved and
    restored by ``elastic_restore`` onto the survivors' (1, 2) mesh,
    equal bit for bit; the sequence-parallel decode at B 32 over a
    32,768-token cache split four ways, held to the decode attention
    kernel (its one launch) and the plain version; ``compressed_psum``
    and ``psum_scatter_tree`` over the full fp32 gradient tree, within
    the reference's bounds and the same bits twice; the H100 roofline of
    the qwen2 shapes the LM and train phases run.

One prefill and one decode step of each LM are held call by call against
the plain versions; the MoE prefill's grouped-GEMM launches must all run
the wgmma kernel, the decode window's all the mma.sync kernel. It ends
with one JSON line of kernel measurements (twenty-one rows: seventeen
forward rows and four backward kernels: flash attention, RMSNorm and the
grouped GEMM's dX and dW) and one ``{"ok": true, ...}``
line. Any failed phase or tolerance exits non-zero;
without a CUDA device it exits non-zero at once. It never imports JAX or
the JAX package (the moonlight phase draws its weights with the
benchmark's ``bench/lib/weights``).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


def _peaks():
    """(HBM bytes/s, {op type: peak ops/s}): the H100 SXM's published
    rates (dense, at 700 W) from ``repro_torch.launch.mesh``, the numbers
    the roofline uses too."""
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_FP32)
    return HBM_BW, {"fp32": PEAK_FLOPS_FP32, "bf16": PEAK_FLOPS_BF16}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    hbm, peak = _peaks()
    t_bytes = n_bytes / hbm * 1e3
    t_ops = n_ops / peak[op_type] * 1e3
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


def graph_time_ms(fn, *, reps: int = 20, trials: int = 5,
                  stream=None) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    the replay timed as ``time_ms`` times a call, divided by ``reps``. Set
    beside ``time_ms`` for calls whose host dispatch can outlast their
    device work (a decode step's kernels). ``stream`` is the stream to
    warm up and capture on: an autograd backward runs on its forward's
    stream, so a captured ``torch.autograd.grad`` needs its forward run on
    that stream first."""
    import torch
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=1, trials=trials) / reps
    del graph
    return ms


def dispatch_us(fn, *, calls: int = 20, trials: int = 20) -> float:
    """Host time of one call in microseconds: median over ``trials`` of the
    host wall of ``calls`` back-to-back calls over ``calls``, each trial
    started on an idle device (too few calls to fill the launch queue, so
    the host never waits on the device)."""
    import torch
    fn()
    out = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
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
    bad = (i_k.long() != i_p[:, :k].long()) & _resolved(s_p, k, tol)
    if bad.any():
        _fail(f"retrieval_topk_int4 Q={Q} N={N} k={k}: {int(bad.sum())} ids "
              "differ at separated scores")
    return q, packed, scales, err


def _resolved(s_p, k, tol):
    """(Q, k) mask of the first k plain entries whose score is separated
    by > tol from both neighbours: ids must agree there. ``s_p`` may hold
    one entry more than k, to see the k-th entry's gap; without it the
    last entry stays unresolved."""
    import torch
    sp = s_p.double()
    gap = torch.full_like(sp, float("inf"))
    gap[:, 1:] = (sp[:, 1:] - sp[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], (sp[:, :-1] - sp[:, 1:]).abs())
    resolved = gap[:, :k] > tol
    if s_p.shape[1] == k:
        resolved[:, -1] = False
    return resolved


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
    # ragged serving-size case: N and n_valid off the 128-row tile
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


def _unit(shape, gen):
    import torch
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def _gather_case(q, packed, scales, ids, k, *, n_valid, what):
    """The gathered kernel against its plain version on the same ids:
    scores within 1e-5, ids equal where separated, and the sentinel pair
    (-1e30, -1) in exactly the slots the plain version leaves dead."""
    import torch
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_gathered_cuda)
    s_k, i_k = retrieval_topk_int4_gathered_cuda(q, packed, scales, ids, k,
                                                 n_valid=n_valid)
    kk = min(k + 1, ids.shape[1])
    s_p, i_p = R.retrieval_topk_int4_gathered_reference(
        q, packed, scales, ids, kk, n_valid=n_valid, block_l=1024)
    torch.cuda.synchronize()
    tol = 1e-5  # fp32 dot of unit vectors, another summation order
    dead = s_p[:, :k] <= -1e29
    if not (torch.equal(s_k <= -1e29, dead) and (i_k[dead] == -1).all()):
        _fail(f"retrieval_topk_int4_gathered {what}: dead slots differ from "
              "the plain version's")
    err = (s_k - s_p[:, :k])[~dead].abs().max().item() if (~dead).any() \
        else 0.0
    if not err <= tol:
        _fail(f"retrieval_topk_int4_gathered {what}: score err {err} > {tol}")
    bad = (i_k.long() != i_p[:, :k].long()) & _resolved(s_p, k, tol) & ~dead
    if bad.any():
        _fail(f"retrieval_topk_int4_gathered {what}: {int(bad.sum())} ids "
              "differ at separated scores")
    return err


def check_gathered(gen):
    """The IVF per-query pruned scan: side cases, the bit-equality of its
    per-row scores with the exhaustive kernel's, and the serving shape
    (Q = 192 = 64 queries x 3 granularities, L = 8192 candidates each, from
    a 2^20-row bank). The grid rule's blocks an SM (``gather_blocks_per_sm``)
    must equal the card's occupancy query."""
    import torch
    from repro_torch.core.quantize import dequantize_int4, quantize_int4
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import (
        gather_blocks_per_sm, gather_occupancy, retrieval_topk_int4_cuda,
        retrieval_topk_int4_gathered_cuda)
    for e in (1024, 2048, 200):
        if gather_occupancy(e) != gather_blocks_per_sm(e):
            _fail(f"gathered pass 1 at E={e}: the card holds "
                  f"{gather_occupancy(e)} blocks an SM, the grid rule "
                  f"assumes {gather_blocks_per_sm(e)}")
    print(f"  gathered pass-1 blocks an SM (card = grid rule): E=1024 "
          f"{gather_blocks_per_sm(1024)}, E=2048 {gather_blocks_per_sm(2048)}")
    N, E = 1 << 20, 1024
    packed, scales = quantize_int4(_unit((N, E), gen))
    # side cases: -1 padding, ids >= n_valid, rows with fewer than k live
    # ids, L not a multiple of a group of 32, k = 64, the byte path
    # (E/2 % 16 != 0), L below one warp's 32, a query with no live id
    for Q, L, k, nv, pad, short, e_small, dead in [
            (37, 1500, 10, N - 999_999, 3, 4, None, False),
            (5, 300, 64, N, 0, 2, None, False),
            (3, 64, 10, N, 2, 1, 200, False),
            (3, 20, 10, N, 0, 1, None, True),
            (6, 2000, 16, N - 7, 4, 2, 200, True)]:
        p, sc = (packed, scales) if e_small is None else quantize_int4(
            _unit((5000, e_small), gen))
        n_rows = p.shape[0]
        nv = min(nv, n_rows)
        q = _unit((Q, p.shape[1] * 2), gen)
        ids = torch.randint(0, n_rows, (Q, L), generator=gen, device="cuda",
                            dtype=torch.int32)
        if pad:
            ids[:, ::pad] = -1
        ids[Q - short:, 5:] = -1  # fewer than k live candidates
        if dead:
            ids[0] = -1  # every candidate of query 0 dead
        _gather_case(q, p, sc, ids, k, n_valid=nv,
                     what=f"Q={Q} L={L} k={k} n_valid={nv}")
        print(f"  gathered side case Q={Q} L={L} E={p.shape[1] * 2} k={k} "
              f"n_valid={nv} pad every {pad} short rows {short} "
              f"all-dead query {dead}: ok")
    Q, L, k = 192, 8192, 10
    q = _unit((Q, E), gen)
    # one shared candidate set in id order through both kernels: the
    # exhaustive scan of the same rows returns the same floats; again with
    # query elements of 1e-39 .. 1e-45 (subnormal) and 1e-30 in every row
    rows = torch.randperm(N, generator=gen, device="cuda")[:L].sort().values
    ids = rows.int()[None].expand(Q, -1).contiguous()
    tiny = q.clone()
    tiny[:, 1::4] *= 1e-39
    tiny[:, 2::8] = 1e-45
    tiny[:, 3::16] *= 1e-30
    for qq, what in ((q, "unit queries"), (tiny, "subnormal query elements")):
        s_g, i_g = retrieval_topk_int4_gathered_cuda(qq, packed, scales, ids,
                                                     k)
        s_x, i_x = retrieval_topk_int4_cuda(qq, packed.index_select(0, rows),
                                            scales.index_select(0, rows), k)
        if not (torch.equal(s_g, s_x)
                and torch.equal(i_g, rows[i_x.long()].int())):
            _fail(f"gathered vs exhaustive int4 kernel on one candidate set "
                  f"({what}): scores or ids not bit-equal")
        print(f"  gathered vs exhaustive kernel, Q={Q}, the same {L} rows, "
              f"{what}: scores and ids bit-equal (torch.equal)")
    ids = torch.randint(0, N, (Q, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    err = _gather_case(q, packed, scales, ids, k, n_valid=N,
                       what=f"Q={Q} L={L}")
    ms = time_ms(lambda: retrieval_topk_int4_gathered_cuda(
        q, packed, scales, ids, k), reps=5)
    plain_ms = time_ms(lambda: R.retrieval_topk_int4_gathered_reference(
        q, packed, scales, ids, k, block_l=1024), reps=1, trials=3)
    lib_ms = time_ms(lambda: torch.topk(torch.bmm(
        dequantize_int4(packed[ids.long()], scales[ids.long()]),
        q[:, :, None])[..., 0], k), reps=1, trials=3)
    b_ms, b_by = gathered_bound(ids, N, E, k)
    slots = sass_slots_per_nibble("topk_int4_gather", "gather_pass1")
    print(f"  gathered Q={Q} L={L} E={E} k={k} (ids from {N} rows): "
          f"max_abs_err {err:.3e} (tol 1e-5) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, torch.topk(bmm) {lib_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of it); issue slots a "
          "nibble in the unrolled slice (SASS): "
          + (f"{slots:.2f}" if slots else "not measured"))
    return {"name": "retrieval_topk_int4_gathered", "route": "cuda",
            "source": "src/repro_torch/kernels/retrieval_topk/csrc/"
                      "topk_int4_gather.cu",
            "replaces": "src/repro/kernels/retrieval_topk/kernel.py:104",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "sass_slots_per_nibble": slots}


def sass_slots_per_nibble(lib: str, kernel: str):
    """Issue slots a nibble in the gathered scan's unrolled slice: the
    instructions from the first to the last FFMA of the longest run of
    FFMAs at most 40 instructions apart in ``kernel``'s SASS (cuobjdump of
    the built ``lib``), over the FFMAs in it, one a nibble. The per-stage
    copies and waits around the slice are not in it. None where the
    toolkit has no cuobjdump."""
    import re
    import shutil
    from repro_torch.kernels import build
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = str(build.BUILD_DIR / f"lib{lib}.so")
    try:
        sass = subprocess.run([exe, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    opcode = re.compile(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.split("\n", 1)[0]:
            continue
        ops = opcode.findall(part)
        ffma = [i for i, op in enumerate(ops) if op == "FFMA"]
        best, start = (0, 0, 0), 0
        for j in range(1, len(ffma) + 1):
            if j == len(ffma) or ffma[j] - ffma[j - 1] > 40:
                if j - start > best[0]:
                    best = (j - start, ffma[start], ffma[j - 1])
                start = j
        n, a, b = best
        return (b - a + 1) / n if n else None
    return None


def gathered_bound(ids, n_valid, E, k):
    """The gathered scan's bound on these ids: every live id one row read
    (E/2 bytes + scale + id), the queries read and the top-k written once,
    against 2 E operations a live row."""
    live = int(((ids >= 0) & (ids < n_valid)).sum())
    Q = ids.shape[0]
    n_bytes = live * (E // 2 + 4 + 4) + Q * E * 4 + Q * k * 8
    return bound_ms(n_bytes, 2.0 * live * E, "fp32")


def _dense_case(q, bank, k, *, n_valid, normalize, what):
    import torch
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import retrieval_topk_cuda
    s_k, i_k = retrieval_topk_cuda(q, bank, k, normalize=normalize,
                                   n_valid=n_valid)
    kk = min(k + 1, bank.shape[0])
    s_p, i_p = R.retrieval_topk_reference(q, bank, kk, normalize=normalize,
                                          n_valid=n_valid, block_n=65536)
    torch.cuda.synchronize()
    tol = 1e-5  # fp32 dot of unit vectors, another summation order
    err = (s_k - s_p[:, :k]).abs().max().item()
    if not err <= tol:
        _fail(f"retrieval_topk_dense {what}: score err {err} > {tol}")
    bad = (i_k.long() != i_p[:, :k].long()) & _resolved(s_p, k, tol)
    if bad.any():
        _fail(f"retrieval_topk_dense {what}: {int(bad.sum())} ids differ at "
              "separated scores")
    return err


# dense side cases: Q not a multiple of the query tile (1, 37, 193), N and
# n_valid off the 128-row tile, n_valid < k, E of 1, 41, 201 and 2048
# (E % 4 != 0 takes 4-byte copies), k 1 to 64, normalize on and off;
# ``ties`` makes 18 rows equal to query 0 across tile boundaries (250..255,
# 4090..4101; chunks are whole tiles)
DENSE_CASES = (  # Q, N, E, k, n_valid, normalize, ties
    (37, 50_001, 1024, 64, 49_002, True, False),
    (5, 3_000, 201, 1, 3_000, False, False),
    (3, 100, 64, 10, 5, False, False),
    (1, 4_500, 1024, 10, 4_321, True, False),
    (193, 9_000, 41, 16, 8_999, False, False),
    (7, 700, 1, 3, 650, True, False),
    (9, 5_000, 2048, 10, 5_000, True, False),
    (4, 9_000, 41, 10, 8_999, False, True),
    (192, 8_200, 1024, 10, 8_200, True, True))


def check_dense(gen):
    """The dense fp32 scan (search impl 'pallas'/'xla'): side cases and the
    serving shape Q = 192, N = 2^20, E = 1024, normalize off and on, with
    n_valid < N."""
    import torch
    from repro_torch.kernels.retrieval_topk import ref as R
    from repro_torch.kernels.retrieval_topk.kernel import retrieval_topk_cuda
    tied = torch.cat([torch.arange(250, 256), torch.arange(4090, 4102)])
    for Q, N, E, k, nv, nz, ties in DENSE_CASES:
        q, bank = _unit((Q, E), gen), _unit((N, E), gen)
        if ties:
            bank[tied.cuda()] = q[0]
        what = f"Q={Q} N={N} E={E} k={k} n_valid={nv} normalize={nz}"
        _dense_case(q, bank, k, n_valid=nv, normalize=nz, what=what)
        if ties:  # equal scores: the lowest ids, across tiles and chunks
            s_k, i_k = retrieval_topk_cuda(q, bank, k, normalize=nz,
                                           n_valid=nv)
            if not (torch.equal(i_k[0].cpu(), tied[:k].int())
                    and bool((s_k[0] == s_k[0, 0]).all())):
                _fail(f"retrieval_topk_dense {what}: tied rows give ids "
                      f"{i_k[0].tolist()}, want {tied[:k].tolist()}")
        print(f"  dense side case {what}" + (", tied rows" if ties else "")
              + ": ok")
    Q, N, E, k = 192, 1 << 20, 1024, 10
    q, bank = _unit((Q, E), gen), _unit((N, E), gen)
    errs = [_dense_case(q, bank, k, n_valid=nv, normalize=nz,
                        what=f"Q={Q} N={N} n_valid={nv} normalize={nz}")
            for nv, nz in ((N, False), (N - 12345, True))]
    ms = time_ms(lambda: retrieval_topk_cuda(q, bank, k, normalize=False,
                                             n_valid=N), reps=5)
    plain_ms = time_ms(lambda: R.retrieval_topk_reference(
        q, bank, k, normalize=False, n_valid=N, block_n=65536), reps=1,
        trials=3)
    lib_ms = time_ms(lambda: torch.topk(q @ bank.T, k), reps=1, trials=3)
    mm_ms = time_ms(lambda: q @ bank.T, reps=1, trials=3)
    n_bytes = N * E * 4 + Q * E * 4 + Q * k * 8
    b_ms, b_by = bound_ms(n_bytes, 2.0 * Q * N * E, "fp32")
    print(f"  dense Q={Q} N={N} E={E} k={k}: max_abs_err {max(errs):.3e} "
          f"(tol 1e-5) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.topk(q @ bank.T) {lib_ms:.3f} ms (the product alone "
          f"{mm_ms:.3f} ms), bound {b_ms:.3f} ms ({b_by})")
    return {"name": "retrieval_topk_dense", "route": "cuda",
            "source": "src/repro_torch/kernels/retrieval_topk/csrc/"
                      "topk_dense.cu",
            "replaces": "src/repro/kernels/retrieval_topk/kernel.py:29",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def _flash_case(B, Sq, Skv, H, KV, D, dtype, *, causal, window, q_offset,
                gen, lse_tol):
    """One flash case against the plain version that rounds as the kernel
    does (``kernel.plain_like_kernel``): f32 within 1e-5; bf16 (P rounded
    to bf16 before P.V, as the TPU kernel does, in both) per element within
    one bf16 step at max(|o|, 1) (``ref.bf16_step_limit``: no looser than
    2e-2 below |o| = 4, and a rounding flip at |o| >= 4 passes). Rows that
    see no key are held against the mean of V within the same limit."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (flash_fwd_cuda,
                                                            plain_like_kernel)
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         bf16_step_limit)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_k, l_k = flash_fwd_cuda(q, k, v, **kw)
    o_p, l_p = plain_like_kernel(q, k, v, **kw)
    torch.cuda.synchronize()

    def limit(want):
        if dtype == torch.float32:
            return torch.full_like(want, 1e-5, dtype=torch.float32)
        return bf16_step_limit(want)
    diff = (o_k.float() - o_p.float()).abs()
    err = diff.max().item()
    over = (diff / limit(o_p)).max().item()
    lerr = (l_k - l_p).abs().max().item()
    what = (f"flash_attention B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
            f"{dtype} {kw}")
    if not (over <= 1.0 and lerr <= lse_tol):
        _fail(f"{what}: out err {err} ({over:.3f} of its limit), lse err "
              f"{lerr} (tol {lse_tol})")
    keyless = ~attention_mask(Sq, Skv, device="cuda", **kw).any(1)
    n_keyless = int(keyless.sum())
    if n_keyless:  # the plain version's uniform softmax over Skv keys
        mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None]
        got = o_k[:, keyless].float()
        if not ((got - mean_v).abs() <= limit(mean_v)).all():
            _fail(f"{what}: rows that see no key differ from the mean of V "
                  f"by {(got - mean_v).abs().max().item()}")
    return q, k, v, err, over, n_keyless


# bf16 side cases of the wgmma kernel (128-row q tiles, 128-key tiles):
# causal with q_offset, windows below and above the tile, Sq and Skv not
# multiples of the tile, Skv below one tile, rows that see no key, GQA 6:1
# and 8:1, D 64, 80 and 128
FLASH_BF16_CASES = (  # B, Sq, Skv, H, KV, D, causal, window, q_offset
    (2, 77, 130, 12, 2, 128, True, 0, 53),
    (2, 300, 300, 32, 4, 128, True, 0, 0),
    (3, 100, 300, 6, 1, 128, True, 17, 0),
    (2, 300, 300, 8, 1, 128, True, 200, 0),
    (2, 33, 257, 6, 3, 80, False, 0, 0),
    (2, 78, 78, 16, 16, 64, False, 0, 0),
    (1, 64, 40, 2, 2, 64, True, 0, -30),     # rows before every key
    (1, 200, 50, 2, 2, 64, False, 5, 60),    # windows past every key
    (2, 150, 90, 4, 2, 80, True, 40, 70))    # both, in a mixed tile


# f32 side cases of the FMA kernel (64-row q tiles, 64-key tiles): the
# vision shape at small B (S 257 = 4 * 64 + 1, D 80), causal with q_offset
# at D 64 and 128, windows below and across tiles, GQA, rows that see no
# key
FLASH_F32_CASES = (  # B, Sq, Skv, H, KV, D, causal, window, q_offset
    (2, 257, 257, 16, 16, 80, False, 0, 0),
    (2, 77, 130, 8, 4, 128, True, 0, 53),
    (2, 100, 130, 6, 2, 64, True, 0, 30),
    (3, 100, 100, 4, 2, 64, True, 17, 0),
    (2, 150, 150, 4, 2, 80, False, 70, 0),
    (2, 33, 257, 6, 3, 80, False, 0, 0),
    (1, 64, 40, 2, 2, 64, True, 0, -30),     # rows before every key
    (1, 200, 50, 2, 2, 64, False, 5, 60),    # windows past every key
    (2, 150, 90, 4, 2, 128, True, 40, 70))   # both, in a mixed tile


def check_flash(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_fwd_cuda,
                                                            plain_like_kernel)
    # f32 side cases of the FMA kernel: the vision shape at small B, GQA,
    # causal with q_offset at every head dim, windows, rows that see no key
    for B, Sq, Skv, H, KV, D, causal, window, qoff in FLASH_F32_CASES:
        *_, err, _, n_keyless = _flash_case(
            B, Sq, Skv, H, KV, D, torch.float32, causal=causal,
            window=window, q_offset=qoff, gen=gen, lse_tol=1e-5)
        print(f"  flash f32 side case B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} "
              f"D={D} causal={causal} window={window} q_offset={qoff}: "
              f"max_abs_err {err:.3e}"
              + (f", {n_keyless} rows that see no key" if n_keyless else "")
              + ": ok")
    for B, Sq, Skv, H, KV, D, causal, window, qoff in FLASH_BF16_CASES:
        *_, err, over, n_keyless = _flash_case(
            B, Sq, Skv, H, KV, D, torch.bfloat16, causal=causal,
            window=window, q_offset=qoff, gen=gen, lse_tol=1e-3)
        print(f"  flash bf16 side case B={B} Sq={Sq} Skv={Skv} H={H} "
              f"KV={KV} D={D} causal={causal} window={window} "
              f"q_offset={qoff}: max_abs_err {err:.3e} ({over:.2f} of the "
              "per-element limit)"
              + (f", {n_keyless} rows that see no key" if n_keyless else "")
              + ": ok")
    rows = []
    # the serving path's dtypes in the bf16 config: the vision tower runs
    # fp32 activations (as the reference's promotion gives), the text tower
    # bf16
    for tower, S, D, dtype in (("vision", 257, 80, torch.float32),
                               ("text", 78, 64, torch.bfloat16)):
        B, H = 64, 16
        fp32 = dtype == torch.float32
        q, k, v, err, over, _ = _flash_case(
            B, S, S, H, H, D, dtype, causal=False, window=0, q_offset=0,
            gen=gen, lse_tol=1e-5 if fp32 else 1e-3)
        tol = "1e-5" if fp32 else f"{over:.2f} of the per-element limit"
        ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=False))
        plain_ms = time_ms(lambda: plain_like_kernel(q, k, v, causal=False),
                           reps=2, trials=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        n_bytes = 4 * B * S * H * D * (4 if fp32 else 2) + B * H * S * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * B * H * S * S * D,
                              "fp32" if fp32 else "bf16")
        print(f"  flash {tower} B={B} S={S} H={H} D={D} {dtype}: max_abs_err "
              f"{err:.3e} ({tol}) kernel {ms:.3f} ms, plain "
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


# MLA's forward (``flash_fwd_mla``: q/k 192, v 128, bf16): the
# moonlight.prefill_8k cell's shape, a ragged length (S 1,000: a partial
# last q and key tile), a small batch with q_offset and one without the
# causal mask
FLASH_MLA_CASES = (  # B, S, H, causal, q_offset
    (8, 8192, 16, True, 0),
    (2, 1000, 16, True, 0),
    (2, 77, 4, True, 51),
    (2, 300, 2, False, 0))


def _mla_case(B, S, H, causal, q_offset, gen):
    """One MLA flash case against the plain variant that rounds P as the
    kernel does, one prompt at a time (a prompt's plain scores at S 8,192
    take 4.3 GB): per element within one bf16 step at max(|o|, 1)
    (``ref.bf16_step_limit``), the lse within 1e-3."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (flash_fwd_cuda,
                                                            plain_like_kernel)
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    bf = torch.bfloat16
    q = torch.randn((B, S, H, 192), generator=gen, device="cuda").to(bf)
    k = torch.randn((B, S, H, 192), generator=gen, device="cuda").to(bf)
    v = torch.randn((B, S, H, 128), generator=gen, device="cuda").to(bf)
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    if tuple(o.shape) != (B, S, H, 128):
        _fail(f"flash_fwd_mla out {tuple(o.shape)}, not {(B, S, H, 128)}")
    err = over = lerr = 0.0
    for b in range(B):
        o_p, l_p = plain_like_kernel(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                     **kw)
        diff = (o[b:b + 1].float() - o_p.float()).abs()
        err = max(err, diff.max().item())
        over = max(over, (diff / bf16_step_limit(o_p)).max().item())
        lerr = max(lerr, (lse[b:b + 1] - l_p).abs().max().item())
        del o_p, l_p, diff
    if not (over <= 1.0 and lerr <= 1e-3):
        _fail(f"flash_fwd_mla B={B} S={S} H={H} {kw}: out err {err} "
              f"({over:.3f} of its limit), lse err {lerr} (tol 1e-3)")
    return q, k, v, err, over


def check_flash_mla(gen):
    """The MLA forward at ``FLASH_MLA_CASES``; at the cell's shape timed
    beside the plain variant (its 8 prompts in turn) and SDPA (a backend
    that takes a v head dim other than q's; the math backend is left out:
    its scores of 8 prompts take 34 GB)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.kernel import (flash_fwd_cuda,
                                                            plain_like_kernel)
    row = None
    for B, S, H, causal, qoff in FLASH_MLA_CASES:
        q, k, v, err, over = _mla_case(B, S, H, causal, qoff, gen)
        print(f"  flash_fwd_mla B={B} S={S} H={H} causal={causal} "
              f"q_offset={qoff}: max_abs_err {err:.3e} ({over:.2f} of the "
              "per-element limit): ok")
        if row is not None:
            del q, k, v
            continue
        ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=True), reps=5)
        plain_ms = time_ms(lambda: [plain_like_kernel(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
            for b in range(B)], reps=1, trials=2)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        try:
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), reps=5)
        except RuntimeError as e:   # a yardstick only: report it
            print(f"  SDPA refused the MLA shape: "
                  f"{str(e).splitlines()[0][:160]}")
            lib_ms = None
        n_bytes = B * S * H * (2 * 192 + 2 * 128) * 2 + B * H * S * 4
        n_ops = 2.0 * B * H * S * (S + 1) / 2 * (192 + 128)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
        print(f"  flash_fwd_mla (moonlight.prefill_8k) B={B} S={S} H={H} "
              f"q/k 192, v 128, bf16 causal: kernel {ms:.4f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
              "sdpa " + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                         "n/a") + f", bound {b_ms:.4f} ms ({b_by})")
        row = {"name": "flash_attention_fwd[mla_prefill]", "route": "cuda",
               "source": "src/repro_torch/kernels/flash_attention/csrc/"
                         "flash_fwd.cu",
               "replaces": "none (models/transformer.py MLA attention)",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return row


# the KDA chunked kernel: kimi_linear.prefill_16k's shape (B 4, S 16,384,
# 32 heads of 128), a ragged S with an initial state, and strong decay
# (A_log = log 16: Gamma over a chunk passes -1000)
KDA_CASES = [(4, 16384, 32, 0.0, False), (1, 1000, 4, -4.0, True),
             (2, 300, 8, math.log(16), False)]


def _kda_inputs(B, S, H, a_log, init, gen):
    """q, k L2-normed and v in bf16, g = -exp(a_log) softplus(N(0, 1)) and
    beta = sigmoid(N(0, 1)) in fp32, an fp32 initial state or None."""
    import torch
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = F.normalize(r(B, S, H, 128), dim=-1).bfloat16()
    k = F.normalize(r(B, S, H, 128), dim=-1).bfloat16()
    v = r(B, S, H, 128).bfloat16()
    g = -math.exp(a_log) * F.softplus(r(B, S, H, 128))
    beta = torch.sigmoid(r(B, S, H))
    return q, k, v, g, beta, (r(B, H, 128, 128) if init else None)


def check_kda(gen):
    """The KDA chunked kernel at ``KDA_CASES`` against the plain chunked
    version (``kda/ref.kda_chunked`` with ``tf32``: the kernel's
    arithmetic in torch, its products' operands rounded to TF32 as the
    tensor cores take them): o within two bf16 steps of the largest |o|
    (each side sums in fp32 in its own order and rounds once to bf16), the
    final state within 1e-3 relative (fp32 over S / 64 chunk steps in
    another order, an operand on either side of a TF32 rounding boundary
    one TF32 step apart); the same bits on two launches; at the cell's
    shape timed beside the plain version."""
    import torch
    from repro_torch.kernels.kda.kernel import kda_fwd_cuda
    from repro_torch.kernels.kda.ref import kda_chunked
    row = None
    for B, S, H, a_log, init in KDA_CASES:
        q, k, v, g, beta, s0 = _kda_inputs(B, S, H, a_log, init, gen)
        kw = dict(scale=128 ** -0.5, initial_state=s0)
        o, st = kda_fwd_cuda(q, k, v, g, beta, **kw)
        o2, st2 = kda_fwd_cuda(q, k, v, g, beta, **kw)
        if not (torch.equal(o, o2) and torch.equal(st, st2)):
            _fail(f"kda_fwd B={B} S={S} H={H}: two launches differ")
        po, pst = kda_chunked(q, k, v, g, beta, tf32=True, **kw)
        err = (o.float() - po.float()).abs().max().item()
        lim = 2.0 ** -7 * po.float().abs().max().item()
        rel = (torch.linalg.vector_norm(st - pst)
               / torch.linalg.vector_norm(pst)).item()
        print(f"  kda_fwd B={B} S={S} H={H} A_log={a_log:.2f} "
              f"init={init}: o max_abs_err {err:.3e} ({err / lim:.2f} of "
              f"the limit), state rel {rel:.3e}, same bits twice")
        if err > lim or rel > 1e-3:
            _fail(f"kda_fwd B={B} S={S} H={H}: o {err:.3e} (limit "
                  f"{lim:.3e}), state {rel:.3e} (limit 1e-3)")
        if row is not None:
            continue
        ms = time_ms(lambda: kda_fwd_cuda(q, k, v, g, beta, **kw), reps=5)
        plain_ms = time_ms(lambda: kda_chunked(q, k, v, g, beta, tf32=True,
                                               **kw), reps=1, trials=2)
        n = B * S * H
        n_bytes = n * (4 * 128 * 2 + 128 * 4 + 4) + B * H * 128 * 128 * 4
        n_ops = 6.0 * n * 128 * 128
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
        print(f"  kda_fwd (kimi_linear.prefill_16k) B={B} S={S} H={H} "
              f"dk = dv 128: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        row = {"name": "kda_fwd[kimi_linear_prefill]", "route": "cuda",
               "source": "src/repro_torch/kernels/kda/csrc/kda_fwd.cu",
               "replaces": "none (models/attention.py KDA)",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del q, k, v, g, beta, o, o2, po
        torch.cuda.empty_cache()
    return row


def check_rmsnorm(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    out = {}
    # last, the serving path's largest call: the vision tower's fp32
    # activations (64 items x 257 tokens) with the bf16 config's scale; the
    # text tower's is bf16 (64 queries x 78 tokens)
    for rows_, D, dtype, s_dtype in (
            (333, 1024, torch.float32, torch.float32),
            (7, 32, torch.float32, torch.float32),
            (64 * 78, 1024, torch.bfloat16, torch.bfloat16),
            (64 * 257, 1280, torch.float32, torch.bfloat16)):
        x = torch.randn((rows_, D), generator=gen, device="cuda").to(dtype)
        s = (1 + 0.1 * torch.randn((D,), generator=gen,
                                   device="cuda")).to(s_dtype)
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
    s_x = s.to(x.dtype)  # F.rms_norm wants the weight in x's dtype
    lib_ms = time_ms(lambda: F.rms_norm(x, (x.shape[-1],), s_x, 1e-6),
                     reps=20)
    n = x.numel()
    b_ms, b_by = bound_ms(2 * n * 4 + s.numel() * 2, 4.0 * n, "fp32")
    print(f"  rmsnorm {tuple(x.shape)} fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {b_ms:.4f} "
          f"ms ({b_by})")
    return {"name": "rmsnorm", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:11",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def _int4_rows(gen, N, D, dtype):
    """N rows of width D: row 0 all zero (scale 1e-12), row 1 of absmax 7
    (scale exactly 1) holding the ties +-0.5, +-1.5, +-2.5, -3.5."""
    import torch
    x = (torch.randn((N, D), generator=gen, device="cuda") * 3).to(dtype)
    x[0] = 0
    if N > 1 and D >= 8:
        x[1] = 0
        x[1, :8] = torch.tensor([7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -3.5])
    return x


def _int4_tie_rows(gen, N, D):
    """N rows of width D whose quotients x / scale sit within 4 ulps of the
    rounding ties k + 1/2 (k = -7 .. 6), at a scale of its own a row (e^-20
    .. e^20): element 0 is the row's absmax 7 s_t, every other element
    RN((k + 1/2) s) moved by -4 .. 4 ulps, s = RN(RN(7 s_t) / 7) the scale
    the quantize computes. Which side of a tie each lands on rests on the
    last bit of the quotient."""
    import torch
    s_t = torch.empty((N, 1), device="cuda").uniform_(-20, 20,
                                                      generator=gen).exp()
    amax = s_t * 7
    s = torch.clamp_min(amax / torch.tensor(7.0, device="cuda"), 1e-12)
    k = torch.randint(-7, 7, (N, D), generator=gen, device="cuda") + 0.5
    step = torch.randint(-4, 5, (N, D), generator=gen, device="cuda",
                         dtype=torch.int32)
    x = ((k * s).view(torch.int32) + step).view(torch.float32)
    x[:, 0] = amax[:, 0]
    return x


def check_int4_cache(gen):
    """The activation-cache quantize and dequantize against their plain
    versions, bit for bit (torch.equal), and the quantize against the
    host's ``quantize_int4_np``, in the edge cases and at the serving
    path's shapes: the drain's (64 items x 257 tokens, 1280) f32
    hidden states and the refinement's dequantize of as many rows. Each
    case's quantize path (registers or looped) must be the one
    ``kernel.quant_path`` predicts."""
    import numpy as np
    import torch
    from repro_torch.core.quantize import quantize_int4_np
    from repro_torch.kernels.int4_cache.kernel import (int4_dequant_cuda,
                                                       int4_quant_cuda,
                                                       quant_path,
                                                       quant_path_cuda)
    from repro_torch.kernels.int4_cache.ref import (
        dequantize_int4_reference, quantize_int4_reference)

    def case(N, D, dtype, offset=0):
        x = _int4_rows(gen, N, D, dtype)
        if offset:  # x starts `offset` elements into its storage
            buf = torch.empty(N * D + offset, dtype=dtype, device="cuda")
            buf[offset:] = x.reshape(-1)
            x = buf[offset:].view(N, D)
        path = quant_path(D, dtype, aligned=x.data_ptr() % 16 == 0)
        if quant_path_cuda(x) != path:
            _fail(f"int4_quant ({N}, {D}) {dtype} offset {offset}: the card "
                  f"takes the {quant_path_cuda(x)} path, kernel.quant_path "
                  f"says {path}")
        p, s = int4_quant_cuda(x)
        p_p, s_p = quantize_int4_reference(x)
        ys = [(int4_dequant_cuda(p, s, out),
               dequantize_int4_reference(p_p, s_p, dtype=out))
              for out in (torch.float32, torch.bfloat16)]
        torch.cuda.synchronize()
        if not (torch.equal(p, p_p) and torch.equal(s, s_p)):
            _fail(f"int4_quant ({N}, {D}) {dtype}: not bit-equal with the "
                  "plain version")
        p_np, s_np = quantize_int4_np(x.float().cpu().numpy())
        if not (np.array_equal(p.cpu().numpy(), p_np)
                and np.array_equal(s.cpu().numpy(), s_np)):
            _fail(f"int4_quant ({N}, {D}) {dtype}: not bit-equal with the "
                  "host's quantize_int4_np")
        if not all(torch.equal(y, y_p) for y, y_p in ys):
            _fail(f"int4_dequant ({N}, {D}): not bit-equal with the plain "
                  "version")
        if N > 1 and D >= 8 and not (
                s[1].item() == 1.0 and s[0].item() == torch.tensor(
                    1e-12).item() and ys[0][0][1, :8].tolist()
                == [7, 0, 2, 2, 0, -2, -2, -4]):
            _fail(f"int4 ({N}, {D}) {dtype}: ties or the zero row wrong")
        return x, p, s, path

    # register path: N off the 8 rows a block (333, 13), a partial pair of
    # 128-element blocks (1032 f32), the widest rows (1536 f32, 3072 bf16);
    # looped path: D % 8 != 0 (2, 10), rows wider than the registers hold
    # (1544 f32, 3080 bf16), x not 16-byte aligned
    for N, D, dtype, offset in (
            (1, 1280, torch.float32, 0), (333, 1280, torch.float32, 0),
            (4097, 1280, torch.bfloat16, 0), (7, 2, torch.float32, 0),
            (65, 10, torch.bfloat16, 0), (13, 1280, torch.bfloat16, 0),
            (7, 1032, torch.float32, 0), (9, 1536, torch.float32, 0),
            (11, 3072, torch.bfloat16, 0), (9, 1544, torch.float32, 0),
            (5, 3080, torch.bfloat16, 0), (6, 1280, torch.float32, 2),
            (64 * 257, 1280, torch.bfloat16, 0)):
        path = case(N, D, dtype, offset)[3]
        print(f"  int4_cache side case ({N}, {D}) {dtype} offset {offset}: "
              f"{path} path; quant and dequant (f32, bf16 out) bit-equal")
    # quotients at the rounding ties, a scale of their own a row
    x = _int4_tie_rows(gen, 4096, 1280)
    p, s = int4_quant_cuda(x)
    p_p, s_p = quantize_int4_reference(x)
    p_np, s_np = quantize_int4_np(x.cpu().numpy())
    if not (torch.equal(p, p_p) and torch.equal(s, s_p)
            and np.array_equal(p.cpu().numpy(), p_np)
            and np.array_equal(s.cpu().numpy(), s_np)):
        _fail("int4_quant at the rounding ties: not bit-equal with the plain "
              "version and quantize_int4_np")
    # a row holding infinities (its scale is inf): the finite elements
    # quantize to 0 as x / inf does; the infinities themselves (inf / inf)
    # are left out, their NaN's integer conversion differs by platform
    x = _int4_rows(gen, 9, 1280, torch.float32)
    x[3, 5], x[3, 700] = float("inf"), -float("inf")
    p, s = int4_quant_cuda(x)
    p_p, s_p = quantize_int4_reference(x)
    lo, hi = (p.int() << 28) >> 28, p.int() >> 4
    lo_p, hi_p = (p_p.int() << 28) >> 28, p_p.int() >> 4
    finite = torch.isfinite(x)
    if not (torch.equal(s, s_p) and torch.equal(lo[finite[:, 0::2]],
                                                lo_p[finite[:, 0::2]])
            and torch.equal(hi[finite[:, 1::2]], hi_p[finite[:, 1::2]])):
        _fail("int4_quant of a row holding infinities: scales or the finite "
              "elements' nibbles differ from the plain version")
    print("  int4_quant at the rounding ties (4096 rows at scales e^-20 .. "
          "e^20, +-4 ulps) and on a row holding infinities: bit-equal")
    N, D = 64 * 257, 1280
    x, p, s, _ = case(N, D, torch.float32)
    q_ms = time_ms(lambda: int4_quant_cuda(x), reps=20)
    q_graph = graph_time_ms(lambda: int4_quant_cuda(x))
    q_host = dispatch_us(lambda: int4_quant_cuda(x))
    q_plain = time_ms(lambda: quantize_int4_reference(x), reps=5)
    d_ms = time_ms(lambda: int4_dequant_cuda(p, s), reps=20)
    d_plain = time_ms(lambda: dequantize_int4_reference(p, s), reps=5)
    # each input read once, each output written once; ops: abs + max,
    # divide, round, clamp per element (quant), and a multiply (dequant)
    q_b, q_by = bound_ms(N * D * 4 + N * D // 2 + N * 4, 5.0 * N * D, "fp32")
    d_b, d_by = bound_ms(N * D // 2 + N * 4 + N * D * 4, 1.0 * N * D, "fp32")
    print(f"  int4_quant ({N}, {D}) f32: bit-equal; kernel {q_ms:.4f} ms "
          f"(graph replay {q_graph:.4f}, host {q_host:.1f} us a call), "
          f"plain {q_plain:.4f} ms, bound {q_b:.4f} ms ({q_by}, "
          f"{q_b / q_ms:.0%} of it)")
    print(f"  int4_dequant ({N}, {D // 2}) -> f32: bit-equal; kernel "
          f"{d_ms:.4f} ms, plain {d_plain:.4f} ms, bound {d_b:.4f} ms "
          f"({d_by})")
    src = "src/repro_torch/kernels/int4_cache/csrc/int4_cache.cu"
    return [{"name": "int4_quant", "route": "cuda", "source": src,
             "replaces": "src/repro/kernels/int4_cache/kernel.py:25",
             "max_abs_err": 0.0, "ms": q_ms, "plain_ms": q_plain,
             "bound_ms": q_b, "bound_by": q_by, "library_ms": None,
             "graph_ms": q_graph, "host_us": q_host},
            {"name": "int4_dequant", "route": "cuda", "source": src,
             "replaces": "src/repro/kernels/int4_cache/kernel.py:37",
             "max_abs_err": 0.0, "ms": d_ms, "plain_ms": d_plain,
             "bound_ms": d_b, "bound_by": d_by, "library_ms": None}]


def _decode_case(B, S, H, KV, D, dtype, *, window, lengths, gen):
    import torch
    from repro_torch.kernels.decode_attention.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    lens = lengths if isinstance(lengths, torch.Tensor) else torch.tensor(
        lengths, dtype=torch.int32, device="cuda")
    o_k = decode_attn_cuda(q, k, v, lens, window=window)
    o_p = decode_attention_reference(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    # f32: another summation order. bf16: both round the same fp32 result
    # once, so they differ by at most one bf16 step of the largest output,
    # 2^-7 of it; a split merged with the wrong weight or a dropped tile
    # moves the output by a fraction of itself and fails
    tol = 1e-5 if dtype == torch.float32 else \
        2.0 ** -7 * o_p.float().abs().max().item()
    err = (o_k.float() - o_p.float()).abs().max().item()
    if not err <= tol:
        _fail(f"decode_attention B={B} S={S} H={H} KV={KV} D={D} {dtype} "
              f"window={window}: err {err} > {tol}")
    return q, k, v, lens, err, tol


def check_decode(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    bf16, f32 = torch.bfloat16, torch.float32
    # side cases: lengths 1 and S, a window, G = 1 (MHA, moonshot's
    # shape), f32 and bf16, S not a multiple of the 32-key tile, a
    # sequence with no valid position
    for B, S, H, KV, D, dtype, window, lengths in (
            (3, 1000, 8, 2, 128, bf16, 0, (1, 1000, 517)),
            (2, 4096, 12, 2, 128, bf16, 1000, (4096, 2500)),
            (4, 2000, 16, 16, 128, bf16, 0, (2000, 1999, 33, 1024)),
            (2, 777, 32, 4, 128, f32, 0, (777, 300)),
            (2, 90, 6, 1, 64, f32, 7, (0, 90))):
        _decode_case(B, S, H, KV, D, dtype, window=window, lengths=lengths,
                     gen=gen)
        print(f"  decode side case B={B} S={S} H={H} KV={KV} D={D} {dtype} "
              f"window={window} lengths={lengths}: ok")
    rows = []
    # the decode paths' shapes: qwen2-1.5b's long-context window and
    # qwen3-moe's 4,096 cache
    for arch, B, S, H, KV, lo in (("qwen2-1.5b", 32, 32768, 12, 2, 16384),
                                  ("qwen3-moe-30b-a3b", 16, 4096, 32, 4,
                                   1024)):
        D = 128
        lens = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda",
                             dtype=torch.int32)
        q, k, v, lens, err, tol = _decode_case(B, S, H, KV, D, bf16,
                                               window=0, lengths=lens,
                                               gen=gen)
        # eager times (``ms``, ``library_ms``), with graph replays beside
        # them (a call's host dispatch can outlast a short kernel) and the
        # wrapper's host time a call (the decode step is host-bound)
        def kernel():
            return decode_attn_cuda(q, k, v, lens)

        ms, graph_ms = time_ms(kernel, reps=20), graph_time_ms(kernel)
        host_us = dispatch_us(kernel)
        plain_ms = time_ms(lambda: decode_attention_reference(q, k, v, lens),
                           reps=2, trials=3)
        qt = q[:, :, None]                                # (B, H, 1, D)
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]         # (B, 1, 1, S)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_ms, lib_graph_ms = time_ms(sdpa, reps=20), graph_time_ms(sdpa)
        n_valid = int(torch.clamp(lens.long(), max=S).sum())
        n_bytes = (2 * n_valid * KV * D + 2 * B * H * D) * 2
        b_ms, b_by = bound_ms(n_bytes, 4.0 * n_valid * H * D, "bf16")
        print(f"  decode_attention {arch} B={B} S={S} H={H} KV={KV} D={D} "
              f"bf16, sum(lengths) {n_valid}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}, 2^-7 of max|out|) kernel {ms:.4f} ms (graph "
              f"replay {graph_ms:.4f}, host {host_us:.1f} us a call), plain "
              f"{plain_ms:.4f} ms, sdpa (bool mask, GQA) {lib_ms:.4f} ms "
              f"(graph replay {lib_graph_ms:.4f}), bound {b_ms:.4f} ms "
              f"({b_by})")
        rows.append({"name": f"decode_attention[{arch}]", "route": "cuda",
                     "source": "src/repro_torch/kernels/decode_attention/"
                               "csrc/decode_attn.cu",
                     "replaces": "src/repro/kernels/decode_attention/"
                                 "kernel.py:30",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "graph_ms": graph_ms,
                     "library_graph_ms": lib_graph_ms, "host_us": host_us})
        del q, k, v, kt, vt
        torch.cuda.empty_cache()
    return rows


def _moe_case(T, d, E, F, dtype, ids, gen, kernels=None, bt=None):
    """The kernel against the plain sorted version on one plan: rows below
    ``used`` within one output rounding step (bf16) or 1e-5 (f32) of the
    output's scale. ``kernels`` (default: ``kernel_for``'s choice) are run
    in turn on the same inputs; returns the largest error."""
    import torch
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_cuda
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_sorted_reference
    bt = bt or ops.block_t_for(T, E)
    p = ops.plan(ids, E, bt)
    x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, d, F), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    xs = ops.scatter_rows(x, p)
    del x
    ys_p = moe_gemm_sorted_reference(xs, p.block_expert, w, bt, p.used)
    n = int(p.used)
    scale = max(1.0, ys_p[:n].float().abs().max().item())
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = 0.0
    for kernel in kernels or (None,):
        ys = moe_gemm_cuda(xs, p.block_expert, w, bt, p.used, kernel=kernel)
        e = (ys[:n].float() - ys_p[:n].float()).abs().max().item() / scale
        if not e <= rel:
            _fail(f"moe_gemm T={T} d={d} E={E} F={F} {dtype} block_t {bt} "
                  f"kernel {kernel}: error {e:.3e} of the output's scale > "
                  f"{rel}")
        err = max(err, e)
    return xs, w, p, bt, err, rel


def check_moe_swiglu(xs, w_gate, p, bt, gen, T):
    """The fused gate/up kernel (``moe_gemm_wgmma_swiglu``) at one plan:
    held per element to the three steps it replaces on the card (gate and
    up on ``moe_gemm_wgmma``, then ``F.silu(g.float()).to(bf16) * u``),
    within one bf16 step (``bf16_step_limit``), with the share of elements
    bit-equal; to the plain version (fp32 products) within one output
    rounding step of h's scale; timed beside the gate and up launches it
    replaces and beside the three steps whole; the bound counts the ``T``
    assignments' operations. Returns the row's fields."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    from repro_torch.kernels.moe_gemm.kernel import (moe_gemm_cuda,
                                                     moe_gemm_swiglu_cuda)
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_swiglu_reference)
    E, d, F_ = w_gate.shape
    w_up = (torch.randn((E, d, F_), generator=gen, device="cuda")
            * d ** -0.5).to(w_gate.dtype)
    n = int(p.used)
    be, used = p.block_expert, p.used

    def fused():
        return moe_gemm_swiglu_cuda(xs, be, w_gate, w_up, bt, used)

    def gate_up():
        return (moe_gemm_cuda(xs, be, w_gate, bt, used),
                moe_gemm_cuda(xs, be, w_up, bt, used))

    def three_steps():
        g, u = gate_up()
        return F.silu(g.float()).to(g.dtype) * u

    h, steps = fused()[:n], three_steps()[:n]
    lim = bf16_step_limit(steps)
    diff = (h.float() - steps.float()).abs()
    steps_err = (diff / lim).max().item()
    exact = (h == steps).float().mean().item()
    if not steps_err <= 1.0:
        _fail(f"moe_gemm swiglu T={T}: {steps_err:.3f} bf16 steps from the "
              "three steps it replaces")
    del steps, lim, diff
    h_p = moe_gemm_sorted_swiglu_reference(xs, be, w_gate, w_up, bt,
                                           used)[:n]
    scale = max(1.0, h_p.float().abs().max().item())
    err = (h.float() - h_p.float()).abs().max().item() / scale
    if not err <= 2.0 ** -7:
        _fail(f"moe_gemm swiglu T={T}: error {err:.3e} of h's scale against "
              "the plain version")
    del h, h_p
    torch.cuda.empty_cache()
    ms = time_ms(fused, reps=10)
    gate_up_ms = time_ms(gate_up, reps=10)
    steps_ms = time_ms(three_steps, reps=10)
    e_used = int((torch.bincount(be[:n // bt].long(), minlength=E) > 0)
                 .sum())
    n_bytes = (T * d + 2 * e_used * d * F_ + T * F_) * 2
    b_ms, b_by = bound_ms(n_bytes, 4.0 * T * d * F_, "bf16")
    print(f"  moe_gemm swiglu T={T} d={d} F={F_} E={E} (token block {bt}): "
          f"fused kernel {ms:.4f} ms ({4.0 * T * d * F_ / ms / 1e9:.1f} "
          f"TFLOP/s, {b_ms / ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); "
          f"the gate and up launches it replaces {gate_up_ms:.4f} ms "
          f"({gate_up_ms / ms:.3f}x the fused one), with the SiLU chain "
          f"{steps_ms:.4f} ms; against those "
          f"steps {steps_err:.3f} of one bf16 step at worst, {exact:.4%} of "
          f"elements bit-equal; against the plain version {err:.3e} of h's "
          f"scale (tol {2.0 ** -7:.2e})")
    return {"swiglu_ms": ms, "swiglu_bound_ms": b_ms,
            "swiglu_gate_up_ms": gate_up_ms, "swiglu_steps_ms": steps_ms,
            "swiglu_max_abs_err": err, "swiglu_steps_err": steps_err,
            "swiglu_bit_equal": exact}


def check_moe_gemm(gen):
    import torch
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_sorted_reference
    bf16 = torch.bfloat16

    def ids(T, E, kind):
        if kind == "one expert":
            return torch.full((T,), E // 2, dtype=torch.int32, device="cuda")
        e = torch.randint(0, E, (T,), generator=gen, device="cuda",
                          dtype=torch.int32)
        if kind == "one-row group":  # expert E - 1 gets exactly one row
            e = e % (E - 1)
            e[T // 3] = E - 1
        return e // 4 * 4 if kind == "empty experts" else e

    # side cases: every token on one expert, empty experts, an expert whose
    # group is a single row, T not a multiple of the token block, F = 768
    # and 1408 (no multiple of the TPU kernel's 512), ragged d and F, the
    # f32 path; at the token block ``block_t_for`` picks (None) and at the
    # wgmma kernel's blocks, each through both kernels where the wgmma one
    # takes it
    for T, d, E, F, dtype, kind, bt in (
            (4096, 2048, 128, 768, bf16, "one expert", None),
            (1000, 2048, 64, 1408, bf16, "empty experts", None),
            (8191, 512, 128, 768, bf16, "random", None),
            (333, 200, 16, 100, bf16, "random", None),
            (777, 256, 8, 384, torch.float32, "random", None),
            (4096, 2048, 128, 768, bf16, "one expert", 128),
            (1000, 2048, 64, 1408, bf16, "empty experts", 64),
            (8191, 512, 128, 768, bf16, "random", 128),
            (20000, 2048, 128, 768, bf16, "one-row group", 128),
            (333, 200, 16, 104, bf16, "random", 64)):
        bt = bt or ops.block_t_for(T, E)
        both = kernel_for(dtype, bt, d, F) == "wgmma"
        kernels = ("wgmma", "mma_sync") if both else ("mma_sync",)
        xs, w, p, _, _, _ = _moe_case(T, d, E, F, dtype, ids(T, E, kind),
                                      gen, kernels=kernels, bt=bt)
        if both:
            check_moe_swiglu(xs, w, p, bt, gen, T)
        del xs, w
        print(f"  moe_gemm side case T={T} d={d} E={E} F={F} {dtype} "
              f"({kind}, token block {bt}) through {' and '.join(kernels)}: "
              "ok")
    rows = []
    # the MoE paths' shapes at qwen3-moe's d = 2048, E = 128, top-8:
    # prefill (16 x 1,024 tokens x 8) gate/up and down, decode (16 x 8);
    # and moonlight.prefill_8k's (8 x 8,192 tokens x top-6 over 64 experts
    # of 1,408, ~6,144 rows an expert) gate/up and down
    for what, T, d, F, E in (("prefill", 131072, 2048, 768, 128),
                             ("prefill down", 131072, 768, 2048, 128),
                             ("decode", 128, 2048, 768, 128),
                             ("moonlight", 393216, 2048, 1408, 64),
                             ("moonlight down", 393216, 1408, 2048, 64)):
        xs, w, p, bt, err, rel = _moe_case(T, d, E, F, bf16,
                                           ids(T, E, "random"), gen)
        kernel = kernel_for(bf16, bt, d, F)
        ms = time_ms(lambda: moe_gemm_cuda(xs, p.block_expert, w, bt,
                                           p.used), reps=10)
        plain_ms = time_ms(lambda: moe_gemm_sorted_reference(
            xs, p.block_expert, w, bt, p.used), reps=1, trials=3)
        ends = torch.cumsum((p.block_expert[:int(p.used) // bt].long()[
            :, None] == torch.arange(E, device="cuda")).sum(0) * bt, 0)
        bounds = [0] + ends.tolist()
        groups = [(e, bounds[e], bounds[e + 1]) for e in range(E)
                  if bounds[e + 1] > bounds[e]]
        loop_ms = time_ms(lambda: [xs[r0:r1] @ w[e] for e, r0, r1 in groups],
                          reps=2, trials=3)
        gmm_ms = None
        if hasattr(torch, "_grouped_mm"):
            n, offs = int(p.used), ends.to(torch.int32)
            # w as it is, then each expert's matrix column-major
            for wb in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
                try:
                    torch._grouped_mm(xs[:n], wb, offs=offs)
                except RuntimeError as e:  # a yardstick only: report it
                    print(f"  torch._grouped_mm refused the case: "
                          f"{str(e).splitlines()[0][:160]}")
                    continue
                gmm_ms = time_ms(lambda: torch._grouped_mm(xs[:n], wb,
                                                           offs=offs))
                break
        lib_ms = gmm_ms if gmm_ms is not None else loop_ms
        e_used = len(groups)
        n_bytes = T * d * 2 + e_used * d * F * 2 + T * F * 2
        b_ms, b_by = bound_ms(n_bytes, 2.0 * T * d * F, "bf16")
        other = ""
        if kernel == "wgmma":
            # beside it on the same card: the same call through the mma.sync
            # kernel at the 64-row token block the prefill used before the
            # wgmma kernel, and through the wgmma kernel at 64 rows
            xs64, w64, p64, _, _, _ = _moe_case(T, d, E, F, bf16,
                                                ids(T, E, "random"), gen,
                                                kernels=("mma_sync", "wgmma"),
                                                bt=64)
            t_old = time_ms(lambda: moe_gemm_cuda(
                xs64, p64.block_expert, w64, 64, p64.used,
                kernel="mma_sync"), reps=10)
            t_64 = time_ms(lambda: moe_gemm_cuda(
                xs64, p64.block_expert, w64, 64, p64.used, kernel="wgmma"),
                reps=10)
            other = (f", mma.sync kernel at token block 64 {t_old:.4f} ms, "
                     f"wgmma kernel at token block 64 {t_64:.4f} ms")
            del xs64, w64
        print(f"  moe_gemm {what} T={T} d={d} F={F} E={E} (experts used "
              f"{e_used}, token block {bt}, rows {int(p.used)} of "
              f"{p.T_pad}) bf16, {kernel} kernel: error {err:.3e} of the "
              f"output's scale (tol {rel:.2e}) kernel {ms:.4f} ms "
              f"({2.0 * T * d * F / ms / 1e9:.1f} TFLOP/s){other}, plain "
              f"{plain_ms:.4f} ms, per-expert torch.matmul loop "
              f"{loop_ms:.4f} ms, torch._grouped_mm "
              + (f"{gmm_ms:.4f} ms" if gmm_ms is not None else "n/a")
              + f", bound {b_ms:.4f} ms ({b_by})")
        if not what.endswith(" down"):
            rows.append({"name": f"moe_gemm[{what}]", "route": "cuda",
                         "source": "src/repro_torch/kernels/moe_gemm/csrc/"
                                   "moe_gemm.cu",
                         "replaces": "src/repro/kernels/moe_gemm/"
                                     "kernel.py:27",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib_ms})
        if what in ("prefill", "moonlight"):  # the MoE layers' gate and up
            rows[-1].update(check_moe_swiglu(xs, w, p, bt, gen, T))
        del xs, w
        torch.cuda.empty_cache()
    return rows


def check_moe_rows(gen):
    """The MoE row kernels (``moe_gemm/csrc/moe_rows.cu``) at
    moonlight.prefill_8k's shape: 8 x 8,192 tokens, each to its top-6 of 64
    experts (distinct, as the router picks them), d 2,048, bf16, 128-row
    blocks. The dispatch bit for bit ``scatter_rows`` below ``used``; the
    combine (on a random stand-in for the down output) within one bf16 step
    of the gather and batched product it replaces (``bf16_step_limit``),
    the same bits twice. Each timed beside the torch steps it replaces and
    the plain version, against its bound: bytes at 3.35 TB/s, the dispatch
    reading x and slot_of once and writing the ``used`` rows (assignments
    and padding), the combine reading the A assignment rows, slot_of and w
    and writing y. Returns the two kernels' rows."""
    import torch
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import (moe_combine_rows_cuda,
                                                     moe_dispatch_rows_cuda)
    from repro_torch.kernels.moe_gemm.ref import (combine_rows_reference,
                                                  dispatch_rows_reference)
    T, K, E, d, bt = 65536, 6, 64, 2048, 128
    A = T * K
    ids = torch.rand((T, E), generator=gen, device="cuda").topk(K).indices
    p = ops.plan(ids.reshape(-1), E, bt)
    n = int(p.used)
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)

    def dispatch():
        return moe_dispatch_rows_cuda(x, p.slot_of, p.counts, p.ends,
                                      p.T_pad, K)

    xs = dispatch()
    same = torch.equal(xs[:n], ops.scatter_rows(x, p, K)[:n])
    if not same:
        _fail("moe_dispatch_rows at the moonlight shape: not bit-equal to "
              "scatter_rows below used")
    del xs
    torch.cuda.empty_cache()
    ys = torch.randn((p.T_pad, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    w = torch.rand((T, K), generator=gen, device="cuda") * 2.446

    def combine():
        return moe_combine_rows_cuda(ys, p.slot_of, w)

    def steps():  # the gather and the batched product
        return combine_rows_reference(ys, p.slot_of, w)

    y, want = combine(), steps()
    if not torch.equal(combine(), y):
        _fail("moe_combine_rows: another result on the second call")
    diff = (y.float() - want.float()).abs()
    err, over = diff.max().item(), (diff / bf16_step_limit(want)).max().item()
    exact = (y == want).float().mean().item()
    if not over <= 1.0:
        _fail(f"moe_combine_rows: {over:.3f} bf16 steps from the gather "
              "and batched product")
    del diff
    del y, want
    torch.cuda.empty_cache()
    hbm = _peaks()[0]
    b_disp = ((T + n) * d * 2 + A * 4 + 2 * E * 4) / hbm * 1e3
    b_comb = ((A + T) * d * 2 + A * 4 + A * 4) / hbm * 1e3
    ms_disp = time_ms(dispatch, reps=10)
    torch_disp = time_ms(lambda: ops.scatter_rows(x, p, K), reps=10)
    plain_disp = time_ms(lambda: dispatch_rows_reference(
        x, p.slot_of, p.T_pad, K), reps=2, trials=3)
    ms_comb = time_ms(combine, reps=10)
    torch_comb = time_ms(steps, reps=10)
    print(f"  moe rows T={T} top-{K} of E={E} d={d} bf16 (rows {n} of "
          f"{p.T_pad}): dispatch {ms_disp:.4f} ms ({b_disp / ms_disp:.1%} "
          f"of the bound {b_disp:.4f} ms, bytes), scatter_rows "
          f"{torch_disp:.4f} ms, plain {plain_disp:.4f} ms, bit-equal "
          f"below used; combine {ms_comb:.4f} ms ({b_comb / ms_comb:.1%} of "
          f"the bound {b_comb:.4f} ms, bytes), gather + bmm {torch_comb:.4f} "
          f"ms; {over:.3f} of one bf16 step at worst, {exact:.4%} of "
          "elements bit-equal, the same bits twice")
    del x, ys, w
    src = "src/repro_torch/kernels/moe_gemm/csrc/moe_rows.cu"
    return [{"name": "moe_dispatch_rows", "route": "cuda", "source": src,
             "replaces": "none (ops.scatter_rows' torch steps)",
             "max_abs_err": 0.0, "ms": ms_disp, "plain_ms": plain_disp,
             "bound_ms": b_disp, "bound_by": "bytes",
             "library_ms": torch_disp},
            {"name": "moe_combine_rows", "route": "cuda", "source": src,
             "replaces": "none (ops.gather_rows and torch.bmm)",
             "max_abs_err": err, "steps_err": over, "bit_equal": exact,
             "ms": ms_comb, "plain_ms": torch_comb, "bound_ms": b_comb,
             "bound_by": "bytes", "library_ms": torch_comb}]


def check_split_gemm(gen):
    """The split GEMMs at the vision tower's shapes (d 1,280, d_ff 5,120;
    an exit group of 64 x 257 rows and a ragged one of 37 x 257): against
    the plain version, a float64 product and fp32 cuBLAS (TF32 off), whose
    worst error against float64 the kernel's may pass by at most 2x; the
    same bits twice; inf and NaN where cuBLAS puts them. Timed at 64 x 257
    beside the bound (three bf16 products at 989e12; the CUDA-core bound,
    one fp32 product at 67e12, printed beside), the plain version, fp32
    ``torch.matmul`` on weights cast once (``library_ms``) and the port's
    previous path, which casts the weights at every call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.split_gemm import ref
    from repro_torch.kernels.split_gemm.kernel import (matmul_cuda,
                                                       swiglu_gate_up_cuda)
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("split_gemm is held to fp32 cuBLAS: TF32 must be off")
    _, peak = _peaks()
    d, d_ff = 1280, 5120
    wg, wu = ((torch.randn((d, d_ff), generator=gen, device="cuda")
               * d ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((d_ff, d), generator=gen, device="cuda")
          * d_ff ** -0.5).bfloat16()
    worst, side = 0.0, {}
    for groups in (64, 37):
        M = groups * 257
        x = torch.randn((M, d), generator=gen, device="cuda")
        h = swiglu_gate_up_cuda(x, wg, wu)
        y = matmul_cuda(h, wd)
        if not (torch.equal(h, swiglu_gate_up_cuda(x, wg, wu)) and
                torch.equal(y, matmul_cuda(h, wd))):
            _fail(f"split_gemm M={M}: not the same bits twice")
        x64 = x.double()
        cases = (("gate_up", d, d_ff, h, lambda: ref.swiglu_gate_up(x, wg, wu),
                  lambda: F.silu(x @ wg.float()) * (x @ wu.float()),
                  lambda: F.silu(x64 @ wg.double()) * (x64 @ wu.double())),
                 ("down", d_ff, d, y, lambda: ref.matmul(h, wd),
                  lambda: h @ wd.float(), lambda: h.double() @ wd.double()))
        for what, K, N, got, plain_fn, lib_fn, exact_fn in cases:
            exact = exact_fn()
            errs = [(t.double() - exact).abs().max().item()
                    for t in (got, plain_fn(), lib_fn())]
            del exact
            worst = max(worst, errs[0])
            print(f"  split_gemm {what} M={M} ({groups} x 257) K={K} N={N}: "
                  f"max abs err vs float64 kernel {errs[0]:.3e}, plain "
                  f"{errs[1]:.3e}, fp32 cuBLAS {errs[2]:.3e} (kernel / "
                  f"cuBLAS {errs[0] / errs[2]:.2f}, gate 2)")
            if not errs[0] <= 2 * errs[2]:
                _fail(f"split_gemm {what} M={M}: error vs float64 "
                      f"{errs[0]:.3e} > 2x fp32 cuBLAS's {errs[2]:.3e}")
            if groups != 64:
                continue
            a = x if what == "gate_up" else h
            kern = (lambda: swiglu_gate_up_cuda(x, wg, wu)) \
                if what == "gate_up" else (lambda: matmul_cuda(h, wd))
            wf = [w.float() for w in ((wg, wu) if what == "gate_up"
                                      else (wd,))]
            lib = (lambda: F.silu(x @ wf[0]) * (x @ wf[1])) \
                if what == "gate_up" else (lambda: h @ wf[0])
            prev = (lambda: F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))) \
                if what == "gate_up" else (lambda: h @ wd.to(h.dtype))
            ops_ = 2.0 * M * K * N * (2 if what == "gate_up" else 1)
            side[what] = {
                "ms": time_ms(kern), "plain_ms": time_ms(plain_fn, reps=2,
                                                         trials=3),
                "library_ms": time_ms(lib), "previous_path_ms": time_ms(prev),
                "bound_ms": 3 * ops_ / peak["bf16"] * 1e3,
                "cuda_core_bound_ms": ops_ / peak["fp32"] * 1e3,
                "shape": [M, K, N], "a_dtype": str(a.dtype)}
            s_ = side[what]
            print(f"  split_gemm {what} M={M} K={K} N={N}: kernel "
                  f"{s_['ms']:.4f} ms ({ops_ / s_['ms'] / 1e9:.1f} fp32 "
                  f"TFLOP/s, {s_['bound_ms'] / s_['ms']:.0%} of the bound "
                  f"{s_['bound_ms']:.4f} ms; CUDA-core bound "
                  f"{s_['cuda_core_bound_ms']:.4f} ms), plain "
                  f"{s_['plain_ms']:.4f} ms, fp32 torch.matmul "
                  f"{s_['library_ms']:.4f} ms, previous path (casts at "
                  f"every call) {s_['previous_path_ms']:.4f} ms")
        del x, x64, h, y
        torch.cuda.empty_cache()
    # inf and NaN where fp32 cuBLAS puts them
    x = torch.randn((257, d), generator=gen, device="cuda")
    x[1, 3], x[2, 0], x[3, 5] = float("inf"), float("-inf"), float("nan")
    h = swiglu_gate_up_cuda(x, wg, wu)
    h_lib = F.silu(x @ wg.float()) * (x @ wu.float())
    y, y_lib = matmul_cuda(x, wg), x @ wg.float()
    for got, want in ((h, h_lib), (y, y_lib)):
        if not all(torch.equal(f(got), f(want)) for f in
                   (torch.isnan, torch.isposinf, torch.isneginf)):
            _fail("split_gemm: inf / NaN not where fp32 cuBLAS puts them")
    print("  split_gemm: inf and NaN in x land where fp32 cuBLAS puts them")
    return {"name": "split_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/split_gemm/csrc/"
                      "split_gemm.cu",
            "replaces": "none (models/layers.py::swiglu's fp32 products)",
            "max_abs_err": worst,
            "ms": side["gate_up"]["ms"] + side["down"]["ms"],
            "plain_ms": side["gate_up"]["plain_ms"]
            + side["down"]["plain_ms"],
            "bound_ms": side["gate_up"]["bound_ms"]
            + side["down"]["bound_ms"],
            "bound_by": "operations (three bf16 products)",
            "library_ms": side["gate_up"]["library_ms"]
            + side["down"]["library_ms"], "side": side}


def check_flash_lm(gen):
    """The flash forward at the LM prefills, bf16, causal: qwen2-1.5b's
    (32 prompts of 2,048, 12 heads of 128 over 2 kv heads) and qwen3-moe's
    (16 of 1,024, 32 heads over 4). The same shape without the causal mask
    visits every key tile: the ratio shows the tiles the causal q tiles
    skip."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_fwd_cuda,
                                                            plain_like_kernel)
    rows = []
    for what, arch, B, S, H, KV in (("lm_prefill", "qwen2-1.5b", 32, 2048, 12,
                                     2),
                                    ("moe_prefill", "qwen3-moe-30b-a3b", 16,
                                     1024, 32, 4)):
        D = 128
        q, k, v, err, over, _ = _flash_case(
            B, S, S, H, KV, D, torch.bfloat16, causal=True, window=0,
            q_offset=0, gen=gen, lse_tol=1e-3)
        ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=True), reps=5,
                     trials=5)
        full_ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=False),
                          reps=5, trials=5)
        plain_ms = time_ms(lambda: plain_like_kernel(q, k, v, causal=True),
                           reps=1, trials=2)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
        n_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 + B * H * S * 4
        n_ops = 4.0 * B * H * D * S * (S + 1) / 2
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
        print(f"  flash {what} ({arch}) B={B} S={S} H={H} KV={KV} D={D} "
              f"bf16 causal: max_abs_err {err:.3e} ({over:.2f} of the "
              f"per-element limit) kernel "
              f"{ms:.4f} ms ({n_ops / ms / 1e9:.1f} TFLOP/s), the same "
              f"without the causal mask {full_ms:.4f} ms (causal / full "
              f"{ms / full_ms:.3f}), plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append({"name": f"flash_attention_fwd[{what}]", "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/"
                               "csrc/flash_fwd.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:31",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def kernel_phase():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernels vs plain versions:")
    rows = [check_topk(gen)]
    torch.cuda.empty_cache()
    rows += check_flash(gen)
    rows.append(check_flash_mla(gen))
    torch.cuda.empty_cache()
    rows.append(check_kda(gen))
    torch.cuda.empty_cache()
    rows.append(check_rmsnorm(gen))
    rows.append(check_gathered(gen))
    torch.cuda.empty_cache()
    rows.append(check_dense(gen))
    torch.cuda.empty_cache()
    rows += check_int4_cache(gen)
    torch.cuda.empty_cache()
    rows += check_decode(gen)
    rows += check_moe_gemm(gen)
    rows += check_moe_rows(gen)
    torch.cuda.empty_cache()
    rows.append(check_split_gemm(gen))
    torch.cuda.empty_cache()
    rows += check_flash_lm(gen)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the serving path, end to end
# ---------------------------------------------------------------------------


def _counters():
    """Kernel name -> (ops module, its launch counter's name)."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.int4_cache import ops as int4_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.retrieval_topk import ops as topk_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.split_gemm import ops as split_ops
    return {"int4_quant": (int4_ops, "launches"),
            "int4_dequant": (int4_ops, "launches_dequant"),
            "retrieval_topk_int4": (topk_ops, "launches"),
            "retrieval_topk_int4_gathered": (topk_ops, "launches_gathered"),
            "retrieval_topk_dense": (topk_ops, "launches_dense"),
            "flash_attention_fwd": (flash_ops, "launches"),
            "flash_attention_bwd": (flash_ops, "bwd_launches"),
            "rmsnorm": (rms_ops, "launches"),
            "rmsnorm_bwd": (rms_ops, "bwd_launches"),
            "decode_attention": (decode_ops, "launches"),
            "moe_gemm": (moe_ops, "launches"),
            "moe_gemm_bwd": (moe_ops, "bwd_launches"),
            "moe_rows": (moe_ops, "row_launches"),
            "split_gemm": (split_ops, "launches")}


def _reset_launches() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    _counters()["flash_attention_fwd"][0].launches_by_head_dim.clear()
    _counters()["moe_gemm"][0].launches_by_kernel.clear()
    _counters()["moe_gemm"][0].bwd_launches_by_kernel.clear()
    _counters()["moe_gemm"][0].row_launches_by_kernel.clear()
    _counters()["split_gemm"][0].launches_by_kernel.clear()


def _read_launches(cfg) -> dict:
    """Each kernel row's own count; the flash rows split by their tower's
    head dim (of ``cfg``, the recall-imagebind model)."""
    counters = _counters()
    flash = counters.pop("flash_attention_fwd")[0]
    out = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
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
    O(1) instead of the init's ~80 (a MEM tree of towers, or an LM's)."""
    def rescale(tp):
        a = dict(tp["layers"]["attn"])
        _, d, H, _ = a["wq"].shape
        for w in ("wq", "wk", "wv"):
            a[w] = a[w] * (H / d) ** 0.5
        a["wo"] = a["wo"] / H ** 0.5
        return dict(tp, layers=dict(tp["layers"], attn=a))
    if "towers" not in params:
        return rescale(params)
    return dict(params, towers={name: rescale(tp) for name, tp in
                                params["towers"].items()})


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
    from repro_torch.models import attention as ATT, layers, transformer as T
    tol = 1e-4  # unit-norm embeddings, as the CPU parity tests hold them
    cfg32 = dataclasses.replace(spec.model, dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def exit_embs(p, modality, h0, plain):
        with mock.patch.object(ATT, "flash_attention", attention_reference
                               if plain else ATT.flash_attention), \
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
                                  torch.as_tensor(items).cuda())
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


def _call_checker(rel_tol):
    """(both, worst, calls): ``both(name, kernel_fn, plain_fn, rows=None)``
    wraps a kernel's dispatch so that each call also runs the plain version
    on the same arguments and fails beyond ``rel_tol`` of the output's
    scale (over the first ``rows(*args)`` rows when given); ``worst`` and
    ``calls`` collect each name's largest error and call count."""
    worst, calls = {}, {}

    def both(name, kernel_fn, plain_fn, rows=None):
        def run(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            g, w = (got, want) if rows is None else \
                (got[:rows(*args)], want[:rows(*args)])
            scale = max(1.0, w.float().abs().max().item())
            err = (g.float() - w.float()).abs().max().item() / scale
            worst[name] = max(worst.get(name, 0.0), err)
            calls[name] = calls.get(name, 0) + 1
            if not err <= rel_tol:
                _fail(f"{name} call {calls[name]} {tuple(args[0].shape)}: "
                      f"error {err:.3e} of the output's scale > {rel_tol}")
            return got
        return run
    return both, worst, calls


def _flash_plain(q, k, v, **kw):
    """The plain flash output a call is held to: for bf16 the variant that
    rounds P to bf16 as the kernel (and the TPU kernel) does."""
    from repro_torch.kernels.flash_attention.kernel import plain_like_kernel
    return plain_like_kernel(q, k, v, **kw)[0]


def check_calls_vs_plain(params, spec, vision, text, lora=None):
    """Every kernel call of one full-width forward of both towers (4 items
    each; the vision tower alone, with the vision ``lora``, where ``text``
    is None) against its plain version on the same real activations, every
    exit's embedding computed.

    The random-init towers' attention is near one-hot (q/k weights are
    (d, H, hd) with fan-in taken as H, so logits have a std of ~80), which
    makes end-to-end outputs of two correct paths decorrelate with depth;
    the calls themselves must agree to one bf16 step of their output's
    scale."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.kernels.split_gemm import ops as split_ops
    from repro_torch.kernels.split_gemm import ref as split_ref
    from repro_torch.models import imagebind as IB
    from repro_torch.models import attention as ATT, layers
    rel_tol = 2.0 ** -7
    both, worst, calls = _call_checker(rel_tol)
    with torch.no_grad(), \
            mock.patch.object(ATT, "flash_attention",
                              both("flash_attention_fwd",
                                   flash_ops.flash_attention,
                                   _flash_plain)), \
            mock.patch.object(layers, "rmsnorm_op",
                              both("rmsnorm", rms_ops.rmsnorm_op,
                                   rmsnorm_reference)), \
            mock.patch.object(split_ops, "swiglu_gate_up",
                              both("split_gemm[gate_up]",
                                   split_ops.swiglu_gate_up,
                                   split_ref.swiglu_gate_up)), \
            mock.patch.object(split_ops, "matmul",
                              both("split_gemm[down]", split_ops.matmul,
                                   split_ref.matmul)):
        for modality, items in (("vision", vision), ("text", text)):
            if items is None:
                continue
            embs = IB.mem_embed_all_exits(
                params, spec.model, spec.recall, modality,
                torch.as_tensor(items).cuda(), lora=lora)["exit_embs"]
            if not torch.isfinite(embs).all():
                _fail(f"{modality} exit embeddings not finite")
    print(f"  kernel calls of a full-width forward ("
          + ("4 vision items with the healed LoRA" if lora is not None else
             "4 vision + 4 text items")
          + f") vs plain versions on the same activations: {calls}, worst error "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" of the output's scale (tol {rel_tol:.2e})")


@contextlib.contextmanager
def _recording_f32_flash_shapes():
    """Counts the (q, k) shapes of the f32 flash calls made inside (the
    vision tower's refinement in a query_batch); each call still goes
    through the kernel's dispatch and its launch counter."""
    import collections
    from unittest import mock
    import torch
    from repro_torch.models import attention as ATT
    shapes = collections.Counter()
    real = ATT.flash_attention

    def recording(q, k, v, **kw):
        if q.dtype == torch.float32:
            shapes[(tuple(q.shape), tuple(k.shape))] += 1
        return real(q, k, v, **kw)
    with mock.patch.object(ATT, "flash_attention", recording):
        yield shapes


def time_refine_flash(shapes):
    """The f32 flash kernel against SDPA at the refinement shape that the
    query_batch launched most often."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    if not shapes:
        _fail("the query_batch made no f32 flash call (refinement)")
    (qs, ks), n = shapes.most_common(1)[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q = torch.randn(qs, generator=gen, device="cuda")
    k, v = (torch.randn(ks, generator=gen, device="cuda") for _ in range(2))
    ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal=False))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    B, S, H, D = qs
    b_ms, b_by = bound_ms(4 * B * S * H * D * 4 + B * H * S * 4,
                          4.0 * B * H * S * ks[1] * D, "fp32")
    print(f"  flash f32 at the query_batch's refinement shape q {qs} "
          f"({n} of {sum(shapes.values())} f32 calls): kernel {ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data import synthetic as SYN
    from repro_torch.launch.serve import build_service
    spec = get_arch("recall-imagebind")
    cfg = spec.model
    n_items, n_queries, k = 512, 64, 10
    print(f"serve recall-imagebind (bf16 weights, full width; vision "
          f"{cfg.tower('vision').n_layers}L d={cfg.tower('vision').d_model}, "
          f"text {cfg.tower('text').n_layers}L d={cfg.tower('text').d_model}"
          f"): {n_items} items, {n_queries} queries, k={k}")
    data = SYN.multimodal_pairs(1, n_items, cfg)
    _reset_launches()
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
    in_drain = _read_launches(cfg)
    d2h_drain = engine.store.act_d2h_bytes
    t0 = time.perf_counter()
    with _recording_f32_flash_shapes() as refine_shapes:
        results = query.query_batch(data.items["text"][:n_queries], k=k)
        torch.cuda.synchronize()
    t_query = time.perf_counter() - t0
    launches = _read_launches(cfg)

    print(f"  build_service (init, 256-item calibration, predictor fit): "
          f"{t_build:.2f} s; predictor {info['predictor']}")
    print(f"  drain: {stats.n_embedded} items in {t_drain:.3f} s = "
          f"{stats.n_embedded / t_drain:.1f} items/s, avg layers "
          f"{stats.avg_layers:.2f}/{cfg.tower('vision').n_layers}")
    n_ref = sum(r.n_refined for r in results)
    print(f"  query_batch: {n_queries} queries in {t_query:.3f} s = "
          f"{t_query / n_queries * 1e3:.2f} ms/query, {n_ref} refinements")
    bank = engine.store.device_bank
    print(f"  device bank: {bank.stats()}")
    print(f"  kernel launches on the serving path: {launches}")
    # bytes of the activation cache between host and card: packed bytes +
    # scales to the host in the drain (the fp32 hidden states were
    # n_items * 257 * 1280 * 4 bytes), packed bytes + scales back for
    # each refinement
    S, d = cfg.tower("vision").n_tokens + 1, cfg.tower("vision").d_model
    print(f"  activation cache: drain D2H {d2h_drain} bytes "
          f"({d2h_drain / n_items:.0f} per item; the fp32 hidden states "
          f"would be {n_items * S * d * 4} bytes), query_batch H2D "
          f"{engine.stats.refine_h2d_bytes} bytes for {n_ref} refinements; "
          f"int4 launches: drain quant {in_drain['int4_quant']} dequant "
          f"{in_drain['int4_dequant']}, query_batch quant "
          f"{launches['int4_quant'] - in_drain['int4_quant']} dequant "
          f"{launches['int4_dequant'] - in_drain['int4_dequant']}")

    missing = [n for n in SERVE_KERNELS if launches[n] == 0]
    if missing:
        _fail(f"kernels never launched on the serving path: {missing}")
    if in_drain["int4_quant"] == 0 or \
            launches["int4_dequant"] == in_drain["int4_dequant"]:
        _fail("the drain did not quantize its activations on the card or "
              "the query_batch did not dequantize them there")
    if len(engine.store) != n_items or len(bank) != n_items:
        _fail(f"store holds {len(engine.store)} rows, bank {len(bank)}")
    _check_results(results, engine.store, k)
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
    time_refine_flash(refine_shapes)
    check_calls_vs_plain(engine.params, spec, data.items["vision"][:4],
                         data.items["text"][:4])
    check_fp32_end_to_end(engine.params, spec, data.items["vision"][:4],
                          data.items["text"][:4])
    profile_phase(engine, query, data.items["vision"][:64],
                  data.items["text"][n_queries:n_queries + 16])
    serve_ivf(engine, spec, data.items["text"][:n_queries], k)
    serve_sharded(engine, spec, data.items["vision"][:128],
                  data.items["text"][n_queries:n_queries + 16], k)
    return launches


SERVE_KERNELS = ("retrieval_topk_int4", "flash_attention_fwd[vision]",
                 "flash_attention_fwd[text]", "rmsnorm", "int4_quant",
                 "int4_dequant", "split_gemm")
IVF_KERNELS = ("retrieval_topk_int4_gathered", "retrieval_topk_dense")


def _check_results(results, store, k, *, refined: bool = True) -> None:
    """Well-formed query_batch results: 1..k distinct live uids per query,
    finite unit-range scores in descending order, and (``refined``) some
    refinement."""
    import numpy as np
    for b, r in enumerate(results):
        if not (1 <= len(r.uids) <= k and np.isfinite(r.scores).all()
                and len(set(r.uids.tolist())) == len(r.uids)
                and np.all(np.diff(r.scores) <= 0)
                and np.all(np.abs(r.scores) <= 1 + 1e-3)
                and store.contains(r.uids).all()):
            _fail(f"query {b}: malformed result {r.uids} {r.scores}")
    if refined and sum(r.n_refined for r in results) == 0:
        _fail("no candidate was refined")


def serve_ivf(engine, spec, texts, k):
    """query_batch through an IVF-indexed QueryEngine over the drained
    store: 'auto' resolves to the pruned union scan, which runs the
    exhaustive int4 kernel over the gathered candidate rows."""
    import torch
    from repro_torch.serving.query import QueryEngine
    _reset_launches()
    t0 = time.perf_counter()
    query = QueryEngine(engine.params, spec.model, spec.recall,
                        store=engine.store, refine_fn=engine.refine_fn(),
                        query_modality="text", index="ivf",
                        index_clusters=16, index_min_rows=256, nprobe=4,
                        device="cuda")
    if query.search_impl != "ivf":
        _fail(f"IVF query engine resolved auto to {query.search_impl!r}")
    results = query.query_batch(texts, k=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_launches(spec.model)
    store = engine.store
    print(f"  IVF query_batch ({len(texts)} queries, {len(store)} items, 16 "
          f"clusters, nprobe 4, attach included): {dt:.3f} s = "
          f"{dt / len(texts) * 1e3:.2f} ms/query, {sum(r.n_refined for r in results)} "
          f"refinements, fallbacks {store.ivf_fallbacks}, index "
          f"{store.ivf_index.stats()}, launches {launches}")
    if launches["retrieval_topk_int4"] == 0 or store.ivf_fallbacks:
        _fail("the IVF query_batch did not run the pruned union scan")
    _check_results(results, store, k)


def serve_sharded(engine, spec, items, texts, k):
    """One query_batch of 16 through ``QueryEngine(search_devices=
    ["cuda:0"] * 4)`` (the bank row-sharded four ways on the one card)
    against the one-shard engine: two stores drained alike from the serve
    phase's engine (its params and predictor), each queried once. The
    drained stores, the results (uids, scores, refinements) and the
    refined rows the query_batch wrote back must be equal, bit for bit,
    and each store scan must launch the int4 scan once a shard."""
    import numpy as np
    import torch
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.kernels.retrieval_topk import ops as topk_ops
    from repro_torch.serving.engine import EmbeddingEngine
    from repro_torch.serving.query import QueryEngine
    cfg, rc = spec.model, spec.recall
    stores = [EmbeddingStore(cfg.embed_dim, device="cuda") for _ in range(2)]
    engines = [EmbeddingEngine(engine.params, cfg, rc, modality="vision",
                               predictor_params=engine.predictor, store=st,
                               device="cuda") for st in stores]
    for eng in engines:
        eng.submit_batch(np.arange(len(items)), items)
        eng.drain()
    if not np.array_equal(stores[0].dense_matrix(), stores[1].dense_matrix()):
        _fail("two drains of the same items differ")
    results, launches = [], []
    for st, eng, devices in zip(stores, engines,
                                (["cuda:0"], ["cuda:0"] * 4)):
        query = QueryEngine(engine.params, cfg, rc, store=st,
                            refine_fn=eng.refine_fn(), query_modality="text",
                            search_impl="device", search_devices=devices,
                            device="cuda")
        before = topk_ops.launches
        results.append(query.query_batch(texts, k=k))
        torch.cuda.synchronize()
        launches.append(topk_ops.launches - before)
    banks = [st.device_bank for st in stores]
    if [b.n_shards for b in banks] != [1, 4] or launches != [1, 4]:
        _fail(f"shards {[b.n_shards for b in banks]}, int4 scan launches "
              f"{launches} (want [1, 4]: one fused scan a query_batch)")
    for a, b in zip(*results):
        if not (np.array_equal(a.uids, b.uids)
                and np.array_equal(a.scores, b.scores)
                and np.array_equal(a.filtered_uids, b.filtered_uids)
                and a.n_refined == b.n_refined):
            _fail("the 4-shard engine's query_batch differs from the "
                  "one-shard engine's")
    if not (np.array_equal(stores[0].dense_matrix(),
                           stores[1].dense_matrix())
            and np.array_equal(stores[0].is_fine(stores[0].uids()),
                               stores[1].is_fine(stores[1].uids()))):
        _fail("the refined rows written back differ")
    _check_results(results[1], stores[1], k)
    print(f"  query_batch of {len(texts)} through QueryEngine(search_devices="
          f"['cuda:0'] * 4) over {len(items)} drained items: uids, scores "
          f"and {sum(r.n_refined for r in results[1])} refinements (the "
          f"refined rows written back) equal the one-shard engine's, bit "
          f"for bit; int4 scan launches {launches[0]} vs {launches[1]}")


def _same_topk(got, want, tol, what):
    """(uids, scores) pairs: scores within ``tol``, uids equal wherever the
    wanted scores are separated by more than ``tol``."""
    import numpy as np
    (u_g, s_g), (u_w, s_w) = got, want
    if u_g.shape != u_w.shape:
        _fail(f"{what}: shapes {u_g.shape} vs {u_w.shape}")
    err = float(np.abs(s_g - s_w).max())
    sep = np.ones(s_w.shape, bool)
    d = np.abs(np.diff(s_w, axis=1)) > tol
    sep[:, 1:] &= d
    sep[:, :-1] &= d
    sep[:, -1] = False
    if not (err <= tol and np.array_equal(u_g[sep], u_w[sep])):
        _fail(f"{what}: score err {err} (tol {tol}) or uids differ at "
              "separated scores")
    return err


def _numpy_topk(dense, rows, uids, queries, k):
    """Exact top-k of each query over ``rows`` of the fp32 slab."""
    import numpy as np
    s = queries @ dense[rows].T
    sel = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return uids[rows[sel]], np.take_along_axis(s, sel, axis=1)


def ivf_phase():
    """The IVF pruned-search path at a real library size: 2^17
    clustered_sphere rows at E = 1024 (C/2 = 128 blobs, the corpus shape of
    the reference's store benchmark) inserted in batches into a CUDA store
    with an online IVF index (C = 256, nprobe 8, min_rows 32768), queried by
    64 clustered queries through both pruned strategies and the dense fp32
    path. Launch counters are read right after those queries; the checks,
    timings and profiles follow."""
    import numpy as np
    import torch
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.data.synthetic import clustered_sphere
    from repro_torch.index.pruned_scan import pruned_search_numpy, recall_at_k
    from repro_torch.configs.base import get_arch
    n, E, C, nprobe, k, Q, batch = 1 << 17, 1024, 256, 8, 10, 64, 8192
    rng = np.random.default_rng(0)
    data, centers = clustered_sphere(rng, n, C // 2, E, spread=0.03)
    queries, _ = clustered_sphere(rng, Q, spread=0.03, centers=centers)
    print(f"IVF: {n} clustered_sphere rows ({C // 2} blobs, spread 0.03), "
          f"E={E}, "
          f"C={C}, nprobe={nprobe}, {Q} queries, k={k}")
    _reset_launches()
    t0 = time.perf_counter()
    store = EmbeddingStore(E, device="cuda")
    idx = store.attach_ivf(n_clusters=C, nprobe=nprobe, min_rows=32768)
    for lo in range(0, n, batch):
        store.add_batch(np.arange(lo, lo + batch), data[lo:lo + batch],
                        np.zeros(batch), np.ones(batch))
    t_insert = time.perf_counter() - t0
    if store.resolve_impl("auto") != "ivf":
        _fail(f"auto resolves to {store.resolve_impl('auto')!r} on a CUDA "
              f"store of {n} rows with a trained index")
    t0 = time.perf_counter()
    got_u = store.search_batch(queries, k)  # auto: ivf, union (+ re-cluster)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    got_g = store.search_batch(queries, k, impl="ivf", strategy="gathered")
    got_d = store.search_batch(queries, k, impl="pallas")
    torch.cuda.synchronize()
    launches = _read_launches(get_arch("recall-imagebind").model)
    print(f"  insert {n} rows in {batch}-row batches (quantize, train, "
          f"assign): {t_insert:.2f} s; first query (inline re-cluster, "
          f"bank upload): {t_first:.2f} s; launches {launches}")
    missing = [name for name in IVF_KERNELS if launches[name] == 0]
    if missing or launches["retrieval_topk_int4"] == 0:
        _fail(f"kernels never launched on the IVF path: {missing}")

    small = EmbeddingStore(E, device="cuda")
    small.attach_ivf(n_clusters=16, min_rows=32768)
    small.add_batch(np.arange(4096), data[:4096], np.zeros(4096),
                    np.ones(4096))
    if not small.ivf_index.trained or small.resolve_impl("auto") != "device":
        _fail("auto on a 4096-row store below min_rows is not 'device'")

    st = idx.stats()
    if not (st["trained"] and st["n_unassigned"] == 0
            and store.ivf_fallbacks == 0):
        _fail(f"index {st}, fallbacks {store.ivf_fallbacks}")
    dense, uids = store.dense_matrix(), store.uids()
    tol = 1e-5  # fp32 dots of the same dequantized rows, another order
    # gathered == the numpy pruned oracle (same probes, same candidates)
    err_g = _same_topk(got_g, pruned_search_numpy(dense, n, uids, idx,
                                                  queries, k), tol,
                       "gathered vs pruned_search_numpy")
    # union == the exact top-k over the batch's candidate union, which holds
    # every query's own candidates: never worse than the per-query oracle
    union = idx.candidate_union(queries)
    err_u = _same_topk(got_u, _numpy_topk(dense, union, uids, queries, k),
                       tol, "union vs numpy over the candidate union")
    if (got_u[1][:, -1] < got_g[1][:, -1] - tol).any():
        _fail("union's k-th score below the per-query pruned scan's")
    exact = store.search_batch(queries, k, impl="device")
    _same_topk(got_d, store.search_batch(queries, k, impl="numpy"), tol,
               "dense kernel path vs numpy")
    # every cluster probed: both strategies return the exhaustive scan's
    # rows with the same floats (per-row scores are bit-equal)
    for strategy in ("union", "gathered"):
        _same_topk(store.search_batch(queries, k, impl="ivf", nprobe=C,
                                      strategy=strategy), exact, 0.0,
                   f"{strategy} at nprobe = C vs the exhaustive device scan")
    rec_u, rec_g = (recall_at_k(got_u[0], exact[0]),
                    recall_at_k(got_g[0], exact[0]))
    cand = idx.candidate_rows(queries, k)
    per_q = float((cand >= 0).sum(axis=1).mean())

    def qps(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return Q / statistics.median(ts)

    q_ex = qps(lambda: store.search_batch(queries, k, impl="device"))
    q_u = qps(lambda: store.search_batch(queries, k, impl="ivf"))
    q_g = qps(lambda: store.search_batch(queries, k, impl="ivf",
                                         strategy="gathered"))
    host_u = Q / qps(lambda: idx.candidate_union(queries)) * 1e3
    host_g = Q / qps(lambda: idx.candidate_rows(queries, k)) * 1e3
    print(f"  union vs numpy over its {union.size} candidate rows: max err "
          f"{err_u:.2e}; gathered vs pruned_search_numpy: max err "
          f"{err_g:.2e} (tol {tol}); nprobe=C: both equal the exhaustive "
          "scan (scores bit-equal); dense path vs numpy: ok")
    print(f"  recall@{k} vs the exhaustive device scan: union {rec_u:.4f}, "
          f"gathered {rec_g:.4f}; candidates per query: gathered "
          f"{per_q:.1f} of {n} ({per_q / n:.2%}), union {union.size} "
          f"shared by the batch")
    print(f"  host wall q/s incl. candidate building ({Q}-query batches): "
          f"exhaustive device {q_ex:.1f}, union {q_u:.1f} "
          f"({q_u / q_ex:.2f}x), gathered {q_g:.1f} ({q_g / q_ex:.2f}x); "
          f"of a batch's host wall, building candidates takes {host_u:.2f} ms "
          f"(union) and {host_g:.2f} ms (gathered)")
    time_gathered_at_ivf(store, queries, cand, k)
    profile_windows((
        ("exhaustive device scan, 64 queries",
         lambda: store.search_batch(queries, k, impl="device"), "topk_int4"),
        ("IVF union scan, 64 queries",
         lambda: store.search_batch(queries, k, impl="ivf"), "topk_int4"),
        ("IVF gathered scan, 64 queries",
         lambda: store.search_batch(queries, k, impl="ivf",
                                    strategy="gathered"),
         "topk_int4_gather")))
    print(f"  ivf_index.stats() {st}; ivf_fallbacks {store.ivf_fallbacks}; "
          f"dense path uploads {store.upload_calls} x "
          f"{store.upload_bytes // max(store.upload_calls, 1)} bytes")
    return launches


# the gathered kernel timed on the IVF phase's own candidates, merged into
# its kernels row by main()
IVF_GATHERED: dict = {}


def time_gathered_at_ivf(store, queries, cand, k):
    """The gathered kernel alone on the IVF phase's real candidate rows
    (Q = 64, L = the bucketed probed mass) and on three copies of them
    (Q = 192, as a query_batch scans 3 granularities), over the store's
    published bank snapshot."""
    import numpy as np
    import torch
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_gathered_cuda)
    snap = store.device_bank._state(None)
    if len(snap.packed) != 1:
        _fail(f"the IVF store's bank has {len(snap.packed)} shards, not 1")
    packed, scales = snap.packed[0], snap.scales[0]
    ids = torch.from_numpy(np.ascontiguousarray(cand, np.int32)).cuda()
    q = torch.from_numpy(np.asarray(queries, np.float32)).cuda()
    E = q.shape[1]
    for reps in (1, 3):
        ids_r, q_r = ids.repeat(reps, 1), q.repeat(reps, 1)
        ms = time_ms(lambda: retrieval_topk_int4_gathered_cuda(
            q_r, packed, scales, ids_r, k, n_valid=snap.n),
            reps=10)
        b_ms, b_by = gathered_bound(ids_r, snap.n, E, k)
        Q, L = ids_r.shape
        live = int(((ids_r >= 0) & (ids_r < snap.n)).sum())
        print(f"  gathered kernel at the IVF phase's candidates: Q={Q} "
              f"L={L} ({live / Q:.1f} live a query, bank {snap.n} rows): "
              f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} "
              "of it)")
        IVF_GATHERED[f"ivf_q{Q}"] = {"L": L, "live": live, "ms": ms,
                                     "bound_ms": b_ms}


ASYNC_KERNELS = ("retrieval_topk_int4", "int4_quant")


def _record_mutations(store):
    """Log every add / upgrade / delete of ``store`` in the order they take
    its lock (activations left out), so a sync store can replay them."""
    import numpy as np
    log = []
    add, upgrade, delete = store.add_batch, store.upgrade_batch, \
        store.delete_batch

    def add_batch(uids, embs, exit_idxs, exit_layers, **kw):
        with store._lock:
            add(uids, embs, exit_idxs, exit_layers, **kw)
            log.append(("add", np.array(uids), np.array(embs, np.float32),
                        np.array(exit_idxs), np.array(exit_layers)))

    def upgrade_batch(uids, embs):
        with store._lock:
            upgrade(uids, embs)
            log.append(("upgrade", np.array(uids), np.array(embs, np.float32)))

    def delete_batch(uids):
        with store._lock:
            delete(uids)
            log.append(("delete", np.array(uids)))

    store.add_batch, store.upgrade_batch, store.delete_batch = \
        add_batch, upgrade_batch, delete_batch
    return log


def async_phase():
    """The write side under the async bank refresh, at full width:
    ``build_service(bank_refresh="async", bank_max_lag_rows=4096)`` over a
    store preloaded with 2^17 clustered rows at E = 1024. A writer thread
    inserts 8 batches of 1,024 rows and drains 32 items after each through
    the engine (quantize on the card); a query thread meanwhile issues
    64-query ``search_batch(impl="device")`` calls and one 64-query
    ``query_batch``. Every policy read must have
    been served within the row bound. After ``stop(drain=True)`` a
    ``freshness="fresh"`` scan must equal, bit for bit, the scan of a sync
    store that replays the same mutations."""
    import threading
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.data import synthetic as SYN
    from repro_torch.launch.serve import build_service
    spec = get_arch("recall-imagebind")
    cfg = spec.model
    E, n_pre, batch, rounds, n_items, Q, k = (cfg.embed_dim, 1 << 17, 1024,
                                              8, 32, 64, 10)
    bound = 4 * batch
    rng = np.random.default_rng(2)
    data, centers = SYN.clustered_sphere(rng, n_pre + rounds * batch, 128, E,
                                         spread=0.03)
    queries, _ = SYN.clustered_sphere(rng, Q, spread=0.03, centers=centers)
    pairs = SYN.multimodal_pairs(3, rounds * n_items, cfg)
    print(f"async: recall-imagebind, bank_refresh='async', max_lag_rows "
          f"{bound}; {n_pre} preloaded rows at E={E}; writer {rounds} x "
          f"({batch} rows + a drain of {n_items} items); {Q}-query scans")
    _reset_launches()
    engine, query, _ = build_service(spec, n_train=64, seed=1,
                                     bank_refresh="async",
                                     bank_max_lag_rows=bound,
                                     search_impl="device", device="cuda")
    store, ref = engine.store, engine.store.bank_refresher
    pre_uids = np.arange(n_pre) + 1_000_000
    for lo in range(0, n_pre, 8192):
        store.add_batch(pre_uids[lo:lo + 8192], data[lo:lo + 8192],
                        np.zeros(8192), np.ones(8192))
    store.search_batch(queries, k, impl="device", freshness="fresh")
    log = _record_mutations(store)
    errors, scans, lags, n_refined = [], [], [], []
    done = threading.Event()

    def writer():
        try:
            for r in range(rounds):
                lo = n_pre + r * batch
                store.add_batch(np.arange(lo, lo + batch) + 1_000_000,
                                data[lo:lo + batch], np.zeros(batch),
                                np.ones(batch))
                engine.submit_batch(
                    np.arange(r * n_items, (r + 1) * n_items),
                    pairs.items["vision"][r * n_items:(r + 1) * n_items])
                engine.drain()
        except Exception as e:  # reported below
            errors.append(("writer", repr(e)))
        finally:
            done.set()

    def reader():
        try:
            i = 0
            while not done.is_set() or i < 4:
                lags.append(ref.lag()[0])
                t0 = time.perf_counter()
                u, sc = store.search_batch(queries, k, impl="device")
                scans.append(time.perf_counter() - t0)
                if u.shape != (Q, k) or not np.isfinite(sc).all():
                    errors.append(("reader", f"scan {i}: {u.shape}"))
                if i == 2:
                    # the preloaded rows carry no activation cache, and
                    # they fill most top-k lists: refinement may find
                    # nothing to refine here (the serve phase checks it)
                    res = query.query_batch(pairs.items["text"][:Q], k=k)
                    _check_results(res, store, k, refined=False)
                    n_refined.append(sum(r.n_refined for r in res))
                i += 1
        except SystemExit as e:
            errors.append(("reader", str(e)))
        except Exception as e:  # reported below
            errors.append(("reader", repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        _fail(f"async phase threads: alive "
              f"{[t.is_alive() for t in threads]}, errors {errors}")
    ref.stop(drain=True)
    torch.cuda.synchronize()
    launches = _read_launches(cfg)
    got = store.search_batch(queries, k, impl="device", freshness="fresh")
    bank = store.device_bank
    print(f"  {len(scans)} scans + 1 query_batch ({n_refined[0]} "
          f"refinements) in {wall:.2f} s beside the "
          f"writer: {len(scans) * Q / sum(scans):.1f} q/s by scan wall "
          f"(median {statistics.median(scans) * 1e3:.2f} ms per {Q}-query "
          f"scan); epochs {ref.n_epochs}, generation {bank.generation}, "
          f"blocking {ref.n_blocking}, stale-served {ref.n_stale_served}, "
          f"largest served lag {ref.max_served_lag_rows} rows (bound "
          f"{bound}), pending rows seen before scans: max {max(lags)}; "
          f"bank {bank.stats()}; launches {launches}")
    if ref.max_served_lag_rows > bound:
        _fail(f"a policy read was served {ref.max_served_lag_rows} rows "
              f"behind, over the bound {bound}")
    missing = [n for n in ASYNC_KERNELS if launches[n] == 0]
    if missing:
        _fail(f"kernels never launched on the async path: {missing}")
    sync = EmbeddingStore(E, device="cuda")
    for lo in range(0, n_pre, 8192):
        sync.add_batch(pre_uids[lo:lo + 8192], data[lo:lo + 8192],
                       np.zeros(8192), np.ones(8192))
    for m in log:
        if m[0] == "add":
            sync.add_batch(*m[1:])
        elif m[0] == "upgrade":
            sync.upgrade_batch(*m[1:])
        else:
            sync.delete_batch(*m[1:])
    want = sync.search_batch(queries, k, impl="device")
    if not (len(sync) == len(store) and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        _fail("after stop(drain=True) the fresh async scan differs from the "
              "sync store's scan of the same mutations")
    print(f"  after stop(drain=True): fresh scan == sync store's scan of the "
          f"same {len(log)} mutations ({len(store)} rows), uids and scores "
          "bit-equal")
    store.set_bank_refresh("sync")
    return launches


SHARDS = ["cuda:0"] * 4  # four bank shards on the one card


def _bit_equal(got, want, what):
    import numpy as np
    if not (got[0].shape == want[0].shape and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        diff = (float(np.abs(got[1] - want[1]).max())
                if got[1].shape == want[1].shape else "shapes differ")
        _fail(f"{what}: not bit-equal to the one-shard bank (max score "
              f"difference {diff})")


def _sharded_scan(store, queries, k, attr, **kw):
    """Attach a 4-shard bank to ``store`` and scan once to upload it; then
    the gated scan, which must move the ``attr`` counter by exactly 4."""
    from repro_torch.kernels.retrieval_topk import ops as topk_ops
    store.attach_device_bank(SHARDS)
    store.search_batch(queries, k, impl="device")
    before = getattr(topk_ops, attr)
    out = store.search_batch(queries, k, **kw)
    if getattr(topk_ops, attr) - before != len(SHARDS):
        _fail(f"{attr} moved by {getattr(topk_ops, attr) - before} in a "
              f"{len(SHARDS)}-shard scan ({kw})")
    return out


def _mixture(gen, centers, n):
    """n rows of ``clustered_sphere``'s mixture around ``centers`` (a
    center + 0.03 x a normal draw, unit-normed), drawn on the card from
    ``gen`` (the host's draw of 2^20 rows took 40 s), as host fp32."""
    import torch
    c = torch.from_numpy(centers).cuda()
    x = c[torch.randint(0, len(c), (n,), generator=gen, device="cuda")]
    x += 0.03 * torch.randn(x.shape, generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()


def _fill(store, gen, centers, n, chunk):
    """Add n rows of the mixture to ``store`` in chunks."""
    import numpy as np
    for lo in range(0, n, chunk):
        store.add_batch(np.arange(lo, lo + chunk),
                        _mixture(gen, centers, chunk), np.zeros(chunk),
                        np.ones(chunk))


def shard_phase():
    """The device bank row-sharded four ways on the one card (``SHARDS``),
    held against a one-shard bank over the same rows, at recall-imagebind's
    embed width E = 1,024, the rows drawn from a 128-blob
    ``clustered_sphere`` mixture (``_mixture``): the exhaustive int4 scan
    over 2^20 rows (the kernel phase's N), both pruned strategies on
    the IVF phase's configuration (2^17 rows, C = 256, nprobe 8), the dense
    scan of an fp32 store of 2^18 rows, and an async refresh whose writer
    crosses a capacity doubling (rows move between shards)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.data.synthetic import clustered_sphere
    from repro_torch.index.pruned_scan import recall_at_k
    E = get_arch("recall-imagebind").model.embed_dim
    Q, k = 64, 10
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    _, centers = clustered_sphere(rng, 1, 128, E, spread=0.03)
    queries, _ = clustered_sphere(rng, Q, spread=0.03, centers=centers)
    print(f"shard: the device bank over {len(SHARDS)} shards on cuda:0 vs "
          f"one shard, E={E}, {Q} queries, k={k}")
    _reset_launches()

    # the exhaustive scan at the kernel phase's N
    n = 1 << 20
    t0 = time.perf_counter()
    store = EmbeddingStore(E, device="cuda")
    _fill(store, gen, centers, n, 1 << 16)
    t_fill = time.perf_counter() - t0
    store.attach_device_bank(["cuda:0"])
    one = store.search_batch(queries, k, impl="device")
    bank = store.device_bank
    one_ms = time_ms(lambda: bank.search(queries, k), reps=1, trials=5)
    four = _sharded_scan(store, queries, k, "launches", impl="device")
    bank = store.device_bank
    four_ms = time_ms(lambda: bank.search(queries, k), reps=1, trials=5)
    _bit_equal(four, one, f"exhaustive scan over {n} rows")
    st = bank.stats()
    print(f"  exhaustive int4 scan, {n} rows ({t_fill:.1f} s to add): 4 "
          f"shards == 1 shard, ids and scores bit-equal; retrieval_topk_int4 "
          f"launches 4 a scan; {Q}-query scan {one_ms:.4f} ms (1 shard) vs "
          f"{four_ms:.4f} ms (4 shards) by CUDA events, median of 5; bank "
          f"{st['device_bytes'] / 1e9:.3f} GB over {st['n_shards']} shards")
    del store, bank
    gc.collect()
    torch.cuda.empty_cache()

    # the pruned strategies on the IVF phase's configuration
    n, C, nprobe = 1 << 17, 256, 8
    store = EmbeddingStore(E, device="cuda")
    store.attach_ivf(n_clusters=C, nprobe=nprobe, min_rows=32768)
    _fill(store, gen, centers, n, 8192)
    store.attach_device_bank(["cuda:0"])
    store.search_batch(queries, k, impl="ivf")  # inline re-cluster, upload
    exact = store.search_batch(queries, k, impl="device")
    want = {s: store.search_batch(queries, k, impl="ivf", strategy=s)
            for s in ("union", "gathered")}
    got = {"union": _sharded_scan(store, queries, k, "launches", impl="ivf",
                                  strategy="union"),
           "gathered": _sharded_scan(store, queries, k, "launches_gathered",
                                     impl="ivf", strategy="gathered")}
    for strategy in want:
        _bit_equal(got[strategy], want[strategy],
                   f"IVF {strategy} scan over {n} rows")
    if store.ivf_fallbacks:
        _fail(f"{store.ivf_fallbacks} IVF fallbacks")
    print(f"  IVF {n} rows, C={C}, nprobe={nprobe}: union and gathered over "
          f"4 shards == 1 shard, uids and scores bit-equal; launches 4 a "
          f"scan (retrieval_topk_int4, retrieval_topk_int4_gathered); "
          f"recall@{k} vs the exhaustive scan: union "
          f"{recall_at_k(got['union'][0], exact[0]):.4f}, gathered "
          f"{recall_at_k(got['gathered'][0], exact[0]):.4f}")
    del store
    gc.collect()

    # an fp32 store: the dense scan
    n = 1 << 18
    store = EmbeddingStore(E, store_int4=False, device="cuda")
    _fill(store, gen, centers, n, 1 << 15)
    store.attach_device_bank(["cuda:0"])
    one = store.search_batch(queries, k, impl="device")
    four = _sharded_scan(store, queries, k, "launches_dense", impl="device")
    _bit_equal(four, one, f"fp32 dense scan over {n} rows")
    err = _same_topk(four, store.search_batch(queries, k, impl="numpy"),
                     1e-5, "4-shard fp32 scan vs numpy")
    print(f"  fp32 store, {n} rows ({n * E * 4 / 2**30:.1f} GiB): dense scan "
          f"over 4 shards == 1 shard bit for bit, launches_dense 4 a scan; "
          f"vs the numpy scan max err {err:.2e} (tol 1e-5)")
    del store
    gc.collect()
    torch.cuda.empty_cache()
    shard_async(gen, centers, queries, k)
    torch.cuda.synchronize()
    return _read_launches(get_arch("recall-imagebind").model)


def shard_async(gen, centers, queries, k):
    """Async refresh over the 4-shard bank: 61,440 preloaded rows, then a
    writer thread adds 8 x 1,024 rows, crossing the 65,536-row capacity
    (the bank grows, rows per shard double and rows move between shards),
    while a reader scans under ``max_lag_rows`` = 4,096. Every policy read
    stays within the bound, ``h2d_rows`` equals the rows written, and after
    the refresher stops a fresh scan equals, bit for bit, a sync one-shard
    store's scan of the same mutations."""
    import threading
    import numpy as np
    from repro_torch.core.store import EmbeddingStore
    E = centers.shape[1]
    n_pre, batch, rounds, bound = 61440, 1024, 8, 4096
    data = _mixture(gen, centers, n_pre + rounds * batch)
    store = EmbeddingStore(E, device="cuda")
    store.attach_device_bank(SHARDS)
    store.add_batch(np.arange(n_pre), data[:n_pre], np.zeros(n_pre),
                    np.ones(n_pre))
    store.search_batch(queries, k, impl="device")
    ref = store.set_bank_refresh("async", max_lag_rows=bound)
    log = _record_mutations(store)
    errors, scans = [], []
    done = threading.Event()

    def writer():
        try:
            for r in range(rounds):
                lo = n_pre + r * batch
                store.add_batch(np.arange(lo, lo + batch),
                                data[lo:lo + batch], np.zeros(batch),
                                np.ones(batch))
        except Exception as e:  # reported below
            errors.append(("writer", repr(e)))
        finally:
            done.set()

    def reader():
        try:
            while not done.is_set() or len(scans) < 4:
                u, sc = store.search_batch(queries, k, impl="device")
                scans.append(u.shape)
                if u.shape != (len(queries), k) or not np.isfinite(sc).all():
                    errors.append(("reader", f"scan {len(scans)}"))
        except Exception as e:  # reported below
            errors.append(("reader", repr(e)))

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or errors:
        _fail(f"shard async threads: alive {[t.is_alive() for t in threads]}"
              f", errors {errors}")
    ref.stop(drain=True)
    bank = store.device_bank
    got = store.search_batch(queries, k, impl="device", freshness="fresh")
    written = n_pre + rounds * batch
    if ref.max_served_lag_rows > bound or bank.n_grows < 1 or \
            bank.h2d_rows != written:
        _fail(f"shard async: served lag {ref.max_served_lag_rows} (bound "
              f"{bound}), grows {bank.n_grows}, h2d_rows {bank.h2d_rows} "
              f"(rows written {written})")
    sync = EmbeddingStore(E, device="cuda")
    sync.attach_device_bank(["cuda:0"])
    sync.add_batch(np.arange(n_pre), data[:n_pre], np.zeros(n_pre),
                   np.ones(n_pre))
    for m in log:
        sync.add_batch(*m[1:])
    _bit_equal(got, sync.search_batch(queries, k, impl="device"),
               "async 4-shard fresh scan vs a sync one-shard store")
    print(f"  async refresh over 4 shards: {len(scans)} scans beside a writer "
          f"of {rounds} x {batch} rows over {n_pre} preloaded; epochs "
          f"{ref.n_epochs}, largest served lag {ref.max_served_lag_rows} "
          f"rows (bound {bound}), grows {bank.n_grows} (capacity "
          f"{bank.capacity}, {bank.published.rows_per_shard} rows a shard), "
          f"h2d_rows {bank.h2d_rows} == rows written; after stop(drain=True) "
          "the fresh scan == the sync one-shard store's, bit for bit")
    store.set_bank_refresh("sync")


_LAYERS = (("flash_fwd_wgmma", "attention (flash wgmma kernel, bf16)"),
           ("flash_fwd_f32", "attention (flash FMA kernel, f32)"),
           ("decode_split", "decode attention (CUDA kernel, split pass)"),
           ("decode_merge", "decode attention (CUDA kernel, merge pass)"),
           ("moe_gemm_wgmma", "grouped expert GEMM (wgmma kernel)"),
           ("moe_gemm_kernel", "grouped expert GEMM (mma.sync kernel)"),
           ("int4_quant", "int4 quantize (cache kernel)"),
           ("int4_dequant", "int4 dequantize (cache kernel)"),
           ("Memcpy DtoH", "copies device to host"),
           ("Memcpy HtoD", "copies host to device"),
           ("topk_int4_gather", "gathered int4 scan (top-k kernel)"),
           ("topk_int4", "int4 scan (top-k kernel)"),
           ("topk_dense", "dense scan (top-k kernel)"),
           ("topk_pass2", "top-k merge (pass 2)"),
           ("flash_bwd_dq", "attention backward (dQ kernel)"),
           ("flash_bwd_dkdv", "attention backward (dK/dV kernel)"),
           ("flash_bwd_f32", "attention backward (f32 one-pass kernel)"),
           ("bwd_delta", "attention backward (delta)"),
           ("sum_key_tiles", "attention backward (dQ key-tile sum)"),
           ("reduce_heads", "attention backward (GQA head sum)"),
           ("rmsnorm_bwd", "rmsnorm backward (Triton kernel)"),
           ("rmsnorm", "rmsnorm (Triton kernel)"),
           ("gemm", "matmul (cuBLAS)"), ("sm90_", "matmul (cuBLAS)"),
           ("nvjet", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"))


def _layer_of(kernel_name: str) -> str:
    if "moe_gemm_dw_wgmma" in kernel_name:
        return "grouped GEMM backward dW (wgmma kernel)"
    if "moe_gemm_dw" in kernel_name:
        return "grouped GEMM backward dW (mma.sync kernel)"
    if "moe_gemm_dx_wgmma" in kernel_name:
        return "grouped GEMM backward dX (persistent wgmma kernel)"
    if "moe_gemm_wgmma_swiglu" in kernel_name:
        return "grouped GEMM gate/up with SiLU·up (fused wgmma kernel)"
    if "moe_gemm_kernel" in kernel_name and ("true>" in kernel_name
                                             or "Lb1E" in kernel_name):
        return "grouped GEMM backward dX (mma.sync kernel)"
    for key, layer in _LAYERS:
        if key in kernel_name:
            return layer
    return "other (elementwise, copies, sort)"


def profile_phase(engine, query, items, texts):
    """Where the device time goes: one more drain batch and one more query
    batch under torch.profiler."""
    import numpy as np
    starts = iter(range(10_000, 10_000 + 15 * len(items), len(items)))

    def drain():  # fresh uids for each trace
        start = next(starts)
        engine.submit_batch(np.arange(start, start + len(items)), items)
        engine.drain()

    return profile_windows((
        ("drain of 64 items", drain, "int4_quant"),
        ("query_batch of 16 queries", lambda: query.query_batch(texts,
                                                                k=10),
         "flash_fwd")))


def _profile_once(fn, reps):
    """``reps`` runs of ``fn`` under torch.profiler: wall s, device ms and
    device ms by layer per run, and the kernel names seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_layer, total, names = {}, 0.0, set()
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        layer = _layer_of(ev.key)
        by_layer[layer] = by_layer.get(layer, 0.0) + us / 1e3 / reps
        total += us / 1e3 / reps
        names.add(ev.key)
    return wall, total, by_layer, names


def profile_windows(windows):
    """Each (what, fn, must_see) run under torch.profiler: device time
    summed by kernel and by layer, and the device's busy share of the wall
    time. The trace has been seen to lose a short window's kernel events
    (PERF.md, section 6), so a window whose trace holds no kernel whose
    name contains ``must_see`` is traced again, up to four times in all,
    running ``fn`` 1, 2, 4, then 8 times in the trace (numbers per run); a
    window that never shows it fails."""
    out = {}
    for what, fn, must_see in windows:
        for attempt in range(1, 5):
            reps = 2 ** (attempt - 1)
            wall, total, by_layer, names = _profile_once(fn, reps)
            if any(must_see in n for n in names):
                break
        else:
            _fail(f"profiler saw no {must_see!r} kernel in four traces of "
                  f"the {what} (device time {total:.3f} ms; kernels seen: "
                  f"{sorted(names)[:8]})")
        shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.0%})" for k, v in
                           sorted(by_layer.items(), key=lambda kv: -kv[1]))
        print(f"  profile {what}"
              + (f" (trace {attempt} of 4, mean of {reps} back-to-back "
                 f"runs)" if attempt > 1 else " (1 run)")
              + f": wall {wall * 1e3:.1f} ms, device busy {total:.1f} ms "
              f"({total / (wall * 1e3):.0%}); {shares}")
        out[what] = (wall, total, by_layer)
    return out


# ---------------------------------------------------------------------------
# the LM serving path (prefill -> decode), dense and MoE
# ---------------------------------------------------------------------------


def _lm_launches() -> dict:
    """The LM kernels' counts, the grouped GEMM's split by kernel
    (``moe_gemm/wgmma``, ``moe_gemm/mma_sync``, ``moe_gemm/swiglu_wgmma``:
    the fused gate/up) and the MoE row kernels' (``moe_rows/dispatch``,
    ``moe_rows/combine``)."""
    c = _counters()
    out = {name: getattr(*c[name]) for name in
           ("flash_attention_fwd", "decode_attention", "moe_gemm", "rmsnorm")}
    by_kernel = c["moe_gemm"][0].launches_by_kernel
    out.update({f"moe_gemm/{k}": by_kernel.get(k, 0)
                for k in ("wgmma", "mma_sync", "swiglu_wgmma")})
    rows = c["moe_rows"][0].row_launches_by_kernel
    out.update({f"moe_rows/{k}": rows.get(k, 0)
                for k in ("dispatch", "combine")})
    return out


def check_lm_calls(run, what, *, record_plan=None):
    """Every kernel call of ``run()`` (a prefill or a decode step) against
    its plain version on the same inputs, within one bf16 step of the
    output's scale; the grouped GEMM on the rows of real groups. A fused
    gate/up call is held to the three steps it replaces on the card, whose
    gate and up products are each held to their plain versions as a
    grouped GEMM call is (the fp32 plain products may round g or u a bf16
    step apart, which SiLU·u carries past one step of h's scale). A row
    dispatch is held to ``scatter_rows`` below ``used``, a row combine to
    the gather and batched product it replaces, on the card.
    ``record_plan`` sees the expert ids of every MoE layer."""
    import torch
    import torch.nn.functional as F
    from unittest import mock
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_cuda
    from repro_torch.kernels.moe_gemm.ref import (combine_rows_reference,
                                                  moe_gemm_sorted_reference)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.models import attention as ATT, layers
    rel_tol = 2.0 ** -7
    both, worst, calls = _call_checker(rel_tol)
    plan = moe_ops.plan
    grouped = both("moe_gemm", moe_gemm_cuda, moe_gemm_sorted_reference,
                   rows=lambda *a: int(a[4]))

    def swiglu_steps(xs, block_expert, w_gate, w_up, bt, used):
        g, u = (grouped(xs, block_expert, w, bt, used)
                for w in (w_gate, w_up))
        return F.silu(g.float()).to(g.dtype) * u

    def recording_plan(expert_ids, *args):
        if record_plan is not None:
            record_plan(expert_ids)
        return plan(expert_ids, *args)

    with torch.no_grad(), \
            mock.patch.object(ATT, "flash_attention",
                              both("flash_attention_fwd",
                                   flash_ops.flash_attention,
                                   _flash_plain)), \
            mock.patch.object(ATT, "decode_attention",
                              both("decode_attention",
                                   dec_ops.decode_attention,
                                   decode_attention_reference)), \
            mock.patch.object(layers, "rmsnorm_op",
                              both("rmsnorm", rms_ops.rmsnorm_op,
                                   rmsnorm_reference)), \
            mock.patch.object(moe_ops, "moe_gemm_sorted",
                              both("moe_gemm", moe_ops.moe_gemm_sorted,
                                   # the plan's ends: the backward's only
                                   lambda *a: moe_gemm_sorted_reference(
                                       *a[:5]),
                                   rows=lambda *a: int(a[4]))), \
            mock.patch.object(moe_ops, "moe_gemm_sorted_swiglu",
                              both("moe_gemm_swiglu",
                                   moe_ops.moe_gemm_sorted_swiglu,
                                   swiglu_steps,
                                   rows=lambda *a: int(a[5]))), \
            mock.patch.object(moe_ops, "dispatch_rows",
                              both("moe_dispatch_rows",
                                   moe_ops.dispatch_rows,
                                   moe_ops.scatter_rows,
                                   rows=lambda x, p, k: int(p.used))), \
            mock.patch.object(moe_ops, "combine_rows",
                              both("moe_combine_rows", moe_ops.combine_rows,
                                   lambda ys, p, w: combine_rows_reference(
                                       ys, p.slot_of, w))), \
            mock.patch.object(moe_ops, "plan", recording_plan):
        out = run()
        torch.cuda.synchronize()
    print(f"  kernel calls of {what} vs plain versions on the same inputs: "
          f"{calls}, worst error "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" of the output's scale (tol {rel_tol:.2e})")
    return out


def _decode_window(dec, params, token, k, v, lengths, n_steps):
    """``n_steps`` greedy steps (argmax feeds the next token), one sync at
    the end: (token, lengths, wall s, all logits finite, s the closing sync
    waited: what the device still had to run once the host had enqueued
    every step)."""
    import torch
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        lengths = lengths + 1
        logits, k, v = dec.fn(params, token, k, v, lengths)
        ok &= torch.isfinite(logits).all()
        token = logits.argmax(-1).to(torch.int32)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return token, lengths, t2 - t0, bool(ok), t2 - t1


def _step_bytes(cfg, sum_len: float, B: int) -> float:
    """A decode step's bytes in ``lm_decode_hbm_bytes``'s accounting, over
    the batch's own lengths: every active weight, the valid K and V rows,
    the logits."""
    return (cfg.n_active_params * 2.0
            + 2.0 * cfg.n_layers * sum_len * cfg.n_kv_heads * cfg.head_dim
            * 2.0 + 2.0 * B * cfg.vocab * 4.0)


def _report_decode(arch, what, cfg, B, wall, n_steps, sum_len, sync):
    ms = wall / n_steps * 1e3
    n_bytes = _step_bytes(cfg, sum_len, B)
    print(f"  {arch} decode, {what}: {n_steps} steps of {B} in {wall:.3f} s "
          f"= {ms:.2f} ms/step, {B / ms * 1e3:.1f} tokens/s; bytes/step "
          f"{n_bytes / 1e9:.3f} GB (weights + sum(lengths) {sum_len:.0f} of "
          f"K/V + logits) = {n_bytes / ms / 1e6:.1f} GB/s, byte bound "
          f"{n_bytes / _peaks()[0] * 1e3:.3f} ms/step; the closing sync "
          f"waited {sync * 1e3:.1f} ms")


def check_exit_api(params, cfg, rc, tokens):
    """The LM exit API (``encode_exits``, ``encode_at``, ``refine_from``)
    over ``tokens`` at full width and depth: exact flash / RMSNorm launch
    counts for each call; ``encode_at`` at every exit, its pooled state bit
    for bit the full pass's at that layer and its embedding within 1e-6 of
    the stacked exit head's (which runs over n_exits * B rows, another
    matmul shape: the difference is printed); ``refine_from`` the first
    and a middle exit's cached activations, its hidden state, last pooled
    state and embedding bit for bit those of ``encode_at(L)``; one call of
    each held call by call against the plain versions; tokens/s of
    ``encode_exits``."""
    import torch
    from repro_torch.models import transformer as T
    L = cfg.n_layers
    exits = rc.exit_layers(L)
    B, S = tokens.shape

    def counted(fn, n_layers, what):
        _reset_launches()
        out = fn()
        torch.cuda.synchronize()
        c = _lm_launches()
        want = (n_layers, 2 * n_layers + 1)
        if (c["flash_attention_fwd"], c["rmsnorm"]) != want:
            _fail(f"{what}: flash / rmsnorm launches "
                  f"{c['flash_attention_fwd']} / {c['rmsnorm']}, not {want}")
        return out

    with torch.no_grad():
        full = counted(lambda: T.encode_exits(params, cfg, rc, tokens), L,
                       "encode_exits")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            T.encode_exits(params, cfg, rc, tokens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        diffs, cached = [], {}
        for i, e in enumerate(exits):
            at = counted(lambda: T.encode_at(params, cfg, rc, e, tokens), e,
                         f"encode_at({e})")
            if not torch.equal(at["pooled_last"], full["pooled"][e - 1]):
                _fail(f"encode_at({e}): pooled state differs from the full "
                      "pass's")
            diffs.append(float((at["emb"] - full["exit_embs"][i]).abs().max()))
            if diffs[-1] > 1e-6:
                _fail(f"encode_at({e}): embedding {diffs[-1]:.2e} from the "
                      "stacked exit head's (tol 1e-6)")
            cached[e] = at
        last = cached[L]
        if not torch.equal(last["h"], full["h"]):
            _fail(f"encode_at({L}): h differs from encode_exits'")
        for e in (exits[0], exits[len(exits) // 2]):
            res = counted(lambda: T.refine_from(params, cfg, rc,
                                                cached[e]["h"], start=e),
                          L - e, f"refine_from({e})")
            pooled = T.forward_hidden(params, cfg, rc, embeds=cached[e]["h"],
                                      layer_start=e,
                                      collect_pooled=True)["pooled"][-1]
            if not (torch.equal(res["h"], last["h"])
                    and torch.equal(res["emb"], last["emb"])
                    and torch.equal(pooled, last["pooled_last"])):
                _fail(f"refine_from({e}): h, pooled state or embedding "
                      f"differs from encode_at({L})'s")
        mid = exits[len(exits) // 2]
        check_lm_calls(lambda: T.encode_exits(params, cfg, rc, tokens),
                       f"encode_exits of {B} x {S}")
        check_lm_calls(lambda: T.encode_at(params, cfg, rc, mid, tokens),
                       f"encode_at({mid})")
        check_lm_calls(lambda: T.refine_from(params, cfg, rc,
                                             cached[mid]["h"], start=mid),
                       f"refine_from({mid})")
    print(f"  exit API over {B} x {S}: encode_exits {wall:.3f} s (median of "
          f"3) = {B * S / wall:.0f} tokens/s; encode_at at exits {exits}: "
          f"pooled states bit-equal to the full pass's, embeddings vs the "
          f"stacked exit head max |diff| "
          + ", ".join(f"{d:.1e}" for d in diffs)
          + f" (tol 1e-6); refine_from({exits[0]}) and refine_from({mid}): "
          f"h, pooled state and embedding bit-equal to encode_at({L})'s; "
          f"flash / rmsnorm launches e / 2e+1 a call over e layers")


def _serve_lm(arch, *, n_layers, B, S, pad_to, n_steps, check_batch,
              long_lo=0, n_long=0, record_plan=None, exit_api=False):
    """One LM through ``build_step`` with random weights from a CUDA
    generator: a call-by-call check of a prefill of ``check_batch``
    prompts; three timed prefills of B prompts of S seeded tokens into
    caches padded to ``pad_to`` (the first counted; then once more under
    the profiler); a warm-up
    step and ``n_steps`` timed greedy decode steps; one decode step checked
    call by call; with ``n_long``, a window of decode steps over caches of
    seeded K/V filled to per-sequence lengths in [long_lo, pad_to); each
    window profiled. Returns the launch counts of the prefill and of the
    decode window."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as T
    spec = get_arch(arch)
    pre = build_step(spec, ShapeConfig("prefill", "prefill", B, S),
                     n_layers=n_layers, pad_to=pad_to)
    dec = build_step(spec, ShapeConfig("decode", "decode", B, pad_to),
                     n_layers=n_layers)
    cfg, L = pre.meta["cfg"], pre.meta["cfg"].n_layers
    print(f"LM {arch} ({cfg.dtype}, full width, {L} of {spec.model.n_layers} "
          f"layers: d={cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"kv of {cfg.head_dim}, "
          + (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
             f"{cfg.moe.d_ff_expert}" if cfg.moe else f"d_ff {cfg.d_ff}")
          + f"; {cfg.n_params / 1e9:.2f} B params): {B} prompts of {S}, "
          f"cache {pad_to}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    counts = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        params = T.lm_init(gen, cfg, spec.recall, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        # first the call-by-call check, which also warms cuBLAS and the
        # Triton rmsnorm at this width
        check_lm_calls(lambda: T.prefill(params, cfg, spec.recall,
                                         tokens[:check_batch]),
                       f"one prefill of {check_batch} x {S}",
                       record_plan=record_plan)
        torch.cuda.empty_cache()
        _reset_launches()
        t0 = time.perf_counter()
        out = pre.fn(params, tokens)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        counts["prefill"] = _lm_launches()
        embs = out["exit_embs"]
        n_exits = len(spec.recall.exit_layers(L))
        if tuple(embs.shape) != (n_exits, B, 1024) or \
                not torch.isfinite(embs).all():
            _fail(f"{arch} prefill: exit embeddings {tuple(embs.shape)} "
                  f"not finite or not ({n_exits}, {B}, 1024)")
        if tuple(out["k_cache"].shape) != (L, B, pad_to, cfg.n_kv_heads,
                                           cfg.head_dim):
            _fail(f"{arch} prefill: cache {tuple(out['k_cache'].shape)}")
        del out
        # two more timed prefills: the host's clock on a shared host can
        # stall one run, so the line reports the median of three
        walls = [t_pre]
        for _ in range(2):
            t0 = time.perf_counter()
            out = pre.fn(params, tokens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del out
        t_pre = statistics.median(walls)
        print(f"  init {t_init:.2f} s; prefill {B} x {S}: {t_pre:.3f} s "
              f"(median of {', '.join(f'{w:.3f}' for w in walls)}) = "
              f"{B * S / t_pre:.0f} tokens/s, "
              f"{pre.model_flops / t_pre / 1e12:.1f} model TFLOP/s; "
              f"launches (first run) {counts['prefill']}")
        held = {}

        def prefill_again():  # frees the last caches before making new ones
            held.clear()
            held.update(pre.fn(params, tokens))

        profile_windows(((f"{arch} prefill of {B} x {S}", prefill_again,
                          "flash_fwd"),))
        k, v = held.pop("k_cache"), held.pop("v_cache")
        held.clear()
        lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
        token = tokens[:, -1].contiguous()
        # a warm-up step, then the timed window
        token, lengths, _, _, _ = _decode_window(dec, params, token, k, v,
                                                 lengths, 1)
        _reset_launches()
        len0 = float(lengths.sum())
        token, lengths, wall, ok, sync = _decode_window(
            dec, params, token, k, v, lengths, n_steps)
        counts["decode"] = _lm_launches()
        if not ok:
            _fail(f"{arch} decode: non-finite logits")
        _report_decode(arch, f"context {S + 1}-{S + 1 + n_steps}", cfg, B,
                       wall, n_steps, len0 + B * (n_steps + 1) / 2, sync)
        print(f"  launches in the decode window: {counts['decode']}")
        lengths = lengths + 1
        check_lm_calls(lambda: dec.fn(params, token, k, v, lengths),
                       "one decode step")
        profile_windows(((f"{arch} decode step at context {S + n_steps}",
                          lambda: dec.fn(params, token, k, v, lengths),
                          "decode_split"),))
        if n_long:
            for t in (k, v):
                t.normal_(generator=gen)
            lengths = torch.randint(long_lo, pad_to - n_long, (B,),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32)
            len0 = float(lengths.sum())
            token, lengths, wall, ok, sync = _decode_window(
                dec, params, token, k, v, lengths, n_long)
            if not ok:
                _fail(f"{arch} long-context decode: non-finite logits")
            _report_decode(arch, f"caches of seeded K/V, lengths in "
                           f"[{long_lo}, {pad_to})", cfg, B, wall, n_long,
                           len0 + B * (n_long + 1) / 2, sync)
            profile_windows(((f"{arch} decode step at lengths in "
                              f"[{long_lo}, {pad_to})",
                              lambda: dec.fn(params, token, k, v, lengths),
                              "decode_split"),))
        del k, v
        torch.cuda.empty_cache()
        if exit_api:
            check_exit_api(params, cfg, spec.recall, tokens[:check_batch])
    # rmsnorm: two a layer, then the exit head's (prefill) or the final
    # norm (decode); the grouped GEMM's bf16 prefill runs two launches a
    # layer on the wgmma kernels (gate and up fused, then down), its decode
    # three a layer on the mma.sync kernel; the rows go to the experts on
    # one dispatch a layer (the capacity layer combines them by torch steps)
    n_moe = L if cfg.moe else 0
    for name, want in (("flash_attention_fwd", ("prefill", L)),
                       ("decode_attention", ("decode", L * n_steps)),
                       ("moe_gemm", ("prefill", 2 * n_moe)),
                       ("moe_gemm/wgmma", ("prefill", n_moe)),
                       ("moe_gemm/swiglu_wgmma", ("prefill", n_moe)),
                       ("moe_gemm", ("decode", 3 * n_moe * n_steps)),
                       ("moe_gemm/mma_sync",
                        ("decode", 3 * n_moe * n_steps)),
                       ("moe_rows/dispatch", ("prefill", n_moe)),
                       ("moe_rows/dispatch", ("decode", n_moe * n_steps)),
                       ("moe_rows/combine", ("prefill", 0)),
                       ("moe_rows/combine", ("decode", 0)),
                       ("rmsnorm", ("prefill", 2 * L + 1)),
                       ("rmsnorm", ("decode", (2 * L + 1) * n_steps))):
        window, n = want
        if counts[window][name] != n:
            _fail(f"{arch} {window}: {name} launched "
                  f"{counts[window][name]} times, not {n}")
    return counts


def lm_phase():
    """qwen2-1.5b at full width and depth: 32 prompts of 2,048 into a
    32,768-token cache, 32 decode steps, then 8 steps at lengths in
    [16,384, 32,768) (the reference's decode_32k cut from B = 128 to 32:
    128 x 32,768 tokens of cache is 117 GB); then the exit API over 8 x
    2,048 of the prompts (``check_exit_api``)."""
    c = _serve_lm("qwen2-1.5b", n_layers=None, B=32, S=2048, pad_to=32768,
                  n_steps=32, check_batch=8, long_lo=16384, n_long=8,
                  exit_api=True)
    return {"decode_attention[qwen2-1.5b]": c["decode"]["decode_attention"],
            "flash_attention_fwd[lm_prefill]":
                c["prefill"]["flash_attention_fwd"]}


def moe_phase():
    """qwen3-moe-30b-a3b at full width, 16 of its 48 layers: 16 prompts of
    1,024 into a 4,096-token cache, 16 decode steps; the expert loads and
    the assignments the capacity drops, at the checked prefill."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.moe import capacity
    moe, B, S = get_arch("qwen3-moe-30b-a3b").model.moe, 16, 1024
    E, K, C = moe.n_experts, moe.top_k, capacity(S, moe)
    loads, drops = [], []

    def record(expert_ids):
        ids = expert_ids.reshape(B, S * K).long()
        onehot = (ids[..., None] == torch.arange(E, device="cuda")).int()
        loads.append(onehot.sum((0, 1)))
        pos = ((torch.cumsum(onehot, 1) - 1) * onehot).sum(-1)
        drops.append(int((pos >= C).sum()))

    c = _serve_lm("qwen3-moe-30b-a3b", n_layers=16, B=B, S=S, pad_to=4096,
                  n_steps=16, check_batch=B, record_plan=record)
    loads_ = torch.stack(loads)                              # (layers, E)
    print(f"  expert load at the checked prefill ({B} x {S} tokens x top-{K}"
          f" = {B * S * K} assignments a layer, {E} experts, capacity "
          f"{C} a group): busiest {int(loads_.max())}, idlest "
          f"{int(loads_.min())} (mean {B * S * K / E:.0f}); dropped "
          f"{sum(drops)} of {B * S * K * len(drops)} over {len(drops)} "
          f"layers")
    print(f"  grouped GEMM launches by kernel: prefill wgmma "
          f"{c['prefill']['moe_gemm/wgmma']}, fused gate/up "
          f"{c['prefill']['moe_gemm/swiglu_wgmma']}, mma.sync "
          f"{c['prefill']['moe_gemm/mma_sync']}; decode window wgmma "
          f"{c['decode']['moe_gemm/wgmma']}, mma.sync "
          f"{c['decode']['moe_gemm/mma_sync']}")
    return {"decode_attention[qwen3-moe-30b-a3b]":
                c["decode"]["decode_attention"],
            "flash_attention_fwd[moe_prefill]":
                c["prefill"]["flash_attention_fwd"],
            "moe_gemm[prefill]": c["prefill"]["moe_gemm/wgmma"]
            + c["prefill"]["moe_gemm/swiglu_wgmma"],
            "moe_gemm[decode]": c["decode"]["moe_gemm/mma_sync"]}

def moonlight_phase():
    """moonlight-16b-a3b whole (27 layers: MLA, a dense first layer, 26
    dropless MoE layers; bf16 weights drawn as the benchmark draws them,
    ``bench/lib/weights.make_params``) through ``build_step``: a prefill of
    2 x 1,024 held call by call (each ``flash_fwd_mla`` call and each
    grouped GEMM against its plain version) and 2 decode steps through its
    latent cache; then the moonlight.prefill_8k cell's step, 8 prompts of
    8,192 into an 8,192 latent cache, counted (27 ``flash_fwd_mla``
    launches at head dim 192, 2 grouped GEMMs an MoE layer: gate and up
    fused, then down; 1 row dispatch and 1 row combine an MoE layer; every
    routed assignment through them) and timed, median of 3."""
    import torch
    from bench.lib.weights import make_params
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import build_step
    from repro_torch.models import moe as MOE, transformer as T
    arch, B, S, b, s, n_dec = "moonlight-16b-a3b", 8, 8192, 2, 1024, 2
    spec = get_arch(arch)
    cfg, recall = spec.model, spec.recall
    L, top_k = cfg.n_layers, cfg.moe.top_k
    n_moe = L - cfg.first_k_dense
    print(f"LM {arch} (bf16, full width and depth: d={cfg.d_model}, "
          f"{cfg.n_heads} MLA heads, latent {cfg.mla.kv_lora_rank}, q/k "
          f"{cfg.mla.qk_head_dim}, v {cfg.mla.v_head_dim}; {n_moe} MoE "
          f"layers of {cfg.moe.n_experts} x {cfg.moe.d_ff_expert}, top-"
          f"{top_k}; {cfg.n_params / 1e9:.2f} B params)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.no_grad():
        t0 = time.perf_counter()
        params = make_params(T.lm_schema(cfg, recall), seed=0,
                             dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        small = build_step(spec, ShapeConfig("p", "prefill", b, s),
                           pad_to=s + n_dec)
        dec = build_step(spec, ShapeConfig("d", "decode", b, s + n_dec))
        out = check_lm_calls(lambda: small.fn(params, tokens[:b, :s]),
                             f"one prefill of {b} x {s}")
        latent = out.pop("latent_cache")
        del out
        for i in range(n_dec):
            lengths = torch.full((b,), s + i + 1, dtype=torch.int32,
                                 device="cuda")
            logits, latent = dec.fn(params, tokens[:b, s + i], latent,
                                    lengths)
            if not torch.isfinite(logits).all():
                _fail(f"{arch} decode step {i}: non-finite logits")
        print(f"  {n_dec} decode steps through the latent cache: finite "
              "logits")
        del latent, logits
        torch.cuda.empty_cache()
        pre = build_step(spec, ShapeConfig("prefill", "prefill", B, S),
                         pad_to=S)
        _reset_launches()
        MOE.reset_counters()
        t0 = time.perf_counter()
        out = pre.fn(params, tokens)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        counts = _lm_launches()
        by_dim = dict(flash_ops.launches_by_head_dim)
        routed = MOE.read_counters()
        lat, embs = out["latent_cache"], out["exit_embs"]
        n_exits = len(recall.exit_layers(L))
        if tuple(lat.shape) != (L, B, S, cfg.mla.latent_dim):
            _fail(f"{arch} prefill: latent cache {tuple(lat.shape)}")
        if tuple(embs.shape) != (n_exits, B, 1024) or \
                not torch.isfinite(embs).all():
            _fail(f"{arch} prefill: exit embeddings {tuple(embs.shape)} "
                  f"not finite or not ({n_exits}, {B}, 1024)")
        del out, lat, embs
        for _ in range(2):
            t0 = time.perf_counter()
            pre.fn(params, tokens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    t_pre = statistics.median(walls)
    print(f"  init {t_init:.2f} s; prefill {B} x {S}: {t_pre:.3f} s "
          f"(median of {', '.join(f'{w:.3f}' for w in walls)}) = "
          f"{B * S / t_pre:.0f} tokens/s; launches (first run) {counts}, "
          f"flash by head dim {by_dim}; routed {routed}")
    for name, got, want in (
            ("flash_fwd_mla (head dim 192)", by_dim.get(192, 0), L),
            ("flash_attention_fwd", counts["flash_attention_fwd"], L),
            ("moe_gemm", counts["moe_gemm"], 2 * n_moe),
            ("moe_gemm/swiglu_wgmma", counts["moe_gemm/swiglu_wgmma"],
             n_moe),
            ("moe_gemm/wgmma", counts["moe_gemm/wgmma"], n_moe),
            ("moe_rows/dispatch", counts["moe_rows/dispatch"], n_moe),
            ("moe_rows/combine", counts["moe_rows/combine"], n_moe),
            ("MoE layer calls", routed["calls"], n_moe),
            ("routed assignments", routed["assignments"],
             n_moe * B * S * top_k)):
        if got != want:
            _fail(f"{arch} prefill of {B} x {S}: {name} {got}, not {want}")
    if not 0 < routed["max_load"] <= B * S:
        _fail(f"{arch} prefill: largest expert load {routed['max_load']}")
    del params
    torch.cuda.empty_cache()
    return {"flash_attention_fwd[mla_prefill]": by_dim.get(192, 0),
            "moe_gemm[moonlight]": counts["moe_gemm"],
            "moe_dispatch_rows": counts["moe_rows/dispatch"],
            "moe_combine_rows": counts["moe_rows/combine"]}


# ---------------------------------------------------------------------------
# P-LoRA healing on the card: the backward kernels, heal_tower, healed
# serving, heal_lm
# ---------------------------------------------------------------------------

# the backward rows of the kernels line (the heal phase fills them)
HEAL_ROWS: list = []


def _grad_err(got, want):
    """(max abs err, largest share of the per-element limit ``bwd_limit``,
    max abs err over the tensor's largest |element|) of one gradient."""
    import torch
    from repro_torch.kernels.flash_attention.ref import bwd_limit
    w = want.float() if want.dtype == torch.float32 else want
    diff = (got.float() - want.float()).abs()
    scale = max(want.float().abs().max().item(), 1e-30)
    return (diff.max().item(), (diff / bwd_limit(w)).max().item(),
            diff.max().item() / scale)


def _on_side_stream(forward):
    """(``forward()`` run on a new stream, that stream): an autograd
    backward runs on its forward's stream, so a CUDA graph captures it on
    that one (``graph_time_ms(..., stream=)``)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    torch.cuda.current_stream().wait_stream(side)
    return out, side


def check_flash_bwd(gen):
    """The flash backward (f32: delta, the one-pass kernel and the dQ
    key-tile sum; bf16: the dQ and dK/dV wgmma kernels) against the plain
    ``attention_bwd_reference`` at the forward kernel's out and lse: the
    heal shape (vision tower, B 32, fp32), the text tower's (B 64, bf16),
    qwen2-1.5b's prefill (B 2, causal, GQA 6:1, bf16), its heal_lm
    batch (B 8, S 512) and its train microbatch (B 1, S 4,096), per element
    within ``ref.bwd_limit`` (1e-5 at max(|g|, 1) fp32, one bf16 step
    bf16) and against a float64 backward by ``ref.bwd_rel_err`` (held at
    every shape within ``ref.REL_MULTIPLE`` times the plain version's: below
    |g| = 1 the bf16 ``bwd_limit`` is an absolute 2^-7); timed eager
    and by graph replay beside the plain version and SDPA's backward
    (autograd of ``F.scaled_dot_product_attention``, for comparison only),
    and profiled for the split between its kernels."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_bwd_cuda,
                                                            flash_fwd_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        REL_MULTIPLE, attention_bwd_reference, attention_mask, bwd_rel_err)
    row, side = None, {}
    for what, B, S, H, KV, D, dtype, causal in (
            ("heal", 32, 257, 16, 16, 80, torch.float32, False),
            ("text", 64, 78, 16, 16, 64, torch.bfloat16, False),
            ("lm", 2, 2048, 12, 2, 128, torch.bfloat16, True),
            ("heal_lm", 8, 512, 12, 2, 128, torch.bfloat16, True),
            ("train", 1, 4096, 12, 2, 128, torch.bfloat16, True)):
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, KV, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        out, lse = flash_fwd_cuda(q, k, v, causal=causal)
        got = flash_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        want = attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
        again = flash_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        errs = [_grad_err(g, w) for g, w in zip(got, want)]
        err, over = max(e[0] for e in errs), max(e[1] for e in errs)
        if not over <= 1.0:
            _fail(f"flash backward {what}: err {err} ({over:.3f} of the "
                  "per-element limit)")
        # the typical |g| of dq, dk, dv: below 1 the bf16 limit is 2^-7
        med = "/".join(f"{w.float().abs().median().item():.3g}"
                       for w in want)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            _fail(f"flash backward {what}: two runs differ")
        # each element's error against a float64 backward, kernel and plain
        g64 = attention_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                      compute_dtype=torch.float64,
                                      grad_dtype=torch.float64)
        rel = [bwd_rel_err(g, w) for g, w in zip(got, g64)]
        rel_plain = [bwd_rel_err(g, w) for g, w in zip(want, g64)]
        del g64
        rel_txt = "/".join(f"{a:.2e} (plain {b:.2e})"
                           for a, b in zip(rel, rel_plain))
        if not all(a <= REL_MULTIPLE * b for a, b in zip(rel, rel_plain)):
            _fail(f"flash backward {what}: error against float64 relative "
                  f"to each element, dq/dk/dv {rel_txt}, over "
                  f"{REL_MULTIPLE} times the plain version's")
        kernel = lambda: flash_bwd_cuda(q, k, v, out, lse, do, causal=causal)
        ms, graph_ms = time_ms(kernel, reps=5), graph_time_ms(kernel, reps=5)
        plain_ms = time_ms(lambda: attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal), reps=1, trials=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        do_t = do.transpose(1, 2).contiguous()
        o_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=KV != H)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do_t, retain_graph=True), reps=5)

        def sdpa():  # fresh leaves: the graph's own AccumulateGrad nodes
            leaves = tuple(x.detach().clone().requires_grad_()
                           for x in (qt, kt, vt))
            return F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=KV != H), leaves
        (o_g, leaves), lib_stream = _on_side_stream(sdpa)
        lib_graph_ms = graph_time_ms(lambda: torch.autograd.grad(
            o_g, leaves, do_t, retain_graph=True), reps=5, stream=lib_stream)
        pairs = int(attention_mask(S, S, causal=causal, window=0, q_offset=0,
                                   device="cuda").sum())
        n_ops = 5 * 2.0 * B * H * pairs * D
        # q, out, dout read and dq written; k, v read and dk, dv written;
        # lse read
        n_bytes = 4 * (B * S * H * D + B * S * KV * D) * q.element_size() \
            + B * H * S * 4
        b_ms, b_by = bound_ms(n_bytes, n_ops, "fp32" if dtype ==
                              torch.float32 else "bf16")
        print(f"  flash backward {what} B={B} S={S} H={H} KV={KV} D={D} "
              f"{str(dtype)[6:]}{' causal' if causal else ''}: max_abs_err "
              f"{err:.3e} ({over:.2f} of the per-element limit, "
              f"{max(e[2] for e in errs):.1e} of the largest gradient; "
              f"median |g| dq/dk/dv {med}; against float64 relative to "
              f"each element dq/dk/dv {rel_txt}), the same bits twice; kernel "
              f"{ms:.4f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s), graph replay "
              f"{graph_ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA backward "
              f"{lib_ms:.4f} ms (graph replay {lib_graph_ms:.4f} ms), bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / graph_ms:.1%} of it by "
              f"replay)")
        # the split between the backward's kernels
        profile_windows(((f"flash backward {what}", kernel, "bwd"),))
        m = {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
             "library_graph_ms": lib_graph_ms, "max_abs_err": err,
             "rel_err": max(rel), "plain_rel_err": max(rel_plain)}
        if what == "heal":
            row = {"name": "flash_attention_bwd", "route": "cuda",
                   "source": "src/repro_torch/kernels/flash_attention/csrc/"
                             "flash_bwd.cu",
                   "replaces": "src/repro/kernels/flash_attention/ops.py:118",
                   **m}
        else:
            side[what] = m
        del q, k, v, do, out, lse, got, want, again, qt, kt, vt, o_t, do_t
        del o_g, leaves, kernel
        torch.cuda.empty_cache()
    row["side"] = side
    return row


def check_rmsnorm_bwd(gen):
    """The Triton RMSNorm backward against ``rmsnorm_bwd_reference``: dx
    per element within ``bwd_limit``, dscale (a sum over rows) within 1e-5
    (fp32) or one bf16 step (bf16) of its largest element, at the heal
    step's norms (32 x 257 rows of 1,280, fp32) and qwen2's (4,096 rows of
    1,536, bf16); timed eager, by graph replay and by host time a call,
    beside the plain version and autograd of ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_triton
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_reference
    row, side = None, {}
    for what, rows_, D, dtype in (("heal", 32 * 257, 1280, torch.float32),
                                  ("lm", 4096, 1536, torch.bfloat16)):
        x = (torch.randn((rows_, D), generator=gen, device="cuda") * 3).to(
            dtype)
        s = (1 + 0.1 * torch.randn((D,), generator=gen,
                                   device="cuda")).to(dtype)
        dy = torch.randn((rows_, D), generator=gen, device="cuda").to(dtype)
        dx, ds = rmsnorm_bwd_triton(x, s, dy, 1e-6)
        dx2, ds2 = rmsnorm_bwd_triton(x, s, dy, 1e-6)
        dx_p, ds_p = rmsnorm_bwd_reference(x, s, dy, 1e-6)
        torch.cuda.synchronize()
        err, over, _ = _grad_err(dx, dx_p)
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        ds_err = (ds.float() - ds_p.float()).abs().max().item()
        ds_lim = rel * max(1.0, ds_p.float().abs().max().item())
        if not (over <= 1.0 and ds_err <= ds_lim):
            _fail(f"rmsnorm backward {what}: dx err {err} ({over:.3f} of "
                  f"the limit), dscale err {ds_err} (tol {ds_lim})")
        if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
            _fail(f"rmsnorm backward {what}: two runs differ")
        kernel = lambda: rmsnorm_bwd_triton(x, s, dy, 1e-6)
        ms, graph_ms = time_ms(kernel, reps=20), graph_time_ms(kernel)
        host_us = dispatch_us(kernel)
        plain_ms = time_ms(lambda: rmsnorm_bwd_reference(x, s, dy, 1e-6),
                           reps=5)
        def norm():  # fresh leaves: the graph's own AccumulateGrad nodes
            xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
            return F.rms_norm(xl, (D,), sl, 1e-6), (xl, sl)
        yl, leaves = norm()
        library = lambda: torch.autograd.grad(yl, leaves, dy,
                                              retain_graph=True)
        lib_ms, lib_host_us = time_ms(library, reps=20), dispatch_us(library)
        (yl, leaves), lib_stream = _on_side_stream(norm)
        lib_graph_ms = graph_time_ms(library, stream=lib_stream)
        esz = x.element_size()
        b_ms, b_by = bound_ms(3 * rows_ * D * esz + 2 * D * esz,
                              10.0 * rows_ * D, "fp32")
        print(f"  rmsnorm backward {what} ({rows_}, {D}) "
              f"{str(dtype)[6:]}: dx max_abs_err {err:.3e} ({over:.2f} of "
              f"the per-element limit), dscale err {ds_err:.3e} (tol "
              f"{ds_lim:.1e}), the same bits twice; kernel {ms:.4f} ms "
              f"(graph replay {graph_ms:.4f} ms, host {host_us:.1f} us a "
              f"call), plain {plain_ms:.4f} ms, autograd of F.rms_norm "
              f"{lib_ms:.4f} ms (graph replay {lib_graph_ms:.4f} ms, host "
              f"{lib_host_us:.1f} us), bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / graph_ms:.1%} of it by replay)")
        m = {"ms": ms, "graph_ms": graph_ms, "host_us": host_us,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
             "library_host_us": lib_host_us, "max_abs_err": err}
        if what == "heal":
            row = {"name": "rmsnorm_bwd", "route": "triton",
                   "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
                   "replaces": "src/repro/models/layers.py:91 (autodiff of "
                               "rmsnorm; no Pallas backward)", **m}
        else:
            side[what] = m
        del x, s, dy, dx, dx2, dx_p, yl, leaves, kernel, library
        torch.cuda.empty_cache()
    row["side"] = side
    return row


def _moe_dx64(dys, block_expert, w, block_t, used):
    """The gradient of xs as a float64 product over each expert's group."""
    import torch
    from repro_torch.kernels.moe_gemm.ref import _groups
    dx = torch.zeros((dys.shape[0], w.shape[1]), dtype=torch.float64,
                     device=dys.device)
    for e, r0, r1 in _groups(block_expert, block_t, used):
        dx[r0:r1] = dys[r0:r1].double() @ w[e].double().T
    return dx


def _moe_dw64(xs, dys, block_expert, ends, block_t, used):
    """The gradient of w as a float64 product over each expert's group."""
    import torch
    from repro_torch.kernels.moe_gemm.ref import _groups
    dw = torch.zeros((ends.shape[0], xs.shape[1], dys.shape[1]),
                     dtype=torch.float64, device=xs.device)
    for e, r0, r1 in _groups(block_expert, block_t, used):
        dw[e] = xs[r0:r1].double().T @ dys[r0:r1].double()
    return dw


def _moe_bwd_gate(what, got, plain, g64):
    """A grouped-GEMM gradient against its plain version: finite; bf16
    within one bf16 step of each element at max(|g|, 1) (f32 within 1e-5
    of the tensor's largest element); against the float64 product relative
    to each element (``ref.bwd_rel_err``) within ``REL_MULTIPLE`` times the
    plain version's. Returns (share of the first limit, kernel / plain
    float64-relative error, that error)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import (REL_MULTIPLE,
                                                         bwd_limit,
                                                         bwd_rel_err)
    diff = (got.float() - plain.float()).abs()
    if got.dtype == torch.bfloat16:
        over = (diff / bwd_limit(plain)).max().item()
    else:
        over = diff.max().item() / (1e-5 * max(
            plain.float().abs().max().item(), 1e-30))
    rel, rel_p = bwd_rel_err(got, g64), bwd_rel_err(plain, g64)
    ratio = rel / max(rel_p, 1e-300)
    if not (bool(torch.isfinite(got).all()) and over <= 1.0
            and rel <= REL_MULTIPLE * rel_p):
        _fail(f"{what}: {over:.3f} of the per-element limit; against "
              f"float64 relative to each element {rel:.3e}, the plain "
              f"version's {rel_p:.3e} (at most {REL_MULTIPLE} times); "
              f"finite {bool(torch.isfinite(got).all())}")
    return over, ratio, rel


def check_moe_gemm_bwd(gen):
    """The grouped GEMM's backward kernels (dX and dW on the kernels
    ``kernel_for`` picks: the persistent ``moe_gemm_dx_wgmma`` and
    ``moe_gemm_dw_wgmma`` here; the old ``mma.sync`` dW kernel beside its
    successor, gated and timed alike) against their plain
    versions and float64 products (``_moe_bwd_gate``)
    at a qwen3-moe train microbatch's shapes, which heal_lm's batch
    shares (1 x 4,096 or 8 x 512 tokens x top-8 = 32,768 assignments, E
    128, d 2,048, F 768, token block 128): gate/up (w (E, 2048, 768)) and
    down (w (E, 768, 2048)), with NaN in xs and dys from ``used`` on (dX
    writes 0 there, dW reads nothing) and the same bits twice; timed eager
    and by graph replay beside the plain version and ``torch._grouped_mm``
    (timing only). Returns the two rows."""
    import torch
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import (kernel_for,
                                                     moe_gemm_cuda,
                                                     moe_gemm_dw_cuda)
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference)
    bf16 = torch.bfloat16
    T, E = 32768, 128
    rows = {}
    for what, d, F in (("gate/up", 2048, 768), ("down", 768, 2048)):
        bt = ops.block_t_for(T, E)
        ids = torch.randint(0, E, (T,), generator=gen, device="cuda",
                            dtype=torch.int32)
        p = ops.plan(ids, E, bt)
        n = int(p.used)
        xs = ops.scatter_rows(torch.randn((T, d), generator=gen,
                                          device="cuda").to(bf16), p)
        dys = ops.scatter_rows(torch.randn((T, F), generator=gen,
                                           device="cuda").to(bf16), p)
        w = (torch.randn((E, d, F), generator=gen, device="cuda")
             * d ** -0.5).to(bf16)
        xs[n:] = float("nan")
        dys[n:] = float("nan")
        e_used = int((p.ends > torch.cat([p.ends.new_zeros(1),
                                          p.ends[:-1]])).sum())
        n_ops = 2.0 * T * d * F
        offs = p.ends
        cases = {
            "dx": (lambda: moe_gemm_cuda(dys, p.block_expert, w, bt, p.used,
                                         dx=True),
                   lambda: moe_gemm_sorted_dx_reference(
                       dys, p.block_expert, w, bt, p.used),
                   lambda: _moe_dx64(dys, p.block_expert, w, bt, p.used),
                   # dys rows read, the used experts' w, dX written
                   (T * F + e_used * d * F + T * d) * 2,
                   [lambda: torch._grouped_mm(dys[:n], w.transpose(1, 2),
                                              offs=offs),
                    lambda: torch._grouped_mm(
                        dys[:n], w.transpose(1, 2).contiguous(), offs=offs)]),
            "dw": (lambda: moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used),
                   lambda: moe_gemm_sorted_dw_reference(
                       xs, dys, p.block_expert, E, bt, p.used),
                   lambda: _moe_dw64(xs, dys, p.block_expert, p.ends, bt,
                                     p.used),
                   # xs and dys rows read, all of dW written
                   (T * d + T * F + E * d * F) * 2,
                   [lambda: torch._grouped_mm(xs[:n].t(), dys[:n],
                                              offs=offs),
                    lambda: torch._grouped_mm(xs[:n].t().contiguous(),
                                              dys[:n], offs=offs)])}
        for kind, (kernel, plain, exact, n_bytes, library) in cases.items():
            got, again = kernel(), kernel()
            want = plain()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                _fail(f"moe_gemm backward {kind} {what}: two runs differ")
            if kind == "dx" and got[n:].any():
                _fail(f"moe_gemm backward dx {what}: rows from used on "
                      "are not 0")
            over, ratio, rel = _moe_bwd_gate(
                f"moe_gemm backward {kind} {what}", got, want, exact())
            err = (got.float() - want.float()).abs().max().item()
            del got, again, want
            ms = time_ms(kernel, reps=5)
            graph_ms = graph_time_ms(kernel, reps=5)
            plain_ms = time_ms(plain, reps=1, trials=3)
            lib_ms = None
            if hasattr(torch, "_grouped_mm"):
                for fn in library:
                    try:
                        fn()
                    except RuntimeError as e:  # a yardstick only
                        print(f"  torch._grouped_mm refused the {kind} "
                              f"case: {str(e).splitlines()[0][:160]}")
                        continue
                    lib_ms = time_ms(fn, reps=5)
                    break
            b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
            name = kernel_for(bf16, bt, d, F)
            fn_name = f"moe_gemm_{kind}_{name}"  # the C kernel if wgmma
            prior = {}
            if kind == "dw" and name != "mma_sync":  # its predecessor

                def old_kernel():
                    return moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used,
                                            kernel="mma_sync")
                got, again = old_kernel(), old_kernel()
                if not torch.equal(got, again):
                    _fail(f"moe_gemm backward dw {what} (mma_sync): two "
                          "runs differ")
                _moe_bwd_gate(f"moe_gemm backward dw {what} (mma_sync)",
                              got, plain(), exact())
                del got, again
                prior = {"mma_sync_ms": time_ms(old_kernel, reps=5),
                         "mma_sync_graph_ms": graph_time_ms(old_kernel,
                                                            reps=5)}
            print(f"  moe_gemm backward {kind} {what} T={T} d={d} F={F} "
                  f"E={E} (token block {bt}, rows {n} of {p.T_pad}, experts "
                  f"used {e_used}) bf16, {name} kernel ({fn_name}): "
                  f"max_abs_err "
                  f"{err:.3e} ({over:.2f} of the per-element limit, "
                  f"{ratio:.2f}x the plain version's float64-relative "
                  f"error {rel:.2e}), the same bits twice; kernel {ms:.4f} "
                  f"ms ({n_ops / ms / 1e9:.1f} TFLOP/s), graph replay "
                  f"{graph_ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"torch._grouped_mm "
                  + (f"{lib_ms:.4f} ms (kernel {ms / lib_ms:.2f}x it)"
                     if lib_ms is not None else "n/a")
                  + f", bound {b_ms:.4f} ms ({b_by}; operations alone "
                  f"{n_ops / _peaks()[1]['bf16'] * 1e3:.4f} ms), {b_ms / ms:.1%}"
                  f" of it ({b_ms / graph_ms:.1%} by replay)"
                  + (f"; the mma_sync dW kernel {prior['mma_sync_ms']:.4f} "
                     f"ms, graph replay {prior['mma_sync_graph_ms']:.4f} "
                     "ms, within its gates" if prior else ""))
            m = {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 "max_abs_err": err, "rel_err": rel, "rel_vs_plain": ratio,
                 "kernel": name, **prior}
            if what == "gate/up":
                rows[kind] = {
                    "name": f"moe_gemm_bwd_{kind}", "route": "cuda",
                    "source": "src/repro_torch/kernels/moe_gemm/csrc/"
                              "moe_gemm.cu",
                    "replaces": "src/repro/models/moe.py:84 (autodiff of "
                                "the expert einsums; no Pallas backward)",
                    **m, "side": {}}
            else:
                rows[kind]["side"][what] = m
        del xs, dys, w
        torch.cuda.empty_cache()
    return [rows["dx"], rows["dw"]]


def _bwd_launches() -> dict:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    return {"flash_attention_fwd": flash_ops.launches,
            "flash_attention_bwd": flash_ops.bwd_launches,
            "rmsnorm": rms_ops.launches, "rmsnorm_bwd": rms_ops.bwd_launches}


def _moe_launches() -> dict:
    """The grouped GEMM's forward launches and its backward's by kernel,
    beside ``_bwd_launches``'s (the MoE heal and train runs)."""
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    by = moe_ops.bwd_launches_by_kernel
    if sum(by.values()) != moe_ops.bwd_launches:
        _fail(f"moe_gemm backward launches {moe_ops.bwd_launches} != by "
              f"kernel {by}")
    return {**_bwd_launches(), "moe_gemm": moe_ops.launches,
            **{f"moe_gemm_bwd/{k}": by.get(k, 0)
               for k in ("dx_wgmma", "dx_mma_sync", "dw_wgmma",
                         "dw_mma_sync")}}


def _lora_leaves(lora):
    """A copy of ``lora`` whose leaves need a gradient, and the leaves."""
    leaves = {t: {k: v.detach().requires_grad_() for k, v in ab.items()}
              for t, ab in lora.items()}
    return leaves, [leaves[t][k] for t in leaves for k in leaves[t]]


def _flash_bwd_tc_scores(q, k, v, out, lse, do, *, causal=True, window=0,
                         q_offset=0, scale=None):
    """``ref.attention_bwd_reference`` (fp32) with S = Q K^T from cuBLAS's
    bf16 tensor-core matmul (fp32 accumulate and output) in place of fp32
    sums of the bf16 inputs: a plain version whose P falls on the side of
    each bf16 rounding that a tensor-core sum of S sends it to."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_mask
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    low = lambda x, dt: x.to(dt).float()
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.bmm(qg.permute(0, 2, 3, 1, 4).reshape(B * KV, G * Sq, D),
                  k.permute(0, 2, 3, 1).reshape(B * KV, D, Skv),
                  out_dtype=torch.float32).view(B, KV, G, Sq, Skv) * scale
    dog = do.reshape(B, Sq, KV, G, D)
    delta = (dog.float() * out.reshape(B, Sq, KV, G, D).float()).sum(-1)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqkgd,bjkd->bkgqj", low(dog, v.dtype), v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgqj,bjkd->bqkgd", low(ds, k.dtype), k.float())
    dk = torch.einsum("bkgqj,bqkgd->bjkd", low(ds, q.dtype), qg.float())
    dv = torch.einsum("bkgqj,bqkgd->bjkd", low(p, do.dtype),
                      low(dog, do.dtype))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_call_checker():
    """(both, worst, calls, tc): ``both(name, kernel_fn, plain_fn,
    witness_fn=None)`` wraps a backward dispatch (flash attention's or
    RMSNorm's) so that each call also runs the plain version on the same
    inputs, in fp32 and in float64, and fails when the kernel's gradients
    stray; ``worst`` collects each
    name's (largest share of its limit, largest kernel error against
    float64 over the largest gradient), ``calls`` the call counts.

    fp32 activations (a heal step): each gradient of the kernel within
    twice the fp32 plain version's own error against the plain version run
    in float64 (``compute_dtype``), or within 1e-5 of its largest element
    where that is larger, plus one bf16 step of the element for a bf16
    output (a norm's dscale in the scale's bf16, whose rounding may flip).
    (The per-element ``bwd_limit`` holds the random-input gates; on these
    activations the init's attention logits reach ~80, whose fp32 rounding
    alone puts ~5e-6 of relative error into P before dS = P (dP - delta)
    cancels, and a norm's dscale sums 8,224 rows that cancel to 1e-3 of
    their size, so an fp32 result's error follows the terms, not the
    result.)

    bf16 activations (an LM train step): each gradient per element within
    ``bwd_limit`` of the plain version (a dscale, a sum over rows, within
    one bf16 step of its largest element), and each element's error
    against the float64 gradient of the call's inputs, relative to the
    element (``ref.bwd_rel_err``), within ``ref.REL_MULTIPLE`` times the
    plain version's. That float64 gradient rounds nothing, unlike the
    g64 that ``bwd_rel_err`` documents and the kernel phase uses
    (``compute_dtype=grad_dtype=float64``, which keeps the plain
    version's roundings of P and dS to bf16). Where ``witness_fn`` is
    given (the flash backward), each bf16 call also reads the kernel's,
    the plain version's and the witness's error against that rounding
    yardstick, and fails where the kernel's passes ``REL_MULTIPLE`` times
    the witness's; ``tc`` collects the worst ratios to the plain
    version's. The witness is the plain version with S from a bf16
    tensor-core matmul, as the kernel sums it: on qwen2's train
    activations its ratio equals the kernel's (up to 5x at dV), so the
    kernel's excess over the plain version there is where a tensor-core
    S sends P's bf16 roundings, not a fault of the kernel."""
    import torch
    from repro_torch.kernels.flash_attention.ref import (REL_MULTIPLE,
                                                         bwd_limit,
                                                         bwd_rel_err)
    worst, calls, tc = {}, {}, {}

    def f32_gate(name, i, g, w, e):
        e = e.double()
        diff = (g.double() - e).abs()
        e_k = diff.max().item()
        e_p = (w.double() - e).abs().max().item()
        lim = max(2 * e_p, 1e-5 * e.abs().max().item())
        if g.dtype == torch.bfloat16:  # the output's own rounding
            diff = diff - 2.0 ** -7 * e.abs()
        if not diff.max().item() <= lim:
            _fail(f"{name} call {calls[name]} output {i} "
                  f"{tuple(g.shape)}: kernel err {e_k:.3e} "
                  f"against float64, the fp32 plain version's "
                  f"{e_p:.3e}, limit {lim:.3e}")
        return diff.max().item() / lim, e_k / e.abs().max().item()

    def bf16_gate(name, i, g, w, e):
        diff = (g.float() - w.float()).abs()
        if g.dim() == 1:  # a norm's dscale
            over = diff.max().item() / (2.0 ** -7 * max(
                1.0, w.float().abs().max().item()))
        else:
            over = (diff / bwd_limit(w)).max().item()
        rel_k, rel_p = bwd_rel_err(g, e), bwd_rel_err(w, e)
        if not (over <= 1.0 and rel_k <= REL_MULTIPLE * rel_p):
            _fail(f"{name} call {calls[name]} output {i} "
                  f"{tuple(g.shape)}: {over:.3f} of the per-element "
                  f"limit; against float64 relative to each element "
                  f"{rel_k:.3e}, the plain version's {rel_p:.3e} (at "
                  f"most {REL_MULTIPLE} times)")
        return max(over, rel_k / max(rel_p, 1e-300) / REL_MULTIPLE), \
            (g.double() - e.double()).abs().max().item() / max(
                e.double().abs().max().item(), 1e-300)

    def witness(name, args, kw, got, want, witness_fn):
        """Each output's kernel and witness errors against the rounding
        yardstick, over the plain version's; the worst kept in ``tc``."""
        rounded = plain_fn_of[name](*args, compute_dtype=torch.float64,
                                    grad_dtype=torch.float64, **kw)
        wit = witness_fn(*args, **kw)
        for i, (g, w, t, e) in enumerate(zip(got, want, wit, rounded)):
            rel_p = max(bwd_rel_err(w, e), 1e-300)
            rel_k, rel_t = bwd_rel_err(g, e), bwd_rel_err(t, e)
            if not rel_k <= REL_MULTIPLE * rel_t:
                _fail(f"{name} call {calls[name]} output {i} "
                      f"{tuple(g.shape)}: against the rounding float64 "
                      f"yardstick {rel_k:.3e}, the tensor-core-S witness's "
                      f"{rel_t:.3e} (at most {REL_MULTIPLE} times)")
            k_r, t_r = rel_k / rel_p, rel_t / rel_p
            old = tc.get((name, i), (0.0, 0.0, 0))
            if k_r > old[0]:
                old = (k_r, t_r, calls[name])
            tc[(name, i)] = old

    plain_fn_of = {}

    def both(name, kernel_fn, plain_fn, witness_fn=None):
        plain_fn_of[name] = plain_fn

        def run(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            calls[name] = calls.get(name, 0) + 1
            if args[0].dtype == torch.bfloat16:
                gate = bf16_gate
                exact = plain_fn(*(a.double() if torch.is_tensor(a) else a
                                   for a in args), **kw)
                if witness_fn is not None:
                    witness(name, args, kw, got, want, witness_fn)
            else:
                gate = f32_gate
                exact = plain_fn(*args, compute_dtype=torch.float64, **kw)
            for i, (g, w, e) in enumerate(zip(got, want, exact)):
                share, rel = gate(name, i, g, w, e)
                old = worst.get(name, (0.0, 0.0))
                worst[name] = (max(old[0], share), max(old[1], rel))
            return got
        return run
    return both, worst, calls, tc


def check_heal_step_calls(params, spec, lora, x):
    """Every backward kernel call of one heal step (the loss of every exit)
    against its plain version on the same inputs, both measured against
    the plain version run in float64 (``_bwd_call_checker``'s fp32
    gates)."""
    import torch
    from unittest import mock
    from repro_torch.core import healing as H
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_reference
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_reference
    cfg, rc = spec.model, spec.recall
    both, worst, calls, _ = _bwd_call_checker()

    n_exits = len(rc.exit_layers(cfg.tower("vision").n_layers))
    t = _vision_targets(params, spec, x)
    leaves, flat = _lora_leaves(lora)
    w = torch.full((n_exits,), 1.0 / n_exits, device="cuda")
    ones = torch.ones(n_exits, device="cuda")
    with mock.patch.object(flash_ops, "flash_attention_bwd",
                           both("flash_attention_bwd",
                                flash_ops.flash_attention_bwd,
                                attention_bwd_reference)), \
            mock.patch.object(rms_ops, "rmsnorm_bwd",
                              both("rmsnorm_bwd", rms_ops.rmsnorm_bwd,
                                   rmsnorm_bwd_reference)):
        loss = H.exit_distill_loss(
            H.tower_exit_embs(params, cfg, rc, "vision", x, leaves), t, w,
            ones)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
    print(f"  backward kernel calls of one heal step ({x.shape[0]} items, "
          f"every exit weighted) vs plain versions on the same inputs, "
          f"errors against the plain version in float64: {calls}; worst "
          "share of the limit / worst kernel error over the largest "
          "gradient: " + ", ".join(
              f"{k} {o:.2f} / {r:.1e}" for k, (o, r) in worst.items())
          + " (limit: twice the plain version's error, or 1e-5 of the "
          "largest gradient)")
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    print(f"  that step's LoRA gradient: |g| {norm:.3e} (the loss is bounded "
          "by 2; the init's near one-hot attention makes it this steep)")
    return calls


def _attention64(q, k, v, *, causal, window, **kw):
    """Plain attention for the float64 yardstick, differentiable by
    autograd (the vision tower's: no mask, one kv head a head)."""
    import torch
    if causal or window or q.shape[2] != k.shape[2]:
        _fail("the float64 yardstick takes the vision tower's attention only")
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / math.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _rmsnorm64(x, scale, eps=1e-6):
    import torch
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(x.dtype)


def check_heal_gradient(params, spec, lora, x):
    """The LoRA gradient of a heal step's loss through the kernels
    (forward and backward, fp32 activations) against autograd of plain
    float64 ops on the same weights (the exit head and the loss stay
    fp32), with the attention projections at fan-in d (``_fan_in_d``), so
    that the gradient is well conditioned: on the serving init its norm
    reads ~1e14 (``check_heal_step_calls`` prints it). Relative error of
    the whole gradient, tol 1e-3."""
    import torch
    from unittest import mock
    from repro_torch.core import healing as H
    from repro_torch.models import attention as ATT, layers

    def cast(tree, dt):
        if isinstance(tree, dict):
            return {k: cast(v, dt) for k, v in tree.items()}
        return tree.to(dt) if tree.is_floating_point() else tree

    cfg, rc = spec.model, spec.recall
    p32 = _fan_in_d(params)
    n_exits = len(rc.exit_layers(cfg.tower("vision").n_layers))
    w = torch.full((n_exits,), 1.0 / n_exits, device="cuda")
    ones = torch.ones(n_exits, device="cuda")
    t = _vision_targets(p32, spec, x)
    grads = {}
    for what, p, xx, dt in (("kernels", p32, x, torch.float32),
                            ("float64", cast(p32, torch.float64),
                             x.double(), torch.float64)):
        leaves, flat = _lora_leaves(cast(lora, dt))
        with contextlib.ExitStack() as stack:
            if dt == torch.float64:
                stack.enter_context(mock.patch.object(
                    ATT, "flash_attention", _attention64))
                stack.enter_context(mock.patch.object(
                    layers, "rmsnorm_op", _rmsnorm64))
            loss = H.exit_distill_loss(H.tower_exit_embs(
                p, cfg, rc, "vision", xx, leaves), t, w, ones)
            grads[what] = torch.autograd.grad(loss, flat)
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(grads["kernels"], grads["float64"]))
    den = sum(float((b.double() ** 2).sum()) for b in grads["float64"])
    rel = math.sqrt(num / den)
    print(f"  heal step gradient on fan-in d weights ({x.shape[0]} items, "
          f"every exit): kernels (fp32) vs autograd of plain float64 ops, "
          f"|g| {math.sqrt(den):.4e}, relative error {rel:.2e} (tol 1e-3)")
    if not rel <= 1e-3:
        _fail(f"heal step gradient through the kernels is off by {rel:.2e} "
              "of the float64 gradient")


def _vision_targets(params, spec, x):
    """The frozen fine-grained embeddings of ``x``, the heal targets."""
    import torch
    from repro_torch.models import imagebind as IB
    with torch.no_grad():
        return IB.mem_embed(params, spec.model, spec.recall, "vision", x)


def profile_heal_step(params, spec, lora, x):
    """One heal step's forward and backward (every exit weighted) under
    torch.profiler: device time by layer and the busy share."""
    import torch
    from repro_torch.core import healing as H
    cfg, rc = spec.model, spec.recall
    n_exits = len(rc.exit_layers(cfg.tower("vision").n_layers))
    t = _vision_targets(params, spec, x)
    w = torch.full((n_exits,), 1.0 / n_exits, device="cuda")
    ones = torch.ones(n_exits, device="cuda")

    def step():
        leaves, flat = _lora_leaves(lora)
        loss = H.exit_distill_loss(H.tower_exit_embs(
            params, cfg, rc, "vision", x, leaves), t, w, ones)
        torch.autograd.grad(loss, flat)

    profile_windows(((f"heal step of {x.shape[0]} items (forward and "
                      "backward)", step, "flash_bwd"),))


def profile_heal_lm_step(params, cfg, rc, tokens, must_see="flash_bwd"):
    """One heal_lm step's forward and backward (a fresh LoRA, every exit
    weighted) under torch.profiler: the flash backward's share of a bf16
    heal step (and the grouped GEMM's dX, ``must_see``, in a MoE one)."""
    import torch
    from repro_torch.core import healing as H
    from repro_torch.core import plora
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lora = plora.lora_init(gen, cfg, rc, device="cuda")
    n_exits = len(rc.exit_layers(cfg.n_layers))
    with torch.no_grad():
        out = T.forward_hidden(params, cfg, rc, tokens=tokens,
                               collect_pooled=True)
        t = T.exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
        del out
    w = torch.full((n_exits,), 1.0 / n_exits, device="cuda")
    ones = torch.ones(n_exits, device="cuda")

    def step():
        leaves, flat = _lora_leaves(lora)
        loss = H.exit_distill_loss(H.lm_exit_embs(params, cfg, rc, tokens,
                                                  leaves), t, w, ones)
        torch.autograd.grad(loss, flat)

    profile_windows(((f"heal_lm step of {tokens.shape[0]} x "
                      f"{tokens.shape[1]} tokens (forward and backward)",
                      step, must_see),))


def serve_healed(params, spec, lora, items, texts, k=10):
    """RECALL served with the healed LoRA: a predictor fit on the healed
    tower's exit labels, an EmbeddingEngine(lora=healed) draining
    ``items``, a QueryEngine (the text tower un-healed) running one
    query_batch that refines on the healed tower; then one forward with the
    LoRA held call by call against the plain versions, every exit
    compared."""
    import numpy as np
    import torch
    from repro_torch.core import preexit as PE
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.launch.serve import _calibrate
    from repro_torch.serving.engine import EmbeddingEngine
    from repro_torch.serving.query import QueryEngine
    cfg, rc = spec.model, spec.recall
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    t0 = time.perf_counter()
    sup, labels, n_exits = _calibrate(params, cfg, rc,
                                      torch.as_tensor(items[:64]).cuda(),
                                      lora)
    predictor, pstats = PE.train_predictor(gen, sup, labels,
                                           n_exits=n_exits,
                                           hidden=rc.predictor_hidden,
                                           steps=150)
    store = EmbeddingStore(cfg.embed_dim, device="cuda")
    engine = EmbeddingEngine(params, cfg, rc, lora=lora,
                             predictor_params=predictor, store=store,
                             device="cuda")
    query = QueryEngine(params, cfg, rc, store=store,
                        refine_fn=engine.refine_fn(), query_modality="text",
                        device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    _reset_launches()
    t0 = time.perf_counter()
    engine.submit_batch(np.arange(len(items)), items)
    stats = engine.drain()
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    in_drain = _read_launches(cfg)
    t0 = time.perf_counter()
    results = query.query_batch(texts, k=k)
    torch.cuda.synchronize()
    t_query = time.perf_counter() - t0
    launches = _read_launches(cfg)
    n_ref = sum(r.n_refined for r in results)
    print(f"  healed serving: predictor on the healed exits {pstats} "
          f"({t_build:.2f} s with the calibration); drain {len(items)} "
          f"items in {t_drain:.3f} s = {len(items) / t_drain:.1f} items/s, "
          f"avg layers {stats.avg_layers:.2f}; query_batch of {len(texts)} "
          f"in {t_query:.3f} s, {n_ref} refinements; launches {launches}")
    missing = [n for n in SERVE_KERNELS if launches[n] == 0]
    if missing:
        _fail(f"kernels never launched serving the healed LoRA: {missing}")
    if in_drain["int4_quant"] == 0 or \
            launches["int4_dequant"] == in_drain["int4_dequant"]:
        _fail("healed serving did not quantize in the drain or dequantize "
              "in the query_batch")
    _check_results(results, store, k)
    check_calls_vs_plain(params, spec, items[:4], None, lora=lora)
    return launches


def heal_lm_phase():
    """heal_lm on qwen2-1.5b at full width and depth (bf16: the causal GQA
    backward on a path), then on qwen3-moe-30b-a3b (``heal_lm_moe``).
    Returns the MoE run's launch counts."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import healing as H
    from repro_torch.models import transformer as T
    spec = get_arch("qwen2-1.5b")
    cfg, rc = spec.model, spec.recall
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    with torch.no_grad():
        params = T.lm_init(gen, cfg, rc, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (8, 512), generator=gen,
                           device="cuda", dtype=torch.int32)
    hc = H.HealConfig(batch=8, steps_per_phase=1)
    torch.cuda.reset_peak_memory_stats()
    before = _bwd_launches()
    t0 = time.perf_counter()
    lora, log = H.heal_lm(gen, params, cfg, rc, tokens, heal_cfg=hc,
                          device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in _bwd_launches().items()}
    L, n = cfg.n_layers, len(log) * hc.steps_per_phase
    want = {"flash_attention_fwd": (n + 1) * L, "flash_attention_bwd": n * L,
            "rmsnorm": (n + 1) * (2 * L + 1), "rmsnorm_bwd": n * 2 * L}
    print(f"  heal_lm qwen2-1.5b (bf16, {L} layers, tokens 8 x 512, batch 8, "
          f"1 step a phase): {len(log)} phases in {wall:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          + "; ".join(f"{p['window']} loss {p['loss_first']:.4f} "
                      f"{p['step_s']:.3f} s" for p in log)
          + f"; launches {got}")
    if got != want:
        _fail(f"heal_lm launches {got}, want {want}")
    if not all(math.isfinite(p["loss_first"]) for p in log):
        _fail(f"heal_lm: non-finite loss {log}")
    profile_heal_lm_step(params, cfg, rc, tokens)
    del params, lora, tokens
    torch.cuda.empty_cache()
    return heal_lm_moe(gen)


def heal_lm_moe(gen):
    """heal_lm on qwen3-moe-30b-a3b at full width and 16 of its 48 layers
    (the MoE phase's cut), at the qwen2 run's batch of 8 x 512 tokens, one
    step a phase: its gradient runs the grouped GEMM's dX kernel (32,768
    assignments: 128-row token blocks, the wgmma kernel) and no dW (the
    expert weights are frozen). Exact launches; finite losses; a profiled
    step. Returns the launch counts."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import healing as H
    from repro_torch.models import transformer as T
    moe = get_arch("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(moe.model, n_layers=16)
    rc = moe.recall
    with torch.no_grad():
        params = T.lm_init(gen, cfg, rc, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (8, 512), generator=gen,
                           device="cuda", dtype=torch.int32)
    hc = H.HealConfig(batch=8, steps_per_phase=1)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora, log = H.heal_lm(gen, params, cfg, rc, tokens, heal_cfg=hc,
                          device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _moe_launches()
    L, n = cfg.n_layers, len(log) * hc.steps_per_phase
    # the targets' forward (no gradient: gate and up fused, then down),
    # then per step every layer forward and backward: three grouped GEMMs a
    # layer each way, the backward's all dX
    want = {"flash_attention_fwd": (n + 1) * L, "flash_attention_bwd": n * L,
            "rmsnorm": (n + 1) * (2 * L + 1), "rmsnorm_bwd": n * 2 * L,
            "moe_gemm": 2 * L + n * 3 * L, "moe_gemm_bwd/dx_wgmma": n * 3 * L,
            "moe_gemm_bwd/dx_mma_sync": 0, "moe_gemm_bwd/dw_wgmma": 0,
            "moe_gemm_bwd/dw_mma_sync": 0}
    print(f"  heal_lm qwen3-moe-30b-a3b (bf16, {L} of "
          f"{moe.model.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
          f"{cfg.moe.d_ff_expert}; tokens 8 x 512, batch 8, 1 step a "
          f"phase): {len(log)} phases in {wall:.2f} s, peak "
          f"{peak / 2**30:.2f} GiB; "
          + "; ".join(f"{p['window']} loss {p['loss_first']:.4f} "
                      f"{p['step_s']:.3f} s" for p in log)
          + f"; launches {got}")
    if got != want:
        _fail(f"heal_lm MoE launches {got}, want {want}")
    if not all(math.isfinite(p["loss_first"]) for p in log):
        _fail(f"heal_lm MoE: non-finite loss {log}")
    leaves = [v for ab in lora.values() for v in ab.values()]
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        _fail("heal_lm MoE: the healed LoRA is not finite")
    profile_heal_lm_step(params, cfg, rc, tokens, "moe_gemm_dx_wgmma")
    del params, lora, tokens
    torch.cuda.empty_cache()
    return got


def heal_phase():
    """P-LoRA healing of recall-imagebind's vision tower at full width and
    depth (32 layers, d 1,280, S 257, fp32 activations): the backward
    kernels gated and timed, ``heal_tower`` over its six phases (batch 32,
    2 steps a phase) with exact launch counts, one step's backward calls
    held to the plain versions, a profiled step, RECALL served with the
    healed LoRA, then ``heal_lm``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import healing as H
    from repro_torch.data import synthetic as SYN
    from repro_torch.models import imagebind as IB
    spec = get_arch("recall-imagebind")
    cfg, rc = spec.model, spec.recall
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    print("heal: backward kernels vs plain versions:")
    HEAL_ROWS[:] = [check_flash_bwd(gen), check_rmsnorm_bwd(gen),
                    *check_moe_gemm_bwd(gen)]
    with torch.no_grad():
        params = IB.mem_init(gen, cfg, rc, device="cuda")
    data = SYN.multimodal_pairs(2, 64 + 128 + 16, cfg)
    vis, texts = data.items["vision"], data.items["text"]
    hc = H.HealConfig(batch=32, steps_per_phase=2)
    L = cfg.tower("vision").n_layers
    print(f"heal recall-imagebind vision tower ({L} layers, d="
          f"{cfg.tower('vision').d_model}, S={cfg.tower('vision').n_tokens + 1}"
          f", fp32 activations, bf16 weights): 64 items, batch {hc.batch} "
          f"(HealConfig's 64 cut to 32 for memory), {hc.steps_per_phase} "
          f"steps a phase")
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora, log = H.heal_tower(gen, params, cfg, rc, "vision", vis[:64],
                             heal_cfg=hc, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _bwd_launches()
    n = len(log) * hc.steps_per_phase
    # the targets' forward, then per step: flash forward and backward one a
    # layer; rmsnorm forward two a layer plus the exit head's, backward the
    # same less layer 0's first norm (its input, the frontend's output,
    # needs no gradient)
    want = {"flash_attention_fwd": (n + 1) * L, "flash_attention_bwd": n * L,
            "rmsnorm": (n + 1) * (2 * L + 1), "rmsnorm_bwd": n * 2 * L}
    for p in log:
        print(f"  phase {p['phase']} window {p['window']}: loss "
              f"{p['loss_first']:.5f} -> {p['loss_last']:.5f}, "
              f"{p['step_s']:.3f} s a step")
    print(f"  heal_tower: {n} steps in {wall:.2f} s (targets included), "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {got}")
    windows = [p["window"] for p in log]
    if windows != [(0, 4), (4, 8), (8, 12), (12, 16), (16, 24), (24, 32)]:
        _fail(f"heal_tower phases {windows}")
    if got != want:
        _fail(f"heal_tower launches {got}, want {want}")
    if not all(math.isfinite(p["loss_first"]) and
               math.isfinite(p["loss_last"]) for p in log):
        _fail(f"heal_tower: non-finite loss {log}")
    leaves = [v for ab in lora.values() for v in ab.values()]
    if not all(torch.isfinite(v).all() for v in leaves) or \
            all(bool((lora[t]["b"] == 0).all()) for t in lora):
        _fail("healed LoRA non-finite or its B matrices never moved")
    x = torch.as_tensor(vis[:32]).cuda()
    check_heal_step_calls(params, spec, lora, x)
    check_heal_gradient(params, spec, lora, x[:4])
    profile_heal_step(params, spec, lora, x)
    del x
    torch.cuda.empty_cache()
    serve_healed(params, spec, lora, vis[64:192], texts[192:208])
    del params, lora
    torch.cuda.empty_cache()
    moe_got = heal_lm_phase()
    return {"flash_attention_bwd": got["flash_attention_bwd"],
            "rmsnorm_bwd": got["rmsnorm_bwd"],
            "heal_lm_moe": moe_got}



# ---------------------------------------------------------------------------
# the training step (launch.train.train_loop) on the card
# ---------------------------------------------------------------------------


def _no_grad(fn):
    import torch

    def run(*args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)
    return run


def _train_step_launches(L: int, microbatches: int) -> dict:
    """The kernels' launches of one LM train step under remat: a
    microbatch runs L layers forward, then each layer again in the
    backward (flash one a layer, rmsnorm two), the final norm once, and
    the backward of each (the first norm's input, the embedding rows,
    needs its gradient too)."""
    return {"flash_attention_fwd": microbatches * 2 * L,
            "flash_attention_bwd": microbatches * L,
            "rmsnorm": microbatches * (2 * 2 * L + 1),
            "rmsnorm_bwd": microbatches * (2 * L + 1)}


def _mem_step_launches(cfg) -> dict:
    """The same for a contrastive MEM step over every tower (remat): each
    tower's layers twice forward and once backward, its exit head's norm
    once each way."""
    L = sum(t.n_layers for t in cfg.towers)
    n = len(cfg.towers)
    return {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "rmsnorm": 4 * L + n, "rmsnorm_bwd": 2 * L + n}


def check_train_step_calls(params, cfg, rc, mb, chunk):
    """Every kernel call of one LM microbatch's forward and backward under
    remat (the forward, the layers' recompute, the backward) against its
    plain version on the same inputs: the forward calls by
    ``_call_checker`` (one bf16 step of the output's scale), the backward
    calls by ``_bwd_call_checker``'s bf16 gates. Run it on weights with
    the attention at fan-in d (``_fan_in_d``): at the init's near one-hot
    attention (logits of std ~100) the plain version's own dK lies 0.7 of
    each element from a float64 backward with its roundings (qwen2 on the
    H100): the gradient there is rounding noise, and no gate against
    float64 holds a kernel to anything."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_reference
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_reference,
                                                 rmsnorm_reference)
    from repro_torch.models import attention as ATT, layers, transformer as T
    from repro_torch.optim.adamw import value_and_grad
    rel_tol = 2.0 ** -7
    fwd, f_worst, f_calls = _call_checker(rel_tol)
    bwd, b_worst, b_calls, tc = _bwd_call_checker()
    with mock.patch.object(ATT, "flash_attention",
                           fwd("flash_attention_fwd",
                               flash_ops.flash_attention,
                               _no_grad(_flash_plain))), \
            mock.patch.object(layers, "rmsnorm_op",
                              fwd("rmsnorm", rms_ops.rmsnorm_op,
                                  _no_grad(rmsnorm_reference))), \
            mock.patch.object(flash_ops, "flash_attention_bwd",
                              bwd("flash_attention_bwd",
                                  flash_ops.flash_attention_bwd,
                                  attention_bwd_reference,
                                  _flash_bwd_tc_scores)), \
            mock.patch.object(rms_ops, "rmsnorm_bwd",
                              bwd("rmsnorm_bwd", rms_ops.rmsnorm_bwd,
                                  rmsnorm_bwd_reference)):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b: T.lm_loss(p, cfg, rc, b["tokens"], b["labels"],
                                   remat=True, chunk=chunk)[0], params, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want = _train_step_launches(cfg.n_layers, 1)
    got = {**f_calls, **b_calls}
    if got != want:
        _fail(f"one microbatch's checked calls {got}, want {want}")
    if not torch.isfinite(loss):
        _fail(f"checked microbatch: loss {loss}")
    print(f"  kernel calls of one microbatch ({mb['tokens'].shape[0]} x "
          f"{mb['tokens'].shape[1]} tokens, remat, attention at fan-in d) vs "
          f"plain versions on the same inputs ({wall:.1f} s): {got}; forward "
          "worst error "
          + ", ".join(f"{k} {v:.2e}" for k, v in f_worst.items())
          + f" of the output's scale (tol {rel_tol:.2e}); backward worst "
          "share of its limit / kernel error against float64 over the "
          "largest gradient: " + ", ".join(
              f"{k} {o:.2f} / {r:.1e}" for k, (o, r) in b_worst.items()))
    print("  flash backward calls against the float64 backward that keeps "
          "the roundings of P and dS (bwd_rel_err's g64), over the plain "
          "version's error, worst call of each output: " + ", ".join(
              f"d{'qkv'[i]} kernel {k:.2f}x, tensor-core-S witness "
              f"{t:.2f}x (call {c})" for (_, i), (k, t, c) in
              sorted(tc.items())))
    del grads


def _finite_tree(tree) -> bool:
    from repro_torch.optim.adamw import _leaves
    import torch
    return all(bool(torch.isfinite(x).all()) for x in _leaves(tree))


def _report_train(what, out, tokens, flops, peak, smi, unit="tokens"):
    """Prints seconds a step (the median of the steps after the first,
    which pays for kernel builds and the allocator), throughput and model
    TFLOP/s."""
    warm = out["step_s"][1:] or out["step_s"]
    step = statistics.median(warm)
    print(f"  {what}: steps {', '.join(f'{t:.3f}' for t in out['step_s'])} "
          f"s (median after the first {step:.3f} s), {tokens / step:,.0f} "
          f"{unit}/s, model {flops / step / 1e12:.1f} TFLOP/s, losses "
          f"{', '.join(f'{x:.4f}' for x in out['losses'])}, grad norms "
          f"{', '.join(f'{x:.4g}' for x in out['grad_norms'])}, peak device "
          f"memory {peak / 2**30:.2f} GiB ({smi})")


def _grad_summary(grads) -> dict:
    """An LM gradient tree's float64 norm over its finite elements, its
    non-finite elements, its largest finite |element| and the float64 norm
    of each layer's share (the stacked layer leaves)."""
    import torch
    from repro_torch.optim.adamw import _leaves
    finite = lambda x: torch.nan_to_num(x.double(), nan=0.0, posinf=0.0,
                                        neginf=0.0)
    leaves = _leaves(grads)
    bad = sum(int((~torch.isfinite(x)).sum()) for x in leaves)
    sq = sum(float(finite(x).square().sum()) for x in leaves)
    big = max(float(finite(x).abs().max()) for x in leaves)
    layers = sum(finite(x).square().flatten(1).sum(1)
                 for x in _leaves(grads["layers"]))
    return {"norm64": math.sqrt(sq), "non_finite": bad, "max_abs": big,
            "layer_norms": layers.sqrt().tolist()}


def check_init_gradient(bundle, raw, batch):
    """One train step from the init itself (the reference's: q/k fan-in
    taken as H, attention logits of std ~100) three ways on the same
    batch: through the kernels, with the flash and RMSNorm backward
    kernels patched to their plain versions, and with every kernel
    patched to its plain version (autograd of plain ops). Prints each
    step's grad_norm (the optimizer's float32 sum of squares) and its
    gradient's float64 summary (``_grad_summary``). Fails where the
    kernels' grad_norm is finite and the plain backward's is not, or the
    other way round, or a plain path's is finite and the kernels' is not,
    and where the kernels' float64 norm or layer norms part from the plain
    backward's by more than a factor of 2. Returns the kernels'
    grad_norm."""
    import torch
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, attention_reference)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_reference,
                                                 rmsnorm_reference)
    from repro_torch.models import attention as ATT, layers
    from repro_torch.optim import adamw as A
    update = A.AdamW.update
    seen = {}

    def spy(self, grads, state, params, grad_mask=None):
        seen["grads"] = _grad_summary(grads)
        return update(self, grads, state, params, grad_mask)

    variants = (
        ("kernels", ()),
        ("plain backward", ((flash_ops, "flash_attention_bwd",
                             attention_bwd_reference),
                            (rms_ops, "rmsnorm_bwd", rmsnorm_bwd_reference))),
        ("plain forward and backward", ((ATT, "flash_attention",
                                         attention_reference),
                                        (layers, "rmsnorm_op",
                                         rmsnorm_reference))))
    res = {}
    for name, patches in variants:
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(A.AdamW, "update", spy))
            for mod, attr, fn in patches:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            t0 = time.perf_counter()
            m = bundle.fn(raw, A.AdamW().init(raw), batch)[2]
            gn, loss = float(m["grad_norm"]), float(m["loss"])
            del m
            wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        g = seen.pop("grads")
        res[name] = (gn, g)
        ln = g["layer_norms"]
        print(f"  one step from the init itself, {name} ({wall:.1f} s): "
              f"loss {loss:.4f}, grad_norm {gn}; gradient norm in float64 "
              f"{g['norm64']:.4e}, {g['non_finite']} non-finite elements, "
              f"largest |g| {g['max_abs']:.3e}; layer norms, first to "
              f"last: " + " ".join(f"{x:.1e}" for x in ln))
    k_gn, k = res["kernels"]
    pb_gn, pb = res["plain backward"]
    if math.isfinite(pb_gn) != math.isfinite(k_gn) or (
            math.isfinite(res["plain forward and backward"][0])
            and not math.isfinite(k_gn)):
        _fail(f"from the init the grad_norms part: kernels {k_gn}, "
              + ", ".join(f"{n} {res[n][0]}" for n in res if n != "kernels"))
    ratios = [a / b for a, b in zip(k["layer_norms"] + [k["norm64"]],
                                    pb["layer_norms"] + [pb["norm64"]])]
    if k["non_finite"] != pb["non_finite"] or not all(
            0.5 <= r <= 2.0 for r in ratios):
        _fail(f"from the init the kernels' gradient parts from the plain "
              f"backward's: non-finite {k['non_finite']} vs "
              f"{pb['non_finite']}, norm ratios (layers, then the whole) "
              f"{[round(r, 3) for r in ratios]}")
    print(f"  the kernels' gradient norm over the plain backward's: layers "
          f"{min(ratios[:-1]):.3f}-{max(ratios[:-1]):.3f}, whole "
          f"{ratios[-1]:.3f} (limit 0.5-2)")
    return k_gn


def _same_float(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def train_lm(smi):
    """(a) qwen2-1.5b at full width and depth: 3 ``train_loop`` steps of 8
    x 4,096 tokens (the train_4k cell's batch of 256 cut to 8), 8
    microbatches of one sequence (the reference's plan on one device),
    remat, from its own init; exact launches; the first step's grad_norm
    that of ``check_init_gradient``'s kernel step on the same batch;
    finite losses, moments and params; one microbatch's calls against the
    plain versions (on the init at fan-in d); a profiled step."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    spec = get_arch("qwen2-1.5b")
    cfg, rc = spec.model, spec.recall
    shape = dataclasses.replace(spec.shape("train_4k"), global_batch=8)
    bundle = S.build_step(spec, shape, device="cuda")
    n_mb = bundle.meta["microbatches"]
    if (n_mb, bundle.meta["mode"], bundle.meta["chunk"]) != \
            (8, "fsdp_seq", 4096):
        _fail(f"qwen2 train plan {bundle.meta}")
    n_data, steps = 24, 3
    first = ShardedLoader(TR.make_train_data(spec, shape, n_data, 0),
                          shape.global_batch, seed=0).take(1)[0]
    batch = {k: torch.as_tensor(v).cuda() for k, v in first.items()}
    raw = TR.init_params(spec, 0, bundle.meta["device"])
    init_gn = check_init_gradient(bundle, raw, batch)
    del raw
    torch.cuda.empty_cache()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = TR.train_loop(spec, shape, device="cuda", steps=steps,
                        n_data=n_data, log_every=0)
    torch.cuda.synchronize()
    got = _bwd_launches()
    want = {k: steps * v for k, v in
            _train_step_launches(cfg.n_layers, n_mb).items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"train qwen2-1.5b ({cfg.n_layers} layers, d {cfg.d_model}, bf16; "
          f"{shape.global_batch} x {shape.seq_len} tokens a step, the "
          f"train_4k batch of 256 cut to {shape.global_batch}; {n_mb} "
          f"microbatches, {bundle.meta['mode']}, chunk "
          f"{bundle.meta['chunk']}, remat, from its own init): launches "
          f"{got} ({want} wanted: per microbatch flash forward 2L with the "
          "recompute, backward L; rmsnorm forward 4L+1, backward 2L+1)")
    if got != want:
        _fail(f"qwen2 train launches {got}, want {want}")
    if not _same_float(out["grad_norms"][0], init_gn):
        _fail(f"train_loop's first grad_norm {out['grad_norms'][0]}, the "
              f"same step on the same batch {init_gn}")
    opt = out["opt_state"]
    if not (all(map(math.isfinite, out["losses"])) and opt.step == steps
            and _finite_tree(opt.m) and _finite_tree(opt.v)
            and _finite_tree(out["params"])):
        _fail(f"qwen2 train: non-finite losses, moments or params "
              f"{out['losses']}")
    _report_train("qwen2-1.5b train_loop", out,
                  shape.global_batch * shape.seq_len, bundle.model_flops,
                  peak, smi)
    params = out["params"]

    def one_step():  # the update's outputs dropped: the same step each run
        bundle.fn(params, opt, batch)

    profile_windows(((f"qwen2 train step, {shape.global_batch} x "
                      f"{shape.seq_len} tokens (forward, backward, update)",
                      one_step, "flash_bwd"),))
    del out, params, opt
    torch.cuda.empty_cache()
    data = TR.make_train_data(spec, shape, 1, seed=7)
    mb = {k: torch.as_tensor(v).cuda() for k, v in data.items()}
    check_train_step_calls(
        _fan_in_d(TR.init_params(spec, 0, bundle.meta["device"])), cfg, rc,
        mb, bundle.meta["chunk"])
    del batch, mb
    torch.cuda.empty_cache()
    return got


def train_checkpoint(smi):
    """(b) A checkpoint round trip on the card: qwen2-1.5b at full width
    with 2 layers, 2 ``train_loop`` steps from its own init saved at
    the end into a temporary directory, restored bit for bit, then a
    restart for 1 step whose loss equals the third step of an
    uninterrupted run."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train as TR
    from repro_torch.optim.adamw import _leaves
    full = get_arch("qwen2-1.5b")
    spec = dataclasses.replace(full, model=dataclasses.replace(
        full.model, n_layers=2))
    shape = dataclasses.replace(full.shape("train_4k"), global_batch=8)
    kw = dict(device="cuda", n_data=32, log_every=0, save_interval=100)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        first = TR.train_loop(spec, shape, steps=2, ckpt_dir=d, **kw)
        t_first = time.perf_counter() - t0
        ck = Checkpointer(d)
        if ck.all_steps() != [2]:
            _fail(f"checkpoint steps {ck.all_steps()}, want [2]")
        saved = {"params": first["params"], "opt": first["opt_state"]}
        t0 = time.perf_counter()
        restored, man = ck.restore(saved, device="cuda")
        t_restore = time.perf_counter() - t0
        leaves = lambda t: (_leaves(t["params"]) + _leaves(t["opt"].m)
                            + _leaves(t["opt"].v))
        bits = lambda x: x.view(torch.int16) if x.dtype == \
            torch.bfloat16 else x
        same = all(torch.equal(bits(a), bits(b))
                   for a, b in zip(leaves(restored), leaves(saved)))
        n_bytes = sum(x.numel() * x.element_size() for x in leaves(saved))
        loader = man["meta"]["loader"]
        if not (same and restored["opt"].step == 2 == man["step"]):
            _fail("the restored params, moments or step differ from the "
                  "saved ones")
        if loader != {"epoch": 0, "pos": 2 * shape.global_batch,
                      "seed": 0}:
            _fail(f"the saved loader state {loader}: not at the first "
                  "unconsumed batch")
        del first, saved, restored
        torch.cuda.empty_cache()
        resumed = TR.train_loop(spec, shape, steps=1, ckpt_dir=d, **kw)
        if resumed["final_step"] != 3 or ck.latest_step() != 3:
            _fail(f"resumed final_step {resumed['final_step']}, latest "
                  f"checkpoint {ck.latest_step()}")
        del resumed["params"], resumed["opt_state"]
        torch.cuda.empty_cache()
        whole = TR.train_loop(spec, shape, steps=3, **kw)
        a, b = resumed["losses"][0], whole["losses"][2]
        print(f"  checkpoint round trip (qwen2-1.5b at full width, 2 layers"
              f", {n_bytes / 1e9:.2f} GB of params and Adam state): 2 steps "
              f"and the save {t_first:.1f} s, restore {t_restore:.1f} s, "
              f"params/moments/step bit-equal, loader {loader}; the resumed "
              f"step's loss {a!r} against the uninterrupted run's third "
              f"{b!r} ({smi})")
        if a != b:
            _fail(f"the resumed step's loss {a!r} differs from the "
                  f"uninterrupted run's {b!r}")
        del whole
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()


def train_mem(smi):
    """(c) recall-imagebind's contrastive MEM step at full width (all four
    towers; vision, audio and IMU in fp32 activations, text in bf16), the
    heal_step cell's batch of 256, remat, from its own init: 2
    ``train_loop`` steps, exact launches, the logit scale's first moment
    moved; a profiled step."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    spec = get_arch("recall-imagebind")
    shape = spec.shape("heal_step")
    bundle = S.build_step(spec, shape, device="cuda")
    steps = 2
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = TR.train_loop(spec, shape, device="cuda", steps=steps,
                        n_data=shape.global_batch, log_every=0)
    torch.cuda.synchronize()
    got = _bwd_launches()
    want = {k: steps * v for k, v in _mem_step_launches(spec.model).items()}
    peak = torch.cuda.max_memory_allocated()
    towers = ", ".join(f"{t.modality} {t.n_layers} x {t.d_model}"
                       for t in spec.model.towers)
    print(f"train recall-imagebind contrastive ({towers}; batch "
          f"{shape.global_batch}, remat): launches {got} ({want} wanted)")
    if got != want:
        _fail(f"MEM train launches {got}, want {want}")
    m_ls = out["opt_state"].m["logit_scale"]
    if not (all(map(math.isfinite, out["losses"])) and
            _finite_tree(out["opt_state"].m) and
            _finite_tree(out["opt_state"].v) and float(m_ls) != 0.0):
        _fail(f"MEM train: losses {out['losses']}, logit_scale moment "
              f"{float(m_ls)}")
    _report_train("recall-imagebind train_loop", out, shape.global_batch,
                  bundle.model_flops, peak, smi, unit="items")
    print(f"  logit_scale first moment {float(m_ls):.3e}")
    params, opt = out["params"], out["opt_state"]
    batch = {k: torch.as_tensor(v).cuda() for k, v in TR.make_train_data(
        spec, shape, shape.global_batch, seed=9).items()}

    def one_step():  # the update's outputs dropped: the same step each run
        bundle.fn(params, opt, batch)

    profile_windows(((f"recall-imagebind contrastive step, batch "
                      f"{shape.global_batch} (forward, backward, update)",
                      one_step, "flash_bwd"),))
    del out, params, opt, batch
    torch.cuda.empty_cache()
    return got


def _moe_train_launches(L: int, microbatches: int) -> dict:
    """``_train_step_launches`` of a MoE LM step, and the grouped GEMM's:
    three a layer forward, again in the recompute, and in the backward three
    dX and three dW a layer (the 32,768-assignment microbatch's 128-row
    token blocks: both on the wgmma kernels), each a microbatch."""
    return {**_train_step_launches(L, microbatches),
            "moe_gemm": microbatches * 2 * 3 * L,
            "moe_gemm_bwd/dx_wgmma": microbatches * 3 * L,
            "moe_gemm_bwd/dx_mma_sync": 0,
            "moe_gemm_bwd/dw_wgmma": microbatches * 3 * L,
            "moe_gemm_bwd/dw_mma_sync": 0}


def check_moe_train_calls(params, cfg, rc, mb, chunk):
    """Every grouped-GEMM backward call of one MoE train microbatch (remat)
    against its plain version and a float64 product on the same inputs
    (``_moe_bwd_gate``): three dX and three dW a layer."""
    import torch
    from unittest import mock
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import value_and_grad
    worst, calls = {}, {"dx": 0, "dw": 0}
    dx_kernel, dw_kernel = moe_ops.moe_gemm_sorted_dx, moe_ops.moe_gemm_sorted_dw

    def note(kind, got, plain, exact):
        calls[kind] += 1
        over, ratio, _ = _moe_bwd_gate(f"moe_gemm backward {kind} call "
                                       f"{calls[kind]} {tuple(got.shape)}",
                                       got, plain, exact)
        old = worst.get(kind, (0.0, 0.0))
        worst[kind] = (max(old[0], over), max(old[1], ratio))
        return got

    def dx(dys, be, w, bt, used):
        return note("dx", dx_kernel(dys, be, w, bt, used),
                    moe_gemm_sorted_dx_reference(dys, be, w, bt, used),
                    _moe_dx64(dys, be, w, bt, used))

    def dw(xs, dys, be, ends, bt, used, dtype):
        return note("dw", dw_kernel(xs, dys, be, ends, bt, used, dtype),
                    moe_gemm_sorted_dw_reference(xs, dys, be, ends.shape[0],
                                                 bt, used, dtype),
                    _moe_dw64(xs, dys, be, ends, bt, used))

    with mock.patch.object(moe_ops, "moe_gemm_sorted_dx", dx), \
            mock.patch.object(moe_ops, "moe_gemm_sorted_dw", dw):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b: T.lm_loss(p, cfg, rc, b["tokens"], b["labels"],
                                   remat=True, chunk=chunk)[0], params, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want = {"dx": 3 * cfg.n_layers, "dw": 3 * cfg.n_layers}
    if calls != want:
        _fail(f"one MoE microbatch's grouped-GEMM backward calls {calls}, "
              f"want {want}")
    if not torch.isfinite(loss):
        _fail(f"checked MoE microbatch: loss {loss}")
    print(f"  grouped-GEMM backward calls of one microbatch "
          f"({mb['tokens'].shape[0]} x {mb['tokens'].shape[1]} tokens, "
          f"remat, attention at fan-in d) vs plain versions on the same "
          f"inputs ({wall:.1f} s): {calls}; worst share of the per-element "
          "limit / float64-relative error over the plain version's: "
          + ", ".join(f"{k} {o:.2f} / {r:.2f}x" for k, (o, r) in
                      worst.items()))
    del grads


def check_moe_init_step(bundle, raw, batch):
    """One qwen3-moe train step from the init through the kernels, and with
    the grouped GEMM's backward patched to its plain versions: grad norms
    finite alike or not finite alike (C.7), and where finite within 2x of
    each other. Returns the kernels' grad_norm."""
    import torch
    from unittest import mock
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference)
    from repro_torch.optim import adamw as A

    def plain_dw(xs, dys, be, ends, bt, used, dtype):
        return moe_gemm_sorted_dw_reference(xs, dys, be, ends.shape[0], bt,
                                            used, dtype)

    res = {}
    for name, patches in (("kernels", ()),
                          ("plain grouped-GEMM backward",
                           (("moe_gemm_sorted_dx",
                             moe_gemm_sorted_dx_reference),
                            ("moe_gemm_sorted_dw", plain_dw)))):
        with contextlib.ExitStack() as stack:
            for attr, fn in patches:
                stack.enter_context(mock.patch.object(moe_ops, attr, fn))
            t0 = time.perf_counter()
            m = bundle.fn(raw, A.AdamW().init(raw), batch)[2]
            gn, loss = float(m["grad_norm"]), float(m["loss"])
            del m
            wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        res[name] = gn
        print(f"  one MoE step from the init, {name} ({wall:.1f} s): loss "
              f"{loss:.4f}, grad_norm {gn}")
    k, p = res["kernels"], res["plain grouped-GEMM backward"]
    if math.isfinite(k) != math.isfinite(p) or (
            math.isfinite(k) and not 0.5 <= k / p <= 2.0):
        _fail(f"MoE step from the init: grad_norm {k} through the kernels, "
              f"{p} with the plain grouped-GEMM backward")
    return k


def train_moe(smi):
    """(d) qwen3-moe-30b-a3b at full width and 3 of its 48 layers (4 would
    pass 80 GB with the optimizer state): 2 ``train_loop`` steps of 8 x
    4,096 tokens (train_4k's S, qwen2's batch cut), the reference's plan
    (8 microbatches of one sequence), remat, from its own init; one step
    from the init held to the plain grouped-GEMM backward, then train_loop's
    first grad_norm that same step's; exact launches; one microbatch's
    grouped-GEMM backward calls held to their plain versions; a profiled
    step. Returns the launch counts."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    moe = get_arch("qwen3-moe-30b-a3b")
    spec = dataclasses.replace(moe, model=dataclasses.replace(
        moe.model, n_layers=3))
    cfg, rc = spec.model, spec.recall
    shape = dataclasses.replace(spec.shape("train_4k"), global_batch=8)
    bundle = S.build_step(spec, shape, device="cuda")
    n_mb = bundle.meta["microbatches"]
    if (n_mb, bundle.meta["mode"]) != (8, "fsdp_seq"):
        _fail(f"qwen3-moe train plan {bundle.meta}")
    n_data, steps = 16, 2
    first = ShardedLoader(TR.make_train_data(spec, shape, n_data, 0),
                          shape.global_batch, seed=0).take(1)[0]
    batch = {k: torch.as_tensor(v).cuda() for k, v in first.items()}
    raw = TR.init_params(spec, 0, bundle.meta["device"])
    init_gn = check_moe_init_step(bundle, raw, batch)
    del raw
    torch.cuda.empty_cache()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = TR.train_loop(spec, shape, device="cuda", steps=steps,
                        n_data=n_data, log_every=0)
    torch.cuda.synchronize()
    got = _moe_launches()
    want = {k: steps * v for k, v in
            _moe_train_launches(cfg.n_layers, n_mb).items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"train qwen3-moe-30b-a3b ({cfg.n_layers} of {moe.model.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of {cfg.moe.d_ff_expert}, bf16; "
          f"{shape.global_batch} x {shape.seq_len} tokens a step; {n_mb} "
          f"microbatches, {bundle.meta['mode']}, chunk "
          f"{bundle.meta['chunk']}, remat, from its own init): launches "
          f"{got} ({want} wanted)")
    if got != want:
        _fail(f"qwen3-moe train launches {got}, want {want}")
    if not _same_float(out["grad_norms"][0], init_gn):
        _fail(f"train_loop's first grad_norm {out['grad_norms'][0]}, the "
              f"same step on the same batch {init_gn}")
    opt = out["opt_state"]
    finite = all(map(math.isfinite, out["losses"] + out["grad_norms"]))
    if not (all(map(math.isfinite, out["losses"])) and opt.step == steps
            and _finite_tree(opt.m) and _finite_tree(opt.v)
            and _finite_tree(out["params"])):
        _fail(f"qwen3-moe train: non-finite losses, moments or params "
              f"{out['losses']}")
    _report_train("qwen3-moe-30b-a3b train_loop", out,
                  shape.global_batch * shape.seq_len, bundle.model_flops,
                  peak, smi)
    print(f"  losses and grad norms all finite: {finite}")
    params = out["params"]

    def one_step():  # the update's outputs dropped: the same step each run
        bundle.fn(params, opt, batch)

    profile_windows(((f"qwen3-moe train step, {shape.global_batch} x "
                      f"{shape.seq_len} tokens, {cfg.n_layers} layers "
                      "(forward, backward, update)", one_step,
                      "moe_gemm_dw_wgmma"),))
    del out, params, opt
    torch.cuda.empty_cache()
    data = TR.make_train_data(spec, shape, 1, seed=7)
    mb = {k: torch.as_tensor(v).cuda() for k, v in data.items()}
    check_moe_train_calls(
        _fan_in_d(TR.init_params(spec, 0, bundle.meta["device"])), cfg, rc,
        mb, bundle.meta["chunk"])
    del batch, mb
    torch.cuda.empty_cache()
    return got


def train_phase():
    """The training path on the card: (a) qwen2-1.5b's LM step at full
    width and depth, (b) a checkpoint round trip, (c) recall-imagebind's
    contrastive step at full width, (d) qwen3-moe-30b-a3b's step at full
    width. Returns the launch counts of (a), (c) and (d) (printed), and
    (d)'s grouped-GEMM backward counts under the kernel rows' names (the
    one path that runs both)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    lm_got = train_lm(smi)
    train_checkpoint(smi)
    mem_got = train_mem(smi)
    moe_got = train_moe(smi)
    print(f"train launches: qwen2-1.5b 3 steps {lm_got}; recall-imagebind "
          f"2 steps {mem_got}; qwen3-moe-30b-a3b 2 steps {moe_got}")
    return {"lm": lm_got, "mem": mem_got, "moe": moe_got,
            "moe_gemm_bwd_dx": moe_got["moe_gemm_bwd/dx_wgmma"],
            "moe_gemm_bwd_dw": moe_got["moe_gemm_bwd/dw_wgmma"]}


# ---------------------------------------------------------------------------
# the recsys and GNN families through build_step and train_loop
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("dlrm-mlperf", "bst", "sasrec", "dien")
# Cuts (PERF.md section 4). DLRM-MLPerf's 26 Criteo-1TB tables hold
# 187,767,399 rows, 89.5 GiB at 128 fp32, and training holds four times
# that (params, gradient, two moments): its five tables of 25.6M-40M rows
# are capped, every other table whole.
DLRM_TRAIN_ROWS = 4_000_000    # 24,063,992 rows, 11.47 GiB
DLRM_SERVE_ROWS = 16_000_000   # 84,063,992 rows, 40.08 GiB
REDDIT_NODES = 232_965  # minibatch_lg samples an sbm_graph of this many


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _capped(spec, rows: int):
    """``spec`` with each of its tables cut to at most ``rows`` rows."""
    import dataclasses
    m = spec.model
    return dataclasses.replace(spec, model=dataclasses.replace(
        m, table_vocabs=tuple(min(v, rows) for v in m.table_vocabs)))


def _digest(tree) -> list:
    """Per fp32 leaf, two wrapping int64 sums of its 32-bit words, plain
    and weighted by position, taken on the card in slices of 2^26: equal
    bits give equal digests, and one changed word changes both."""
    import torch
    from repro_torch.optim.adamw import _leaves
    out = []
    for x in _leaves(tree):
        if x.dtype != torch.float32:
            _fail(f"digest of a {x.dtype} leaf")
        w = x.detach().reshape(-1).view(torch.int32)
        s1 = s2 = None
        for i in range(0, w.numel(), 1 << 26):
            c = w[i:i + (1 << 26)].to(torch.int64)
            pos = torch.arange(i + 1, i + 1 + c.numel(), device=c.device)
            a, b = c.sum(), (c * pos).sum()
            s1, s2 = (a, b) if s1 is None else (s1 + a, s2 + b)
        out.append((int(s1), int(s2)) if s1 is not None else (0, 0))
    return out


def _draw_inputs(cfg, inputs, gen):
    """A recsys batch of ``inputs`` ({name: (shape, dtype)}) drawn on the
    card: ids uniform over their table, dense features and the candidate
    bank normal, labels Bernoulli(1/2)."""
    import torch
    vocab = {"hist": cfg.item_vocab, "target": cfg.item_vocab,
             "pos": cfg.item_vocab, "neg": cfg.item_vocab,
             "hist_cate": max(cfg.item_vocab // 100, 16),
             "target_cate": max(cfg.item_vocab // 100, 16)}
    out = {}
    for name, (shape, dtype) in inputs.items():
        if name == "sparse":
            out[name] = torch.stack([torch.randint(
                0, v, shape[:1], generator=gen, device="cuda",
                dtype=torch.int32) for v in cfg.table_vocabs], dim=1)
        elif name == "label":
            out[name] = (torch.rand(shape, generator=gen, device="cuda")
                         < 0.5).float()
        elif dtype == torch.int32:
            out[name] = torch.randint(0, vocab[name], shape, generator=gen,
                                      device="cuda", dtype=torch.int32)
        else:
            out[name] = torch.randn(shape, generator=gen, device="cuda")
    return out


def _gnn_arrays(shape, cfg, seed: int, big=None) -> dict:
    """numpy arrays of a ``gnn.Graph`` for ``shape``: an ``sbm_graph`` of
    its nodes at the degree its edge count gives, padded to its edges with
    masked ones (``graph_full``); ``global_batch`` of those stacked
    (``graph_batched``); or a subgraph sampled from ``big`` (an sbm_graph
    and its CSR) at the shape's seeds and fanout, padded to ``max_sizes``,
    the seeds' labels only (``graph_mini``)."""
    import numpy as np
    from repro_torch.data import sampler as SA
    from repro_torch.data import synthetic as SYN

    def full(s, N, E):
        g = SYN.sbm_graph(s, N, cfg.n_classes, cfg.d_feat,
                          avg_degree=E / (2 * N))
        e = len(g["src"])
        pad = lambda a: np.concatenate([a, np.zeros(E - e, a.dtype)])
        return {"node_feat": g["node_feat"], "src": pad(g["src"]),
                "dst": pad(g["dst"]), "node_mask": np.ones(N, np.float32),
                "edge_mask": pad(np.ones(e, np.float32)),
                "labels": g["labels"]}

    if shape.kind == "graph_full":
        return full(seed, shape.n_nodes, shape.n_edges)
    if shape.kind == "graph_batched":
        gs = [full(seed + i, shape.n_nodes, shape.n_edges)
              for i in range(shape.global_batch)]
        return {k: np.stack([g[k] for g in gs]) for k in gs[0]}
    g, csr = big
    rng = np.random.default_rng(seed)
    sub = SA.sample_subgraph(csr, rng.choice(csr.n_nodes, shape.batch_nodes,
                                             replace=False), shape.fanout,
                             rng)
    labels = np.full(len(sub.node_ids), -1, np.int32)
    labels[sub.seed_local] = g["labels"][sub.node_ids[sub.seed_local]]
    return {"node_feat": g["node_feat"][sub.node_ids], "src": sub.src,
            "dst": sub.dst, "node_mask": sub.node_mask,
            "edge_mask": sub.edge_mask, "labels": labels}


def _graph(arrays, device):
    import torch
    from repro_torch.models.gnn import Graph
    return Graph(*[torch.as_tensor(arrays[f]).to(device)
                   for f in Graph._fields])


def _family_inputs(spec, shape, bundle, seed):
    """``shape``'s step inputs at smoke size as numpy: the training data's
    first rows (recsys; a retrieval step also takes a normal candidate
    bank) or a graph (gnn)."""
    import numpy as np
    from repro_torch.data import sampler as SA
    from repro_torch.data import synthetic as SYN
    from repro_torch.launch import train as TR
    if spec.family == "gnn":
        cfg, big = bundle.meta["cfg"], None
        if shape.kind == "graph_mini":  # a 200-node graph to sample from
            g = SYN.sbm_graph(seed, 200, cfg.n_classes, cfg.d_feat)
            big = (g, SA.CSRGraph.from_edges(g["src"], g["dst"], 200))
        return _gnn_arrays(shape, cfg, seed, big)
    n = max(shape.global_batch, 1)
    data = TR.make_train_data(spec, shape, n, seed)
    out = {k: v for k, v in data.items() if k in bundle.meta["inputs"]}
    if shape.kind == "retrieval":
        C, D = bundle.meta["inputs"]["cand_bank"][0]
        out["cand_bank"] = np.random.default_rng(seed).standard_normal(
            (C, D)).astype(np.float32)
    return out


def _to(tree, device):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone()
    return {k: _to(v, device) for k, v in tree.items()}


def _hold_leaves(what, got, want, tol, lr=None):
    """Each leaf of ``got`` (on the card) within ``tol`` of the largest
    |element| of ``want``'s (on the CPU). An attention's key bias ``bk``
    has a zero gradient in exact arithmetic (q·bk shifts a softmax row by
    a constant), so its fp32 gradient is rounding noise whose sign Adam
    turns into a step of lr either way: after an update (``lr`` given) it
    is held within 2 lr."""
    from repro_torch.optim.adamw import _leaves
    import torch
    names = _leaf_names(want)
    worst = (0.0, "")
    for name, g, w in zip(names, _leaves(got), _leaves(want)):
        d = (g.detach().cpu().double() - w.double()).abs().max().item()
        if lr is not None and name.endswith("/bk"):
            if d > 2 * lr:
                _fail(f"{what}: {name} off by {d:.3e} > 2 lr")
            continue
        err = d / max(w.abs().max().item(), 1e-30)
        worst = max(worst, (err, name))
    if worst[0] > tol:
        _fail(f"{what}: {worst[1]} off by {worst[0]:.3e} of its scale "
              f"(limit {tol})")
    return worst


def _leaf_names(tree, prefix=""):
    import torch
    if isinstance(tree, torch.Tensor):
        return [prefix]
    return [n for k in tree for n in _leaf_names(tree[k], f"{prefix}/{k}")]


def families_parity() -> None:
    """Every kind of the five archs' smoke variants on the card and on the
    CPU from the same params and inputs, TF32 off: a train step's loss and
    grad norm within 1e-5 relative and its updated params within 1e-5 of
    each leaf's scale (``_hold_leaves``); serve outputs and retrieval
    scores within 1e-5 of their scale, the retrieval ids where the scores
    are apart."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_variant
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.optim.adamw import AdamW
    worst = []
    for arch in RECSYS_ARCHS + ("gatedgcn",):
        spec = smoke_variant(get_arch(arch))
        shapes = list(spec.shapes) + (
            [ShapeConfig("smoke_retrieval", "retrieval", global_batch=2,
                         n_candidates=300)] if spec.family == "recsys" else
            [ShapeConfig("smoke_mini", "graph_mini", batch_nodes=6,
                         fanout=(3, 2), d_feat=8),
             ShapeConfig("smoke_batched", "graph_batched", n_nodes=12,
                         n_edges=40, global_batch=3, d_feat=8)])
        for shape in shapes:
            what = f"{arch} {shape.name} card vs cpu"
            runs = {}
            for dev in ("cuda", "cpu"):
                bundle = S.build_step(spec, shape, device=dev)
                train = bundle.meta.get("train", False)
                arrays = _family_inputs(spec, shape, bundle, 1)
                params = _to(TR.init_params(spec, 0, "cpu", shape), dev)
                if spec.family == "gnn":
                    inputs = _graph(arrays, dev)
                else:
                    inputs = {k: torch.as_tensor(v).to(dev)
                              for k, v in arrays.items()}
                if train:
                    p, o, m = bundle.fn(params, AdamW().init(params), inputs)
                    runs[dev] = (p, {k: float(v) for k, v in m.items()})
                else:
                    runs[dev] = bundle.fn(params, inputs)
            if train:
                (pg, mg), (pc, mc) = runs["cuda"], runs["cpu"]
                for key in ("loss", "grad_norm"):
                    if abs(mg[key] - mc[key]) > 1e-5 * abs(mc[key]):
                        _fail(f"{what}: {key} {mg[key]!r} vs {mc[key]!r}")
                worst.append(_hold_leaves(what + " params", pg, pc, 1e-5,
                                          lr=mc["lr"])[0])
            elif shape.kind == "retrieval":
                (sg, ig), (sc, ic) = runs["cuda"], runs["cpu"]
                err = (sg.cpu() - sc).abs().max().item() / sc.abs().max()
                if err > 1e-5:
                    _fail(f"{what}: scores off by {err:.3e} of their scale")
                gap = (sc[:, 1:] - sc[:, :-1]).abs() > 1e-5 * sc.abs().max()
                sep = torch.ones_like(sc, dtype=torch.bool)
                sep[:, 1:] &= gap
                sep[:, :-1] &= gap
                if not torch.equal(ig.cpu()[sep], ic[sep]):
                    _fail(f"{what}: ids differ where scores are apart")
                worst.append(float(err))
            else:
                og, oc = runs["cuda"].cpu(), runs["cpu"]
                if not bool(((og > 0) & (og < 1)).all()):
                    _fail(f"{what}: serve outputs outside (0, 1)")
                err = (og - oc).abs().max().item()
                if err > 1e-5:
                    _fail(f"{what}: serve outputs off by {err:.3e}")
                worst.append(err)
    print(f"  families parity, card vs cpu at smoke size: "
          f"{len(worst)} cells, worst {max(worst):.3e} of scale "
          f"(limit 1e-5)")


def _timed_steps(bundle, make_state, inputs, n: int):
    """``n`` runs of one train step from ``make_state()`` (a fresh init
    and zero moments each time) on ``inputs``: each run's host seconds
    (call to loss read back), loss, grad norm and the digests of the
    params and moments it leaves; the init's params digest."""
    import torch
    out, init_dig = [], None
    for _ in range(n):
        params, opt = make_state()
        if init_dig is None:
            init_dig = _digest(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = bundle.fn(params, opt, inputs)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        out.append((dt, loss, float(m["grad_norm"]), _digest(params),
                    _digest(opt.m), _digest(opt.v)))
        del params, opt, m
    return out, init_dig


def _same_bits_twice(what, runs) -> None:
    a, b = runs[0][1:], runs[1][1:]
    if a != b:
        _fail(f"{what}: a step run twice from the same state and batch "
              f"gave other bits (losses {a[0]!r} / {b[0]!r}, grad norms "
              f"{a[1]!r} / {b[1]!r})")
    if not all(math.isfinite(x) for x in a[:2]):
        _fail(f"{what}: loss or grad norm not finite {a[:2]}")


def _profile_step(what, bundle, params, opt_state, inputs) -> None:
    """One train step of ``bundle`` from this state under the profiler
    (``profile_windows``; any kernel counts as seen)."""
    profile_windows(((what, lambda: bundle.fn(params, opt_state, inputs),
                      ""),))


def families_recsys(smi) -> None:
    """Each recsys arch at full width: the train step twice from the init
    on one ``train_batch`` (65,536) batch, the same bits; 3 ``train_loop``
    steps; ``serve_p99`` (512) and ``serve_bulk`` (262,144); one
    ``retrieval_cand`` query over 1,000,000 candidates. DLRM-MLPerf runs
    with its big tables capped (``DLRM_TRAIN_ROWS``, ``DLRM_SERVE_ROWS``).
    DLRM's and DIEN's train steps are profiled."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.optim.adamw import AdamW
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for arch in RECSYS_ARCHS:
        full = get_arch(arch)
        spec = _capped(full, DLRM_TRAIN_ROWS) if arch == "dlrm-mlperf" \
            else full
        shape = spec.shape("train_batch")
        B = shape.global_batch
        bundle = S.build_step(spec, shape, device=dev)
        data = TR.make_train_data(spec, shape, B, 0)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in data.items()
                 if k in bundle.meta["inputs"]}

        def fresh():
            p = TR.init_params(spec, 0, dev)
            return p, AdamW().init(p)

        torch.cuda.reset_peak_memory_stats()
        runs, init_dig = _timed_steps(bundle, fresh, batch, 2)
        _same_bits_twice(f"{arch} train step", runs)
        out = TR.train_loop(spec, shape, device=dev, steps=3, n_data=B,
                            log_every=0)
        peak = torch.cuda.max_memory_allocated()
        st = out["opt_state"]
        if not (all(map(math.isfinite, out["losses"] + out["grad_norms"]))
                and _finite_tree(out["params"]) and _finite_tree(st.m)
                and _finite_tree(st.v)):
            _fail(f"{arch}: train_loop left non-finite values")
        moved = [a != b for a, b in zip(_digest(out["params"]), init_dig)]
        if not all(moved):
            _fail(f"{arch}: {moved.count(False)} param leaves did not move")
        cut = (f"tables capped at {DLRM_TRAIN_ROWS:,} rows, "
               if arch == "dlrm-mlperf" else "")
        _report_train(f"{arch} train ({cut}batch {B:,}, 3 train_loop "
                      f"steps; a step from the init twice, the same bits, "
                      f"{runs[0][0]:.3f} / {runs[1][0]:.3f} s)", out, B,
                      bundle.model_flops, peak, smi, unit="examples")
        if arch in ("dlrm-mlperf", "dien"):
            _profile_step(f"{arch} train step, batch {B:,}", bundle,
                          out["params"], st, batch)
        del out, st, batch, data
        gc.collect()
        torch.cuda.empty_cache()

        sspec = _capped(full, DLRM_SERVE_ROWS) if arch == "dlrm-mlperf" \
            else full
        torch.cuda.reset_peak_memory_stats()
        params = TR.init_params(sspec, 0, dev)
        with torch.no_grad():
            line = []
            for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
                sh = sspec.shape(name)
                b = S.build_step(sspec, sh, device=dev)
                inputs = _draw_inputs(sspec.model, b.meta["inputs"], gen)
                res = b.fn(params, inputs)
                if sh.kind == "serve":
                    if not bool(((res > 0) & (res < 1)).all()):
                        _fail(f"{arch} {name}: outputs outside (0, 1)")
                    reps = 1 if name == "serve_bulk" else 3
                    ms = time_ms(lambda: b.fn(params, inputs), reps=reps,
                                 trials=3)
                    line.append(f"{name} (batch {sh.global_batch:,}) "
                                f"{ms:.3f} ms a call, "
                                f"{sh.global_batch / ms * 1e3:,.0f} items/s")
                else:
                    s, i = res
                    if not (bool(torch.isfinite(s).all()) and s.shape ==
                            (1, 100) and bool((s[:, 1:] <= s[:, :-1]).all())):
                        _fail(f"{arch} retrieval: scores {s.shape} not "
                              "finite and sorted")
                    ms = time_ms(lambda: b.fn(params, inputs), reps=3,
                                 trials=3)
                    line.append(f"retrieval_cand (1 query, "
                                f"{sh.n_candidates:,} candidates, top 100) "
                                f"{ms:.3f} ms a query")
                del inputs, res
        cut = (f", tables capped at {DLRM_SERVE_ROWS:,} rows"
               if arch == "dlrm-mlperf" else "")
        print(f"  {arch} serve{cut}: " + "; ".join(line)
              + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        del params
        gc.collect()
        torch.cuda.empty_cache()


def families_gnn(smi) -> None:
    """GatedGCN at full width (16 rounds, d 70): one train step twice from
    the init at ``full_graph_sm``, ``minibatch_lg`` (a subgraph of 1,024
    seeds at fanout (15, 10), sampled from an sbm_graph of Reddit's
    232,965 nodes) and ``molecule`` (128 graphs), the same bits; s a step
    and edges/s; the minibatch step profiled; then ``gnn_exit_embeddings``
    on ``full_graph_sm`` through the RMSNorm kernel."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.data import sampler as SA
    from repro_torch.data import synthetic as SYN
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models import gnn as G
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import AdamW
    dev = torch.device("cuda")
    spec = get_arch("gatedgcn")
    for name in ("full_graph_sm", "minibatch_lg", "molecule"):
        shape = spec.shape(name)
        bundle = S.build_step(spec, shape, device=dev)
        cfg = bundle.meta["cfg"]
        t0 = time.perf_counter()
        big = None
        if shape.kind == "graph_mini":
            g = SYN.sbm_graph(0, REDDIT_NODES, cfg.n_classes, cfg.d_feat)
            big = (g, SA.CSRGraph.from_edges(g["src"], g["dst"],
                                             REDDIT_NODES))
        arrays = _gnn_arrays(shape, cfg, 0, big)
        host_s = time.perf_counter() - t0
        del big
        graph = _graph(arrays, dev)
        E = int(np.prod(arrays["src"].shape))

        def fresh():
            p = TR.init_params(spec, 0, dev, shape)
            return p, AdamW().init(p)

        torch.cuda.reset_peak_memory_stats()
        runs, _ = _timed_steps(bundle, fresh, graph, 2)
        _same_bits_twice(f"gatedgcn {name} train step", runs)
        step = runs[1][0]
        real = int(arrays["edge_mask"].sum())
        nodes = int(np.prod(arrays["node_mask"].shape))
        print(f"  gatedgcn {name} train step ({nodes:,} nodes, {E:,} edges "
              f"({real:,} real), d_feat {cfg.d_feat}; "
              f"data {host_s:.1f} s on the host): {runs[0][0]:.3f} / "
              f"{step:.3f} s a step (the same bits twice), "
              f"{E / step:,.0f} edges/s, model "
              f"{bundle.model_flops / step / 1e12:.3f} TFLOP/s, loss "
              f"{runs[1][1]:.4f}, grad norm {runs[1][2]:.4g}, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({smi})")
        if shape.kind == "graph_mini":
            _profile_step(f"gatedgcn {name} train step", bundle, *fresh(),
                          graph)
        if name == "full_graph_sm":
            params = TR.init_params(spec, 0, dev, shape)
            with torch.no_grad():
                before = rms_ops.launches
                emb = G.gnn_exit_embeddings(params, cfg, spec.recall, graph)
                one = rms_ops.launches - before
                emb2 = G.gnn_exit_embeddings(params, cfg, spec.recall, graph)
                if (one, rms_ops.launches - before) != (1, 2):
                    _fail(f"gnn_exit_embeddings: {one} then "
                          f"{rms_ops.launches - before} rmsnorm launches "
                          "over 2 calls (want one a call)")
                pooled = G.gnn_forward(params, cfg, spec.recall, graph,
                                       collect_pooled=True)["pooled"]
                idx = torch.tensor([e - 1 for e in spec.recall.exit_layers(
                    cfg.n_layers)], device=dev)
                x = pooled[idx]
                norm = params["exit_head"]["norm"]
                plain = L.l2_normalize(rmsnorm_reference(
                    x, norm, cfg.norm_eps).float()
                    @ params["exit_head"]["proj"].float())
            counted = rms_ops.launches  # the comparison's launch: uncounted
            err_norm = (rms_ops.rmsnorm_fwd(x, norm, cfg.norm_eps)
                        - rmsnorm_reference(x, norm, cfg.norm_eps)).abs(
                            ).max().item()
            rms_ops.launches = counted
            err = (emb - plain).abs().max().item()
            unit = (torch.linalg.norm(emb, dim=-1) - 1).abs().max().item()
            if not (torch.equal(emb, emb2) and err <= 1e-5
                    and err_norm <= 1e-5 and unit <= 1e-5
                    and tuple(x.shape) == (8, 70)):
                _fail(f"gnn_exit_embeddings: rmsnorm at {tuple(x.shape)} "
                      f"off by {err_norm:.3e}, embedding off the plain "
                      f"version by {err:.3e}, norms off 1 by {unit:.3e}")
            print(f"  gatedgcn exit embeddings ({tuple(emb.shape)}; the "
                  f"RMSNorm kernel at {tuple(x.shape)} fp32, one launch a "
                  f"call): rmsnorm {err_norm:.3e} and embedding "
                  f"{err:.3e} off the plain version, norms within "
                  f"{unit:.3e} of 1")
            del params
        del graph, arrays
        gc.collect()
        torch.cuda.empty_cache()


def families_phase():
    """The recsys and GNN families on the card (``families_parity``,
    ``families_recsys``, ``families_gnn``), every launch counter set to 0
    before and read after: no ported kernel runs on these paths but the
    RMSNorm of the GNN's exit head, two launches (two calls). Returns the
    counts, which no kernel row reads (each row's count comes from the
    path it was measured on)."""
    smi = _smi()
    _reset_launches()
    families_parity()
    families_recsys(smi)
    families_gnn(smi)
    got = {name: getattr(mod, attr) for name, (mod, attr)
           in _counters().items()}
    if got != {**{name: 0 for name in got}, "rmsnorm": 2}:
        _fail(f"families launches {got}: want rmsnorm 2, every other 0")
    print(f"families launches: {got}")
    return got


# ---------------------------------------------------------------------------
# the mesh and sharding layer on one card: a mesh's entries all cuda:0
# ---------------------------------------------------------------------------


def _bits(x):
    """x's bits as integers of its width (bit-for-bit compares: -0.0 and
    NaN payloads count)."""
    import torch
    return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64,
                   1: torch.int8}[x.element_size()])


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def mesh_placement(smi):
    """(a) qwen2-1.5b's bf16 params at full width and depth placed on a
    (data 2, model 2) mesh of four cuda:0 entries by ``make_shardings``
    (each piece its slice, bit for bit), saved, and restored by
    ``elastic_restore`` onto ``survivors_mesh(..., failed=2)``, (1, 2):
    the gathered tree equal to the original, bit for bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import mesh_utils as M
    from repro_torch.distributed.elastic import (elastic_restore,
                                                 survivors_mesh,
                                                 validate_divisibility)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    spec = get_arch("qwen2-1.5b")
    cfg, rc = spec.model, spec.recall
    gen = torch.Generator(device="cuda").manual_seed(2210)
    params = T.lm_init(gen, cfg, rc, device="cuda")
    n_bytes = sum(x.numel() * x.element_size()
                  for _, x in _tree_items(params))
    devices = ["cuda:0"] * 4
    rules = M.lm_rules(False)
    specs, ab = T.lm_specs(cfg, rc), T.lm_abstract(cfg, rc)
    mesh = make_mesh((2, 2), ("data", "model"), devices)
    shs = M.make_shardings(specs, mesh, rules, ab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = M.place_tree(params, shs)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    n_pieces = 0
    for (name, x), (_, st) in zip(_tree_items(params), _tree_items(placed)):
        for piece, sl in zip(st.pieces, st.sharding.slices(x.shape)):
            if not torch.equal(_bits(piece), _bits(x[sl])):
                _fail(f"mesh: piece of {name} {sl} differs from its slice")
            n_pieces += 1
        if len({p.data_ptr() for p in st.pieces}) != 4:
            _fail(f"mesh: {name}'s four entries share storage")
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        ck.save(1, placed)
        save_s = time.perf_counter() - t0
        del placed
        surv = survivors_mesh(devices, (2, 2), ("data", "model"), failed=2)
        if surv.shape != {"data": 1, "model": 2}:
            _fail(f"mesh: survivors_mesh gave {surv.shape}, want (1, 2)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, man = elastic_restore(ck, ab, surv, rules, specs)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    back = M.gather_tree(restored, "cuda:0")
    for (name, x), (_, y) in zip(_tree_items(params), _tree_items(back)):
        if y.dtype != x.dtype or not torch.equal(_bits(y), _bits(x)):
            _fail(f"mesh: elastic restore changed {name}")
    problems = validate_divisibility(ab, M.make_shardings(
        specs, make_mesh((1, 16), ("data", "model"), ["cuda:0"] * 16),
        rules))
    print(f"  mesh placement: qwen2-1.5b bf16 {n_bytes / 1e9:.3f} GB, "
          f"{n_pieces} pieces on (data 2, model 2) of cuda:0 bit-equal to "
          f"their slices, placed in {place_s:.3f} s; save {save_s:.2f} s, "
          f"elastic_restore onto {surv.shape} {restore_s:.2f} s (step "
          f"{man['step']}), gathered tree bit-equal [{smi}]")
    print(f"  validate_divisibility on (data 1, model 16): "
          f"{len(problems)} problems: {problems}")
    return {"save_s": save_s, "restore_s": restore_s, "place_s": place_s}


def mesh_seqparallel_decode(smi):
    """(b) ``flash_decode_seqparallel`` at the LM phase's decode_32k layer
    shape (B 32, S 32,768, H 12, KV 2, D 128, bf16; lengths 16,384-32,768,
    four rows at 6,000, whose shards 1-3 hold no valid key), the cache
    split over a ``seq`` axis of four cuda:0 entries, held to the decode
    attention kernel on the whole cache (the one counted launch) and to
    the plain version, within ``bf16_rounding_limit``; both timed."""
    import torch
    from repro_torch.distributed import mesh_utils as M
    from repro_torch.distributed.collectives import flash_decode_seqparallel
    from repro_torch.kernels.decode_attention.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        bf16_rounding_limit, decode_attention_reference)
    from repro_torch.launch.mesh import make_mesh
    B, S, H, KV, D, n = 32, 32768, 12, 2, 128, 4
    gen = torch.Generator(device="cuda").manual_seed(2211)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda").bfloat16()
    lens = torch.randint(16384, S + 1, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[:4] = 6000
    mesh = make_mesh((n,), ("seq",), ["cuda:0"] * n)
    cut = M.NamedSharding(mesh, (None, "seq"))
    kp, vp = cut.shard(k), cut.shard(v)
    fn = flash_decode_seqparallel(mesh, "seq")
    outs = fn(q, kp, vp, lens)
    yard = decode_attention(q, k, v, lens)          # the counted launch
    plain = decode_attention_reference(q, k, v, lens)
    torch.cuda.synchronize()
    got = outs[0].float()
    if any(not torch.equal(_bits(o), _bits(outs[0])) for o in outs[1:]):
        _fail("mesh: the seq-parallel entries' outputs differ")
    errs, used = {}, {}
    for what, want in (("kernel", yard), ("plain", plain)):
        w = want.float()
        err = (got - w).abs()
        errs[what] = err.max().item()
        used[what] = (err / bf16_rounding_limit(w)).max().item()
        if not used[what] <= 1.0:
            _fail(f"mesh: seq-parallel decode vs {what}: max err "
                  f"{errs[what]}, {used[what]:.3f} of its limit (one bf16 "
                  f"step at |o| plus 2^-12 of the row's max |o|)")
    seq_ms = time_ms(lambda: fn(q, kp, vp, lens), reps=3, trials=5)
    ker_ms = time_ms(lambda: decode_attn_cuda(q, k, v, lens), reps=10,
                     trials=5)
    print(f"  seq-parallel decode B={B} S={S} H={H} KV={KV} D={D} bf16 over "
          f"{n} seq entries (rows 0-3 at 6,000: shards 1-3 empty): max err "
          f"vs the kernel {errs['kernel']:.3e} ({used['kernel']:.3f} of "
          f"its limit), vs plain {errs['plain']:.3e} ({used['plain']:.3f}) "
          f"(limit one bf16 step at |o| plus 2^-12 of the row's max |o|); "
          f"seq-parallel "
          f"{seq_ms:.3f} ms, decode_attention kernel {ker_ms:.4f} ms "
          f"(CUDA events, median of 5) [{smi}]")
    return {"seq_ms": seq_ms, "kernel_ms": ker_ms}


def mesh_collectives(smi):
    """(c) The gradient collectives over qwen2-1.5b's full fp32 tree shape
    (1,545,288,704 params, 6.18 GB a tree), seeded: ``compressed_psum``
    over 2 entries for two steps with the error carried (sums and errors
    bit-equal to the step recomputed leaf by leaf from the quantize
    functions, relative error against the exact sum under 0.05, |err|
    under max|g| / 64), then
    ``psum_scatter_tree`` over 4 entries (each slice equal to the exact
    sum's, in entry order); each run twice, the same bits."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.quantize import dequantize_int8, quantize_int8
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     psum_scatter_tree)
    from repro_torch.models import transformer as T
    spec = get_arch("qwen2-1.5b")
    ab = T.lm_abstract(spec.model, spec.recall)
    gen = torch.Generator(device="cuda").manual_seed(2212)

    def draw():
        return {k: torch.randn(x.shape, generator=gen, device="cuda") * 1e-3
                for k, x in _tree_items(ab)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def digests(trees):
        return [d for t in trees for d in _digest(t)]

    gs = [draw(), draw()]
    errs, c_ms = None, []
    for step in (1, 2):
        if step == 2:
            del gs
            gs = [draw(), draw()]
        (summed, step_errs), ms = timed(lambda: compressed_psum(gs, errs))
        digest = digests(summed) + digests(step_errs)
        del summed, step_errs
        (again, new_errs), ms2 = timed(lambda: compressed_psum(gs, errs))
        c_ms += [ms, ms2]
        if digests(again) + digests(new_errs) != digest:
            _fail(f"mesh: compressed_psum step {step} gave other bits twice")
        worst, worst_err = 0.0, 0.0
        for name in again[0]:
            inp = [g[name] + (0.0 if errs is None else errs[s][name])
                   for s, g in enumerate(gs)]
            # bit for bit against the step recomputed leaf by leaf: each
            # entry's g + e quantized per row of flat, the error flat minus
            # its dequantized local, the locals summed in entry order
            locs = []
            for s, x in enumerate(inp):
                flat = x.reshape(1, -1) if x.ndim <= 1 else \
                    x.reshape(x.shape[0], -1)
                local = dequantize_int8(*quantize_int8(flat))
                if not torch.equal(_bits(new_errs[s][name]),
                                   _bits((flat - local).reshape(x.shape))):
                    _fail(f"mesh: compressed_psum step {step} {name}: "
                          f"entry {s}'s error is not flat - local")
                locs.append(local)
            total = (locs[0] + locs[1]).reshape(inp[0].shape)
            del locs
            for s in range(2):
                if not torch.equal(_bits(again[s][name]), _bits(total)):
                    _fail(f"mesh: compressed_psum step {step} {name}: "
                          f"entry {s}'s sum is not the sum of the locals")
            del total
            exact = inp[0] + inp[1]
            rel = ((exact - again[0][name]).abs().max()
                   / exact.abs().max()).item()
            gmax = max(x.abs().max().item() for x in inp)
            emax = max(e[name].abs().max().item() for e in new_errs)
            worst, worst_err = max(worst, rel), max(worst_err, emax / gmax)
            if not rel < 0.05 or not emax <= gmax / 64:
                _fail(f"mesh: compressed_psum step {step} {name}: rel err "
                      f"{rel}, |err| {emax} vs max|g| {gmax}")
            del inp, exact
        print(f"  compressed_psum step {step} over 2 entries"
              + (" (error carried)" if errs is not None else "")
              + f": sums and errors bit-equal to the step recomputed leaf "
              f"by leaf, worst rel err {worst:.4e} (< 0.05), worst |err| / "
              f"max|g + e| {worst_err:.4e} (< 1/64), the same bits twice; "
              f"{ms:.1f} ms, {ms2:.1f} ms")
        del again
        errs = new_errs
    del gs, errs
    torch.cuda.empty_cache()
    gs = [draw() for _ in range(4)]
    outs, s_ms = [], []
    for _ in range(2):
        out, ms = timed(lambda: psum_scatter_tree(gs))
        outs.append(out)
        s_ms.append(ms)
    for name in gs[0]:
        exact = ((gs[0][name] + gs[1][name]) + gs[2][name]) + gs[3][name]
        rows = exact.shape[0] // 4 if exact.shape[0] % 4 == 0 else None
        for s in range(4):
            want = exact if rows is None else exact[s * rows:(s + 1) * rows]
            for out in outs:
                if not torch.equal(_bits(out[s][name]), _bits(want)):
                    _fail(f"mesh: psum_scatter_tree entry {s} {name} is not "
                          "the exact sum's slice")
        del exact
    print(f"  psum_scatter_tree over 4 entries: every slice bit-equal to the "
          f"exact sum's, the same bits twice; {s_ms[0]:.1f} ms, "
          f"{s_ms[1]:.1f} ms [{smi}]")
    del gs, outs
    torch.cuda.empty_cache()
    return {"compressed_ms": c_ms, "scatter_ms": s_ms}


def mesh_rooflines(smi):
    """(d) The H100 roofline (``launch.hlo_analysis.Roofline`` on a (1, 1)
    mesh) of each qwen2-1.5b shape the LM and train phases run on one
    card: train 8 x 4,096, prefill 32 x 2,048, decode B 32 over a
    32,768-token cache."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.hlo_analysis import Roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import analytic_hbm_bytes_for, build_step
    spec = get_arch("qwen2-1.5b")
    mesh = make_mesh((1, 1), ("data", "model"), ["cuda:0"])
    out = {}
    for shape in (ShapeConfig("train", "train", 8, 4096),
                  ShapeConfig("prefill", "prefill", 32, 2048),
                  ShapeConfig("decode", "decode", 32, 32768)):
        b = build_step(spec, shape, device="cuda", mesh=mesh)
        r = Roofline(flops_per_device=b.model_flops,
                     hbm_bytes_per_device=analytic_hbm_bytes_for(
                         spec, shape, b, mesh, 1),
                     wire_bytes_per_device=0.0, n_devices=1,
                     model_flops_total=b.model_flops)
        out[shape.kind] = r.as_dict()
        print(f"  roofline qwen2-1.5b {shape.kind} B={shape.global_batch} "
              f"S={shape.seq_len} on one H100: compute "
              f"{r.compute_s * 1e3:.3f} ms, memory {r.memory_s * 1e3:.3f} ms, "
              f"step {r.step_s * 1e3:.3f} ms, {r.bottleneck}-bound, "
              f"mfu_at_roofline {r.mfu:.3f}"
              + (f", {b.meta['mesh_plan']['microbatches']} microbatches"
                 if shape.kind == "train" else "") + f" [{smi}]")
    return out


def mesh_phase():
    """The mesh and sharding layer on the card (``mesh_placement``,
    ``mesh_seqparallel_decode``, ``mesh_collectives``,
    ``mesh_rooflines``), every launch counter set to 0 before and read
    after: the one launch is the decode attention kernel's, the
    yardstick of the sequence-parallel decode."""
    smi = _smi()
    _reset_launches()
    mesh_placement(smi)
    mesh_seqparallel_decode(smi)
    mesh_collectives(smi)
    mesh_rooflines(smi)
    got = {name: getattr(mod, attr) for name, (mod, attr)
           in _counters().items()}
    if got != {**{name: 0 for name in got}, "decode_attention": 1}:
        _fail(f"mesh launches {got}: want decode_attention 1, every other 0")
    print(f"mesh launches: {got}")
    return got


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
    walls = {}
    for name, phase in (("build", build_phase), ("kernels", kernel_phase),
                        ("serve", serve_phase), ("heal", heal_phase),
                        ("train", train_phase), ("ivf", ivf_phase),
                        ("async", async_phase), ("shard", shard_phase),
                        ("lm", lm_phase),
                        ("moe", moe_phase), ("moonlight", moonlight_phase),
                        ("families", families_phase),
                        ("mesh", mesh_phase)):
        t0 = time.perf_counter()
        walls[name] = (phase(), time.perf_counter() - t0)
        gc.collect()  # a phase's engines hold cycles (refine_fn closures)
        torch.cuda.empty_cache()
    print("phase wall times: " + ", ".join(
        f"{name} {wall:.1f} s" for name, (_, wall) in walls.items()))
    rows = walls["kernels"][0] + HEAL_ROWS
    for row in rows:  # each kernel's count from the path that runs it
        path = next((p for p in ("lm", "moe", "moonlight", "heal",
                                 "train")
                     if row["name"] in walls[p][0]),
                    "ivf" if row["name"] in IVF_KERNELS else "serve")
        row["launches"] = walls[path][0][row["name"]]
        if row["name"] == "retrieval_topk_int4_gathered":
            row.update(IVF_GATHERED)
    print("share of the bound: " + ", ".join(
        f"{row['name']} {row['bound_ms'] / row['ms']:.0%}" for row in rows))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
