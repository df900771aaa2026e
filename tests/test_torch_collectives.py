"""Port parity: ``repro_torch.distributed.collectives`` and the int8
quantize they use. ``quantize_int8`` bit for bit; ``compressed_psum`` and
``psum_scatter_tree`` over 2, 4 and 8 entries against the reference's
calls under ``jax.vmap(..., axis_name="data")`` (0-d and indivisible
leaves, two steps of error feedback); ``flash_decode_seqparallel`` against
the reference's ``shard_map`` on 8 host devices, computed in one
subprocess (the test process keeps its one device)."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import dequantize_int8 as jdequant
from repro.core.quantize import quantize_int8 as jquant
from repro.distributed import collectives as JCOL
from repro_torch.core.quantize import dequantize_int8, quantize_int8
from repro_torch.distributed import collectives as TCOL
from repro_torch.kernels.decode_attention.ref import (
    bf16_rounding_limit, decode_attention_reference)
from repro_torch.launch.mesh import make_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# int8 quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,seed", [((64, 48), 0), ((1, 4096), 1),
                                        ((7, 3, 5), 2), ((300, 1), 3)])
def test_quantize_int8_bit_exact(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(1e-6, 1e3, shape[:-1] + (1,))).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0          # absmax 0: the 1e-12 floor
    if shape[-1] > 1:
        flat = x.reshape(-1, shape[-1])
        flat[-1, :2] = [127.0 * 0.5, -127.0]   # a quotient at a .5 tie
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jdequant(jq, js)))
    assert dequantize_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# gradient collectives
# ---------------------------------------------------------------------------


def _trees(n, seed):
    """n per-entry trees: a 2-d leaf, one whose leading dim (7) no N
    divides, a 0-d, a 1-d and a 3-d leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (16, 8), "b": {"c": (7, 3), "s": ()}, "d": (8,),
              "e": (4, 2, 3)}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return (rng.standard_normal((n,) + sh) * 0.1).astype(np.float32)
    return draw(shapes)


def _entry(stacked, s, device="cpu"):
    if isinstance(stacked, dict):
        return {k: _entry(v, s, device) for k, v in stacked.items()}
    return torch.from_numpy(np.array(stacked[s])).to(device)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _sum_tol(stacked_leaf):
    """The order-of-summation bound of an N-term fp32 sum."""
    n = stacked_leaf.shape[0]
    return n * EPS * np.abs(stacked_leaf).sum(0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_psum_scatter_tree_matches_reference(n):
    stacked = _trees(n, n)
    want = jax.vmap(lambda t: JCOL.psum_scatter_tree(t, "data"),
                    axis_name="data")(jax.tree.map(jnp.asarray, stacked))
    got = TCOL.psum_scatter_tree([_entry(stacked, s) for s in range(n)])
    assert len(got) == n
    for (path, w), (_, x) in zip(_leaves(want), _leaves(stacked)):
        full = x[0].copy()
        for s in range(1, n):
            full = full + x[s]              # the port's entry order
        tol = _sum_tol(x)
        divides = x.ndim > 1 and x.shape[1] % n == 0
        rows = x.shape[1] // n if divides else None
        for s in range(n):
            g = dict(_leaves(got[s]))[path].numpy()
            cut = (lambda a: a[s * rows:(s + 1) * rows]) if divides \
                else (lambda a: a)
            np.testing.assert_array_equal(g, cut(full))
            assert g.shape == np.asarray(w[s]).shape, path
            assert np.all(np.abs(g - np.asarray(w[s])) <= cut(tol)), path


@pytest.mark.parametrize("n", [2, 4, 8])
def test_compressed_psum_two_steps_match_reference(n):
    g1, g2 = _trees(n, 10 + n), _trees(n, 20 + n)
    js1, je1 = jax.vmap(lambda t: JCOL.compressed_psum(t, "data"),
                        axis_name="data")(jax.tree.map(jnp.asarray, g1))
    js2, je2 = jax.vmap(lambda t, e: JCOL.compressed_psum(t, "data", e),
                        axis_name="data")(jax.tree.map(jnp.asarray, g2), je1)
    ts1, te1 = TCOL.compressed_psum([_entry(g1, s) for s in range(n)])
    ts2, te2 = TCOL.compressed_psum([_entry(g2, s) for s in range(n)], te1)
    for jsum, jerr, tsum, terr, g in ((js1, je1, ts1, te1, g1),
                                      (js2, je2, ts2, te2, g2)):
        for (path, ws), (_, we), (_, x) in zip(_leaves(jsum), _leaves(jerr),
                                               _leaves(g)):
            ws, we = np.asarray(ws), np.asarray(we)
            # the dequantized locals are within 1/127 of x's absmax a row
            tol = _sum_tol(np.abs(x) * (1 + 1 / 127.0))
            for s in range(n):
                got_s = dict(_leaves(tsum[s]))[path].numpy()
                got_e = dict(_leaves(terr[s]))[path].numpy()
                assert got_s.shape == got_e.shape == x.shape[1:], path
                # the residual is an entry's own arithmetic: bit for bit
                np.testing.assert_array_equal(got_e, we[s])
                assert np.all(np.abs(got_s - ws[s]) <= tol), path
                np.testing.assert_array_equal(     # one sum on every entry
                    got_s, dict(_leaves(tsum[0]))[path].numpy())
                # the error feedback is the local quantization residual
                assert np.abs(got_e).max() <= np.abs(x).max() / 64, path
            exact = x.sum(0) if g is g1 else None
            if exact is not None and np.abs(exact).max() > 0:
                rel = np.abs(exact - got_s).max() / np.abs(exact).max()
                assert rel < 0.05, (path, rel)


def test_collectives_keep_each_entry_on_its_device_and_order():
    """Outputs land on the entry's device as tensors of their own; the sum
    is the left fold in entry order."""
    xs = [torch.full((4, 2), float(10 ** s)) for s in range(4)]
    xs[1][0, 0] = 1e-8
    out = TCOL.psum_scatter_tree([{"g": x} for x in xs])
    assert len({o["g"].data_ptr() for o in out}) == 4
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert torch.equal(torch.cat([o["g"] for o in out]), want)
    summed, errs = TCOL.compressed_psum([{"g": x} for x in xs[:2]])
    assert summed[0]["g"].data_ptr() != summed[1]["g"].data_ptr()
    assert torch.equal(summed[0]["g"], summed[1]["g"])


# ---------------------------------------------------------------------------
# sequence-parallel decode
# ---------------------------------------------------------------------------


REF_DECODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.collectives import flash_decode_seqparallel
from repro.kernels.decode_attention.ref import decode_attention_reference

out = {}
B, S, H, KV, D = 2, 64, 4, 2, 16
ks = jax.random.split(jax.random.PRNGKey(0), 4)
q = jax.random.normal(ks[0], (B, H, D))
k = jax.random.normal(ks[1], (B, S, KV, D))
v = jax.random.normal(ks[2], (B, S, KV, D))
out["q"], out["k"], out["v"] = map(np.asarray, (q, k, v))
cases = {"distributed": ([40, 64], 8), "masked_shard": ([5, 64], 8),
         "masked_row": ([0, 30], 8), "four_shards": ([3, 50], 4)}
for name, (lens, n) in cases.items():
    mesh = jax.make_mesh((n,), ("seq",), devices=jax.devices()[:n])
    lengths = jnp.array(lens, jnp.int32)
    out[name] = np.asarray(flash_decode_seqparallel(mesh, "seq")(
        q, k, v, lengths))
    out[name + "_oracle"] = np.asarray(decode_attention_reference(
        q, k, v, lengths))
np.savez(sys.argv[1], **out)
"""

DECODE_CASES = {"distributed": ([40, 64], 8), "masked_shard": ([5, 64], 8),
                "masked_row": ([0, 30], 8), "four_shards": ([3, 50], 4)}


@pytest.fixture(scope="module")
def ref_decode(tmp_path_factory):
    path = tmp_path_factory.mktemp("decode") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_DECODE),
                          str(path)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_seqparallel_matches_reference(ref_decode, case):
    lens, n = DECODE_CASES[case]
    r = ref_decode
    q, k, v = (torch.from_numpy(r[x]) for x in ("q", "k", "v"))
    lengths = torch.tensor(lens, dtype=torch.int32)
    mesh = make_mesh((n,), ("seq",), ["cpu"] * n)
    S_loc = k.shape[1] // n
    kp = [k[:, s * S_loc:(s + 1) * S_loc].clone() for s in range(n)]
    vp = [v[:, s * S_loc:(s + 1) * S_loc].clone() for s in range(n)]
    outs = TCOL.flash_decode_seqparallel(mesh, "seq")(q, kp, vp, lengths)
    assert len(outs) == n
    for o in outs:
        assert o.dtype == q.dtype and o.shape == q.shape
        assert torch.equal(o, outs[0])
    got = outs[0].numpy()
    assert np.abs(got - r[case]).max() < 2e-5
    oracle = decode_attention_reference(q, k, v, lengths).numpy()
    live = np.asarray(lens) > 0
    assert np.abs(got[live] - oracle[live]).max() < 2e-5
    if not live.all():  # a row with no valid key: the mean of V (C.4)
        mean_v = v.float().mean(1).repeat_interleave(
            q.shape[1] // k.shape[2], dim=1).numpy()
        assert np.abs(got[~live] - mean_v[~live]).max() < 2e-5


@pytest.mark.parametrize("n", [2, 4])
def test_flash_decode_seqparallel_bf16_within_one_rounding(n):
    """bf16 at long context (|o| ~ 1e-2): the split cache's output within
    ``bf16_rounding_limit`` of the one-pass plain version, a limit that a
    combine 1% off (a mis-scaled correction) would exceed."""
    B, S, H, KV, D = 3, 16384, 4, 2, 128
    rng = np.random.default_rng(7 + n)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .bfloat16() for s in ((B, H, D), (B, S, KV, D),
                                     (B, S, KV, D)))
    lengths = torch.tensor([S, 9000, 3000], dtype=torch.int32)
    mesh = make_mesh((n,), ("seq",), ["cpu"] * n)
    S_loc = S // n
    cut = lambda x: [x[:, s * S_loc:(s + 1) * S_loc].clone()
                     for s in range(n)]
    got = TCOL.flash_decode_seqparallel(mesh, "seq")(
        q, cut(k), cut(v), lengths)[0].float()
    ref = decode_attention_reference(q, k, v, lengths).float()
    lim = bf16_rounding_limit(ref)
    assert bool(((got - ref).abs() <= lim).all())
    assert not bool(((ref * 1.01 - ref).abs() <= lim).all())


def test_flash_decode_seqparallel_rejects_uneven_pieces():
    mesh = make_mesh((2,), ("seq",), ["cpu"] * 2)
    fn = TCOL.flash_decode_seqparallel(mesh, "seq")
    q = torch.zeros(1, 2, 4)
    k = [torch.zeros(1, 3, 1, 4), torch.zeros(1, 5, 1, 4)]
    with pytest.raises(ValueError):
        fn(q, k, k, torch.tensor([4]))
    with pytest.raises(ValueError):
        fn(q, k[:1], k[:1], torch.tensor([4]))
