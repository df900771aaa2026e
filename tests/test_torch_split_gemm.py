"""The split GEMMs' plain versions (``kernels/split_gemm/ref.py``): the
three-term bf16 split of fp32 activations is exact, inf and NaN propagate
as in an fp32 product, the products stay within a stated multiple of fp32
``torch.matmul``'s own error against float64; ``layers.swiglu`` takes the
split path by the inputs' dtypes, grad and widths alone, and the vision
tower through it still computes what the JAX reference computes."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro.models import imagebind as JIB
from repro_torch.configs import base as TC
from repro_torch.kernels.split_gemm import ops as SO
from repro_torch.kernels.split_gemm import ref as SR
from repro_torch.models import imagebind as TIB
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _values(case: str) -> torch.Tensor:
    rng = np.random.default_rng(0)
    n = 4096
    if case == "normals":
        v = rng.standard_normal(n)
    elif case == "wide_exponents":  # 2^-60 .. 2^60, either sign
        v = rng.standard_normal(n) * np.exp2(rng.integers(-60, 61, n))
    elif case == "bf16_ties":  # halfway between two bf16 values, and near
        mant = rng.integers(0, 1 << 16, n, dtype=np.int64) << 16
        low = np.array([0x8000, 0x7FFF, 0x8001, 0xFFFF, 0x0001] * (n // 5 + 1),
                       np.int64)[:n]
        u = (np.int64(0x3F800000) + mant % (1 << 23)) | low
        v = (u.astype(np.uint32).view(np.float32)
             * np.exp2(rng.integers(-20, 21, n))).astype(np.float64)
    elif case == "negatives":
        v = -np.abs(rng.standard_normal(n)) * np.exp2(rng.integers(-30, 31, n))
    elif case == "signed_zeros":
        v = np.array([0.0, -0.0] * (n // 2))
    elif case == "largest":  # near fp32's max, where round-to-nearest
        # into bf16 would overflow
        v = np.float32(3.4028235e38) * (1 - rng.random(n) * 2.0 ** -8)
        v[::2] *= -1
    elif case == "smallest_exact":  # 2^-103 .. 2^-96: x3 near 2^-126
        v = (1 + rng.random(n)) * np.exp2(rng.integers(-103, -96, n))
        v[::2] *= -1
    elif case == "subnormal_range":  # under 2^-103, fp32 subnormals too
        v = (1 + rng.random(n)) * np.exp2(rng.integers(-149, -103, n))
        v[::2] *= -1
    else:
        raise ValueError(case)
    return torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))


@pytest.mark.parametrize("case", [
    "normals", "wide_exponents", "bf16_ties", "negatives", "signed_zeros",
    "largest", "smallest_exact", "subnormal_range"])
def test_split_is_exact(case):
    """x1 + x2 + x3 == x bit for bit where |x| >= 2^-103 (every term a
    normal number) and for ±0; below, within 2^-133 (bf16's subnormal
    step). Each term is a bf16 value, and |x3| <= |x2| <= |x1|."""
    x = _values(case)
    x1, x2, x3 = SR.split3(x)
    for t in (x1, x2, x3):
        assert torch.equal(_bits(t.to(torch.bfloat16).float()), _bits(t))
    assert (x3.abs() <= x2.abs()).all() and (x2.abs() <= x1.abs()).all()
    total = x1 + x2 + x3
    exact = x.abs() >= 2.0 ** -103
    if case == "signed_zeros":
        exact = torch.ones_like(exact)
    assert torch.equal(_bits(total)[exact], _bits(x)[exact])
    assert ((total.double() - x.double()).abs() < 2.0 ** -133).all()
    if case == "subnormal_range":
        assert (~exact).all()
    else:
        assert exact.all()


def _non_finite_x(M: int, K: int) -> torch.Tensor:
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    x[1, 3] = float("inf")
    x[2, 0] = float("-inf")
    x[3, 5] = float("nan")
    x[4, 1] = float("inf")
    x[4, 2] = float("-inf")
    # a NaN whose payload lies below bit 16 (truncation alone makes it inf)
    x[5, 7] = torch.tensor([0x7F800001], dtype=torch.int32).view(
        torch.float32)
    return x


def _same_non_finite(got: torch.Tensor, want: torch.Tensor) -> None:
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))


@pytest.mark.parametrize("which", ["gate_up", "down"])
def test_non_finite_inputs_propagate(which):
    """inf and NaN in x land where an fp32 product puts them, with its
    signs: x2 = x3 = 0 there, so no inf - inf appears."""
    M, K, N = 8, 16, 24
    x = _non_finite_x(M, K)
    rng = np.random.default_rng(2)
    wg, wu = (torch.from_numpy(rng.standard_normal((K, N)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    if which == "down":
        got, want = SR.matmul(x, wg), x @ wg.float()
    else:
        got = SR.swiglu_gate_up(x, wg, wu)
        want = F.silu(x @ wg.float()) * (x @ wu.float())
    _same_non_finite(got, want)
    assert not torch.isfinite(want[1:6]).all(dim=1).any()
    fin = torch.isfinite(want)
    np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(),
                               rtol=1e-5, atol=1e-5)


# the tower's widths at a small row count (two 257-row exit groups)
@pytest.mark.parametrize("which,M,K,N", [
    ("down", 514, 1280, 256), ("down", 514, 5120, 128),
    ("gate_up", 514, 1280, 256)])
def test_plain_version_within_fp32_error(which, M, K, N):
    """Against a float64 product, the plain version's worst error is within
    2x that of fp32 ``torch.matmul`` (the card test's gate): each term's
    products are exact, so the split adds only the rounding of its sums."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    wg, wu = (torch.from_numpy((rng.standard_normal((K, N)) / K ** 0.5)
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    x64, wg64, wu64 = x.double(), wg.double(), wu.double()
    if which == "down":
        got, fp32, exact = SR.matmul(x, wg), x @ wg.float(), x64 @ wg64
    else:
        got = SR.swiglu_gate_up(x, wg, wu)
        fp32 = F.silu(x @ wg.float()) * (x @ wu.float())
        exact = F.silu(x64 @ wg64) * (x64 @ wu64)
    err = (got.double() - exact).abs().max().item()
    err_fp32 = (fp32.double() - exact).abs().max().item()
    assert 0 < err_fp32 and err <= 2 * err_fp32, (err, err_fp32)


def _mlp(d: int, d_ff: int, dtype: torch.dtype, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(shape, generator=g) / shape[0] ** 0.5).to(dtype)
            for k, shape in (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)),
                             ("w_down", (d_ff, d)))}


def _spied():
    """Patches of the split ops that count their calls (and still run)."""
    calls = {"gate_up": 0, "down": 0}

    def count(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run
    return calls, (
        mock.patch.object(SO, "swiglu_gate_up",
                          count("gate_up", SO.swiglu_gate_up)),
        mock.patch.object(SO, "matmul", count("down", SO.matmul)))


# case -> (x dtype, weight dtype, d_ff, x requires grad, LoRA target)
DISPATCH = {"fp32_on_bf16": (torch.float32, torch.bfloat16, 64, False, None),
            "bf16_activations": (torch.bfloat16, torch.bfloat16, 64, False,
                                 None),
            "fp32_weights": (torch.float32, torch.float32, 64, False, None),
            "grad": (torch.float32, torch.bfloat16, 64, True, None),
            "misaligned_d_ff": (torch.float32, torch.bfloat16, 60, False,
                                None),
            "lora_on_up": (torch.float32, torch.bfloat16, 64, False, "w_up"),
            "lora_elsewhere": (torch.float32, torch.bfloat16, 64, False,
                               "wq")}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_swiglu_dispatch(case):
    """fp32 activations on bf16 weights with no gradient and no LoRA on the
    MLP take the split ops; every other input keeps today's products, and
    both agree to fp32 rounding."""
    xdt, wdt, d_ff, grad, target = DISPATCH[case]
    d = 32
    p = _mlp(d, d_ff, wdt)
    x = torch.randn((2, 5, d), generator=torch.Generator().manual_seed(4))
    x = x.to(xdt).requires_grad_(grad)
    lora = {}
    if target is not None:
        g = torch.Generator().manual_seed(5)
        d_out = d_ff if target == "w_up" else 2 * d
        lora[target] = {"a": torch.randn((d, 4), generator=g),
                        "b": torch.randn((4, d_out), generator=g)}
    calls, patches = _spied()
    with patches[0], patches[1]:
        y = L.swiglu(p, x, lora, 0.5)
    taken = case in ("fp32_on_bf16", "lora_elsewhere")
    assert calls == ({"gate_up": 1, "down": 1} if taken else
                     {"gate_up": 0, "down": 0})
    assert y.shape == x.shape and y.dtype == xdt
    if taken:
        with mock.patch.object(SO, "takes", lambda *a: False):
            plain = L.swiglu(p, x, lora, 0.5)
        np.testing.assert_allclose(y.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-6)
    if grad:
        y.sum().backward()
        assert x.grad is not None


# the vision tower of tests/test_torch_model.py's bf16 config (d 32, d_ff 64)
CFG16 = MEMConfig(towers=(TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                          TowerConfig("text", 3, 32, 2, 64, 8, 0, vocab=128)),
                  embed_dim=32, dtype="bfloat16")
TCFG16 = TC.MEMConfig(towers=(TC.TowerConfig("vision", 4, 32, 2, 64, 12, 16),
                              TC.TowerConfig("text", 3, 32, 2, 64, 8, 0,
                                             vocab=128)),
                      embed_dim=32, dtype="bfloat16")
RC = RecallConfig(exit_interval=1, superficial_layers=2, predictor_hidden=32,
                  lora_rank=4, query_granularities=2)
TRC = TC.RecallConfig(exit_interval=1, superficial_layers=2,
                      predictor_hidden=32, lora_rank=4,
                      query_granularities=2)


@pytest.mark.parametrize("modality,splits", [("vision", 4), ("text", 0)])
def test_towers_through_swiglu_match_reference(modality, splits):
    """The vision tower (fp32 activations, bf16 weights) runs every layer's
    MLP through the split ops and agrees with the JAX reference at the
    model tests' tolerance; the bf16 text tower never takes them."""
    jp = JIB.mem_init(jax.random.PRNGKey(1), CFG16, RC)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 12, 16)).astype(np.float32) \
        if modality == "vision" else \
        rng.integers(0, 128, (4, 8)).astype(np.int32)
    calls, patches = _spied()
    with torch.no_grad(), patches[0], patches[1]:
        t = TIB.mem_embed_all_exits(tp, TCFG16, TRC, modality,
                                    torch.from_numpy(x))
    assert calls == {"gate_up": splits, "down": splits}
    j = JIB.mem_embed_all_exits(jp, CFG16, RC, modality, jnp.asarray(x))
    atol = 1e-4 if modality == "vision" else 4 * 2.0 ** -8
    np.testing.assert_allclose(t["exit_embs"].float().numpy(),
                               np.asarray(j["exit_embs"], np.float32),
                               atol=atol)
