"""The grouped expert GEMMs' share of their roofline in the Kimi-Linear
prefill (``bench/lib/mla.read_gemm_roofline``)."""
from bench.lib.mla import read_gemm_roofline as read  # noqa: F401
