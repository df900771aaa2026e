"""The KDA chunked kernel's share of its roofline in the Kimi-Linear
prefill (``bench/lib/kda.read_kda_roofline``)."""
from bench.lib.kda import read_kda_roofline as read  # noqa: F401
