"""The bfloat16 flash forward's share of its roofline in a prefill."""
from bench.metrics.readers import read_flash_bf16_roofline as read  # noqa: F401
