"""The float32 flash forward's share of its roofline, in the drain."""
from bench.metrics.readers import read_flash_f32_roofline as read  # noqa: F401
