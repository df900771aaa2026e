"""The Kimi-Linear prefill step's share of the card's bf16 peak
(``readers.read_mfu``)."""
from bench.metrics.readers import read_mfu as read  # noqa: F401
