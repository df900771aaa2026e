"""The card's idle share of the Kimi-Linear prefill window
(``read_idle_share``)."""
from bench.metrics.readers import read_idle_share as read  # noqa: F401
