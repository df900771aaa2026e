"""The elementwise share of the Moonlight prefill's busy time, the MLA
flash forward not counted (``bench/lib/mla.read_elementwise_share``)."""
from bench.lib.mla import read_elementwise_share as read  # noqa: F401
