"""The elementwise share of the Kimi-Linear prefill's busy time, the MLA
flash forward and the KDA kernel not counted
(``bench/lib/kda.read_elementwise_share``)."""
from bench.lib.kda import read_elementwise_share as read  # noqa: F401
