"""The MLA flash forward's share of its roofline in the Moonlight
prefill (``bench/lib/mla.read_flash_roofline``)."""
from bench.lib.mla import read_flash_roofline as read  # noqa: F401
