"""Plain versions of the int4 activation-cache kernels: the port's torch
quantize / dequantize (``repro_torch.core.quantize``), bit-exact with
``quantize_int4_np`` / ``dequantize_int4_np``."""
from repro_torch.core.quantize import dequantize_int4 as dequantize_int4_reference
from repro_torch.core.quantize import quantize_int4 as quantize_int4_reference

__all__ = ["quantize_int4_reference", "dequantize_int4_reference"]
