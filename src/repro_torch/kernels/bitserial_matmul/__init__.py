"""The bit-serial (bit-plane) matmul: the Hopper kernel, its plain version
(``ref.py``), weight and activation quantization, the packed plane layout
and :class:`QuantizedLinear`."""
from .ops import (QuantizedLinear, bitserial_matmul, bsmm_packed, bsmm_raw,
                  build_kernel, quantize_activations, quantize_weights)
from .ref import pack_planes, unpack_planes

__all__ = ["bitserial_matmul", "quantize_weights", "quantize_activations",
           "QuantizedLinear", "bsmm_packed", "bsmm_raw", "build_kernel",
           "pack_planes", "unpack_planes"]
