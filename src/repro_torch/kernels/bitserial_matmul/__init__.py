"""The bit-serial (bit-plane) matmul: the Hopper kernel, its plain version
(``ref.py``), weight and activation quantization and
:class:`QuantizedLinear`."""
from .ops import (QuantizedLinear, bitserial_matmul, bsmm_raw, build_kernel,
                  quantize_activations, quantize_weights)

__all__ = ["bitserial_matmul", "quantize_weights", "quantize_activations",
           "QuantizedLinear", "bsmm_raw", "build_kernel"]
