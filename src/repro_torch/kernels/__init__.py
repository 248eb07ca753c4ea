"""Hand-written Hopper kernels, each beside its plain PyTorch version:

  * bitplane_transpose - the SIMDRAM transposition unit (pack / unpack)
  * simdram_vm         - the control unit running μPrograms as data
  * bitserial_matmul   - weight bit-plane quantized matmul (int8 x planes)
  * paged_attention    - VBI-paged decode attention (translation in-kernel)

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; the kernels are built from ``csrc/`` at first use
(``_build.py``).
"""
from .bitplane_transpose import from_bitplanes, to_bitplanes
from .bitserial_matmul import (QuantizedLinear, bitserial_matmul,
                               quantize_activations, quantize_weights)
from .paged_attention import paged_attention
from .simdram_vm import simdram_op

__all__ = ["to_bitplanes", "from_bitplanes", "simdram_op",
           "bitserial_matmul", "quantize_weights", "quantize_activations",
           "QuantizedLinear", "paged_attention"]
