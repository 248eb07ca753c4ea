"""The SIMDRAM control unit: the Hopper μProgram-VM kernel, its lowering
and its plain version (``core.engine.execute``)."""
from .lower import LoweredProgram, lower
from .ops import build_kernel, run_uprogram, simdram_op

__all__ = ["LoweredProgram", "lower", "build_kernel", "run_uprogram",
           "simdram_op"]
