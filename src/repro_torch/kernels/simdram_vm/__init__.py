"""The SIMDRAM control unit: the Hopper μProgram-VM kernel, its lowering
and compilation, and its plain version (``core.engine.execute``)."""
from .lower import CompiledProgram, LoweredProgram, compile_lowered, lower
from .ops import build_kernel, run_uprogram, simdram_op

__all__ = ["LoweredProgram", "lower", "CompiledProgram", "compile_lowered",
           "build_kernel", "run_uprogram", "simdram_op"]
