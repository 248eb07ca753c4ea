"""SIMDRAM core: the paper's Contribution #1, end to end, on torch.

Step 1 (synthesis) → Step 2 (allocation + μProgram) → Step 3 (execution),
plus the vertical-layout substrate and the cost/energy model.  The host-side
steps are copies of the reference package's pure-Python modules; the
bit-plane layout and the executor run on tensors, and on the card through
the kernels in ``repro_torch.kernels``.  The VBI subsystem (Contribution
#2) is in ``core.vbi``.
"""
from .aoig import Aoig
from .bitplane import BitPlaneArray, maj3, pack, pack_np, unpack, unpack_np
from .cost import compare_to_ambit, kernel_cost, op_cost, uprogram_cost
from .engine import BbopRequest, ControlUnit, execute
from .mig import CONST0, CONST1, Mig
from .operations import OPS, ORACLES, PAPER_16, apply_op, get_uprogram
from .synthesis import aoig_to_mig, optimize_mig
from .uprogram import Aap, Ap, Segment, UProgram, coalesce

__all__ = [
    "Aoig", "Mig", "CONST0", "CONST1", "BitPlaneArray", "maj3", "pack",
    "pack_np", "unpack", "unpack_np", "aoig_to_mig", "optimize_mig",
    "apply_op", "get_uprogram", "OPS", "ORACLES", "PAPER_16", "execute",
    "ControlUnit", "BbopRequest", "op_cost", "uprogram_cost",
    "compare_to_ambit", "kernel_cost", "Aap", "Ap", "Segment", "UProgram",
    "coalesce",
]
