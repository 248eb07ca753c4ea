"""Step 3: μProgram execution (the memory-controller control unit).

:func:`execute` runs a μProgram against a *subarray state*: B-group compute
rows, C-group constant rows, and D-group data rows holding the vertically
laid out operands (one int32 ``[n_words]`` packed plane per row).  It
issues the μOps one by one as eager tensor ops, so it runs wherever its
inputs lie; it is the plain version of the μProgram-VM kernel
(``repro_torch.kernels.simdram_vm``), which ``core.operations.apply_op``
launches instead for tensors on the card.

Destructive TRA semantics are modeled exactly: an AP overwrites all three
activated rows with the majority value; dual-contact rows store a cell value
whose n-wordline (~DCC) reads/writes the complement.  Input planes are
never written: a μOp that writes an input row replaces the state's row,
not the caller's tensor.

``ControlUnit`` adds the system-integration behaviour of Sec. 2.3.3: a bbop
FIFO, a μProgram scratchpad with hit/miss accounting, and the Loop Counter
that repeats a μProgram over row-sized element segments.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Sequence

import torch

from .bitplane import BitPlaneArray, maj3
from .subarray import ROW_BITS
from .uprogram import Aap, Ap, UProgram


class _State:
    """Mutable subarray state (rows -> packed planes)."""

    def __init__(self, n_words: int, inputs: Dict[str, torch.Tensor]):
        device = next(iter(inputs.values())).device if inputs else "cpu"
        zeros = torch.zeros((n_words,), dtype=torch.int32, device=device)
        self._zeros = zeros
        self._ones = torch.full((n_words,), -1, dtype=torch.int32,
                                device=device)
        self.b: Dict[str, torch.Tensor] = {
            r: zeros for r in ("T0", "T1", "T2", "T3", "DCC0", "DCC1")}
        self.d: Dict[tuple, torch.Tensor] = {}
        for name, planes in inputs.items():
            for bit in range(planes.shape[0]):
                self.d[(name, bit)] = planes[bit]

    # -- row addressing ----------------------------------------------------
    def _d_key(self, ref, i: int) -> tuple:
        _, name, a, off = ref
        return (name, a * i + off)

    def read(self, ref, i: int) -> torch.Tensor:
        kind = ref[0]
        if kind == "B":
            name = ref[1]
            if name.startswith("~"):
                return ~self.b[name[1:]]
            return self.b[name]
        if kind == "C":
            return self._zeros if ref[1] == 0 else self._ones
        return self.d.get(self._d_key(ref, i), self._zeros)

    def write(self, ref, val: torch.Tensor, i: int) -> None:
        kind = ref[0]
        if kind == "B":
            name = ref[1]
            if name.startswith("~"):
                self.b[name[1:]] = ~val       # n-wordline write stores complement
            else:
                self.b[name] = val
        elif kind == "D":
            self.d[self._d_key(ref, i)] = val
        else:
            raise ValueError(f"cannot write constant row {ref}")


def execute(uprog: UProgram, inputs: Dict[str, torch.Tensor], n_words: int,
            out_name: str = "OUT", out_bits: int | None = None
            ) -> torch.Tensor:
    """Run a μProgram; returns packed planes ``int32[out_bits, n_words]``."""
    st = _State(n_words, inputs)
    for op, i in uprog.flatten():
        if isinstance(op, Ap):
            vals = [st.read(r, i) for r in op.triple]
            m = maj3(*vals)
            for r in op.triple:
                st.write(r, m, i)
        elif isinstance(op, Aap):
            if op.is_maj_src:
                vals = [st.read(r, i) for r in op.src]
                v = maj3(*vals)
                for r in op.src:               # first ACTIVATE overwrites triple
                    st.write(r, v, i)
            else:
                v = st.read(op.src, i)
            for dref in op.dsts:
                st.write(dref, v, i)
        else:
            raise ValueError(f"unknown uop {op}")
    nb = out_bits if out_bits is not None else uprog.n_bits
    return torch.stack([st.d.get((out_name, bit), st._zeros)
                        for bit in range(nb)])


@dataclasses.dataclass
class BbopRequest:
    """A bbop_* ISA request (Table 2.1)."""
    opcode: str
    srcs: Sequence[BitPlaneArray]
    n_bits: int


class ControlUnit:
    """System-level model of the SIMDRAM control unit (Fig. 2.7).

    Holds a μProgram memory (all generated μPrograms, as if resident in the
    reserved DRAM region) fronted by a small scratchpad cache, a bbop FIFO,
    and a Loop Counter that repeats a μProgram once per row-segment of
    ``ROW_BITS`` SIMD lanes.  Execution itself is delegated to the
    executors; this class accounts for commands, loop trips, and scratchpad
    locality, which feed the cost model and the system benchmarks.
    """

    def __init__(self, scratchpad_entries: int = 16):
        self.uprog_memory: Dict[str, UProgram] = {}
        self._scratch: "OrderedDict[str, UProgram]" = OrderedDict()
        self.scratchpad_entries = scratchpad_entries
        self.fifo: List[BbopRequest] = []
        self.stats = {"bbops": 0, "scratch_hits": 0, "scratch_misses": 0,
                      "loop_trips": 0, "commands": 0}

    def register(self, uprog: UProgram) -> None:
        self.uprog_memory[uprog.name] = uprog

    def _fetch(self, opcode: str) -> UProgram:
        if opcode in self._scratch:
            self.stats["scratch_hits"] += 1
            self._scratch.move_to_end(opcode)
        else:
            self.stats["scratch_misses"] += 1
            self._scratch[opcode] = self.uprog_memory[opcode]
            if len(self._scratch) > self.scratchpad_entries:
                self._scratch.popitem(last=False)
        return self._scratch[opcode]

    def enqueue(self, req: BbopRequest) -> None:
        self.fifo.append(req)

    def drain(self) -> List[dict]:
        """Account for all queued bbops (decode → loop → issue commands)."""
        out = []
        while self.fifo:
            req = self.fifo.pop(0)
            self.stats["bbops"] += 1
            prog = self._fetch(req.opcode)
            n_elems = max(s.n_elems for s in req.srcs)
            trips = -(-n_elems // ROW_BITS)    # Loop Counter iterations
            cmds = prog.command_count()["total"] * trips
            self.stats["loop_trips"] += trips
            self.stats["commands"] += cmds
            out.append({"opcode": req.opcode, "trips": trips, "commands": cmds})
        return out
