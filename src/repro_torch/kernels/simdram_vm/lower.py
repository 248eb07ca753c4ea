"""Lower a μProgram to the instruction stream of the μProgram-VM kernel.

The kernel (``csrc/simdram_vm.cu``) is compiled once and runs any
μProgram: the program is data.  :func:`lower` unrolls
``UProgram.flatten()`` on the host and gives every row the program touches
a *slot* of the kernel's row file:

* slot 0 is the constant row: C0 reads it, C1 reads its complement;
* slots 1–6 are the B-group rows T0–T3, DCC0 and DCC1;
* every D-group row ``(name, a·i+off)``, resolved per loop trip, gets its
  own slot, loaded from the input planes when ``name`` is an input and the
  bit is inside its width, and zero otherwise (a D row that was never
  written reads as zero);
* one scratch slot, only when an instruction would write more than four
  rows.

A *slot reference* is a 16-bit field ``slot << 1 | complement``: the
n-wordline of a dual-contact row (``~DCC0``) reads and writes the
complement of its cell.  Each instruction is four int32 words holding
eight fields ``s0 s1 s2 d0 d1 d2 d3 -``; the kernel reads s0–s2, takes
their majority, and writes it to d0–d3 in order.  So

* an AP is ``MAJ(t0, t1, t2) → t0, t1, t2``;
* an AAP with a MAJ source is ``MAJ(t0, t1, t2) → t0, t1, t2, dst``: the
  majority goes back into its triple first, then to its destination;
* an AAP copy is ``MAJ(src, src, src) → dsts`` (the majority of one value
  is that value);

and unused write fields repeat the last write, which changes nothing.
Every source is read before any destination is written, as a triple-row
activation does.  The input planes are only ever read: the kernel works on
its copy of them in the row file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...core.subarray import B_ROWS
from ...core.uprogram import Aap, Ap, UProgram

#: slot of the constant row (C0; C1 is its complement)
ZERO_SLOT = 0
#: rows an instruction writes
WRITES = 4
#: slots a reference field can name (15 bits beside the complement bit)
MAX_SLOTS = 1 << 15


@dataclasses.dataclass
class LoweredProgram:
    """The kernel's view of one μProgram at given input widths."""

    n_slots: int
    init: np.ndarray         # int32[n_slots]: -1 zero, else input << 16 | bit
    out_slots: np.ndarray    # int32[out_bits]: slot of each output plane
    instrs: np.ndarray       # int32[n_instr, 4]: eight 16-bit fields

    @property
    def n_instr(self) -> int:
        return self.instrs.shape[0]


def lower(uprog: UProgram, input_names: Sequence[str],
          input_bits: Sequence[int], out_bits: int) -> LoweredProgram:
    """Unroll ``uprog`` into the VM's slots and instruction stream for
    inputs ``input_names`` of widths ``input_bits`` (planes per input)."""
    width = dict(zip(input_names, input_bits))
    index = {name: k for k, name in enumerate(input_names)}
    slots: Dict[tuple, int] = {}
    init: List[int] = [-1] * (1 + len(B_ROWS))
    b_slot = {name: 1 + k for k, name in enumerate(B_ROWS)}

    def d_slot(key: Tuple[str, int]) -> int:
        if key not in slots:
            slots[key] = len(init)
            name, bit = key
            inside = name in width and 0 <= bit < width[name]
            init.append(index[name] << 16 | bit if inside else -1)
        return slots[key]

    def ref(r, i: int, write: bool) -> int:
        kind = r[0]
        if kind == "B":
            name = r[1]
            neg = name.startswith("~")
            return b_slot[name.lstrip("~")] << 1 | neg
        if kind == "C":
            if write:
                raise ValueError(f"cannot write constant row {r}")
            return ZERO_SLOT << 1 | (r[1] != 0)
        _, name, a, off = r
        return d_slot((name, a * i + off)) << 1

    rows: List[List[int]] = []
    scratch = None
    for op, i in uprog.flatten():
        if isinstance(op, Ap):
            srcs = [ref(r, i, False) for r in op.triple]
            dsts = [ref(r, i, True) for r in op.triple]
        elif isinstance(op, Aap):
            if op.is_maj_src:
                srcs = [ref(r, i, False) for r in op.src]
                dsts = [ref(r, i, True) for r in op.src]
            else:
                srcs = [ref(op.src, i, False)] * 3
                dsts = []
            dsts += [ref(r, i, True) for r in op.dsts]
        else:
            raise ValueError(f"unknown uop {op}")
        if len(dsts) > WRITES:
            # keep the value in a scratch slot and copy it on from there
            if scratch is None:
                scratch = len(init) << 1
                init.append(-1)
            rows.append(srcs + [scratch] + dsts[:WRITES - 1])
            srcs, dsts = [scratch] * 3, dsts[WRITES - 1:]
            while len(dsts) > WRITES:
                rows.append(srcs + dsts[:WRITES])
                dsts = dsts[WRITES:]
        rows.append(srcs + dsts + [dsts[-1]] * (WRITES - len(dsts)))
    outs = []
    for bit in range(out_bits):
        key = ("OUT", bit)        # the D-group row a μProgram writes
        inside = "OUT" in width and bit < width["OUT"]
        outs.append(d_slot(key) if key in slots or inside else ZERO_SLOT)
    if len(init) > MAX_SLOTS:
        raise ValueError(f"{uprog.name}: {len(init)} rows exceed the VM's "
                         f"{MAX_SLOTS} slots")
    fields = np.asarray(rows, np.uint32).reshape(-1, 7)
    fields = np.concatenate([fields, np.zeros((len(rows), 1), np.uint32)],
                            axis=1)
    words = fields[:, 0::2] | fields[:, 1::2] << np.uint32(16)
    return LoweredProgram(len(init), np.asarray(init, np.int32),
                          np.asarray(outs, np.int32),
                          np.ascontiguousarray(words).view(np.int32))
