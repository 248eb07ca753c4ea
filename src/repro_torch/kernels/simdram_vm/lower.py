"""Lower a μProgram to the instruction stream of the μProgram-VM kernel.

The kernel (``csrc/simdram_vm.cu``) is compiled once and runs any
μProgram: the program is data.  Two host stages turn a μProgram into
that data.

**Stage 1, :func:`lower`**, unrolls ``UProgram.flatten()`` and gives every
row the program touches a *slot*:

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
complement of its cell.  Each stage-1 instruction is four int32 words
holding eight fields ``s0 s1 s2 d0 d1 d2 d3 -``: the majority of s0–s2,
written to d0–d3 in order.  So

* an AP is ``MAJ(t0, t1, t2) → t0, t1, t2``;
* an AAP with a MAJ source is ``MAJ(t0, t1, t2) → t0, t1, t2, dst``: the
  majority goes back into its triple first, then to its destination;
* an AAP copy is ``MAJ(src, src, src) → dsts`` (the majority of one value
  is that value);

and unused write fields repeat the last write, which changes nothing.
Every source is read before any destination is written, as a triple-row
activation does.  Stage 1 is the μOp-level stream, one instruction per
μOp, checked on the CPU against ``execute`` instruction for instruction.

**Stage 2, :func:`compile_lowered`**, is what the kernel runs.  It
executes the stage-1 stream symbolically over values that are the zero
row, an input plane or a MAJ node of three operands, each operand a value
and a complement flag.  Copies and complemented reads and writes become
renames; ``MAJ(x, x, y) = x`` and ``MAJ(x, ~x, y) = y`` fold duplicates
and constants; MAJ's self-duality leaves at most one complemented operand
per node; nodes of equal operands are shared, and nodes that no output
reaches are dropped.  What is left is a stream of four kinds of 8-byte
instructions over a row file allocated by liveness:

* ``MAJ``: ``maj(a ^ ma, b, c) → dst``, only the first operand ever
  complemented;
* ``LOAD``: an input plane from memory into ``dst``; planes are loaded in
  groups of ``LOAD_GROUP``, in the order of their first reads, so that a
  group is in flight at once;
* ``WAIT``: until this thread's LOADs have landed; one goes before the
  first read of a slot whose LOAD may be in flight;
* ``STORE``: a slot, or its complement, to an output plane, as soon as
  the plane's value is final; every output plane is stored once.

Slot 0 holds the zero row, so a constant is a read of slot 0.  An
instruction is four 16-bit fields ``f0 f1 f2 f3``, f0 in the low half of
its first int32 word; ``f3 = dst << 2 | kind`` and

* ``MAJ``: f0–f2 are the operands, ``slot << 1 | complement``;
* ``LOAD``: f0 is the input, f1 its plane;
* ``STORE``: f0 is the source, ``slot << 1 | complement``; f1 the output
  plane.

The stream is padded with WAITs to a multiple of ``AHEAD`` instructions,
and ``AHEAD`` more follow that the kernel may fetch and never runs.
The input planes are only ever read.
"""
from __future__ import annotations

import dataclasses
import heapq
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


#: instruction kinds of the compiled stream (the low two bits of f3)
MAJ, LOAD, STORE, WAIT = 0, 1, 2, 3
#: slots a compiled destination field can name (14 bits beside the kind)
MAX_COMPILED_SLOTS = 1 << 14
#: input planes loaded together, ahead of the first of their uses
LOAD_GROUP = 8
#: the kernel fetches the stream in groups of ``AHEAD`` instructions, one
#: group ahead: it runs a multiple of ``AHEAD`` and may fetch one group
#: more
AHEAD = 8


@dataclasses.dataclass
class CompiledProgram:
    """Stage 2: the stream the kernel runs, over a liveness-allocated row
    file whose slot 0 is the zero row."""

    n_slots: int
    code: np.ndarray         # int32[n_instr + AHEAD, 2]: four 16-bit fields
    n_maj: int               # MAJ instructions: LOP3s per 32-lane word
    n_loads: int             # input planes the program reads
    out_bits: int

    @property
    def n_instr(self) -> int:
        """Instructions the kernel runs: a multiple of ``AHEAD``, padded
        with WAITs; ``AHEAD`` more WAITs follow, which it may fetch and
        never runs."""
        return self.code.shape[0] - AHEAD


def _maj(nodes: List[tuple], shared: Dict[tuple, int], a: int, b: int,
         c: int) -> int:
    """The value of MAJ over three literals (``node << 1 | complement``),
    folded where an operand pair decides it and shared where the same
    node exists."""
    if a == b or a == c:
        return a
    if b == c:
        return b
    if a == b ^ 1:
        return c
    if a == c ^ 1:
        return b
    if b == c ^ 1:
        return a
    # MAJ is self-dual: keep at most one complemented operand per node
    neg = (a & 1) + (b & 1) + (c & 1) >= 2
    key = tuple(sorted((a ^ neg, b ^ neg, c ^ neg)))
    node = shared.get(key)
    if node is None:
        node = shared[key] = len(nodes)
        nodes.append(("maj",) + key)
    return node << 1 | neg


def _dataflow(lp: LoweredProgram) -> Tuple[List[tuple], List[int]]:
    """Execute the stage-1 stream symbolically: the nodes (zero, input
    planes, MAJ) and the literal of each output plane."""
    nodes: List[tuple] = [("zero",)]
    shared: Dict[tuple, int] = {}
    rows = []                          # literal held by each stage-1 slot
    for code in lp.init.tolist():
        if code < 0:
            rows.append(0)
        else:
            rows.append(len(nodes) << 1)
            nodes.append(("load", code >> 16, code & 0xFFFF))
    words = lp.instrs.view(np.uint32)
    fields = np.stack([words & 0xFFFF, words >> 16], axis=-1).reshape(-1, 8)
    for row in fields.tolist():
        v = _maj(nodes, shared, *(rows[f >> 1] ^ (f & 1) for f in row[:3]))
        for f in row[3:7]:             # in order: the last write wins
            rows[f >> 1] = v ^ (f & 1)
    return nodes, [rows[s] for s in lp.out_slots.tolist()]


def _schedule(nodes: List[tuple], outs: List[int]) -> List[tuple]:
    """The live nodes in creation order as (kind, node, read literals,
    output plane): each output stored right after its value, constant
    outputs first, input planes loaded in groups of ``LOAD_GROUP`` in the
    order of their first reads, each group just before the first read of
    its first plane."""
    live = [False] * len(nodes)
    for lit in outs:
        live[lit >> 1] = True
    for k in range(len(nodes) - 1, 0, -1):
        if live[k] and nodes[k][0] == "maj":
            for lit in nodes[k][1:]:
                live[lit >> 1] = True
    stores: Dict[int, List[int]] = {}
    for bit, lit in enumerate(outs):
        stores.setdefault(lit >> 1, []).append(bit)
    body: List[tuple] = []
    for k in range(len(nodes)):       # node 0, the zero row, comes first
        if live[k] and nodes[k][0] == "maj":
            body.append((MAJ, k, nodes[k][1:], None))
        body += [(STORE, None, (outs[bit],), bit) for bit in stores.get(k, ())]
    first_reads = list(dict.fromkeys(
        lit >> 1 for _, _, reads, _ in body for lit in reads
        if nodes[lit >> 1][0] == "load"))
    prog: List[tuple] = []
    loaded: set = set()
    for ins in body:
        while any(nodes[lit >> 1][0] == "load" and lit >> 1 not in loaded
                  for lit in ins[2]):
            group = first_reads[len(loaded):len(loaded) + LOAD_GROUP]
            prog += [(LOAD, node, (), None) for node in group]
            loaded.update(group)
        prog.append(ins)
    return prog


def compile_lowered(lp: LoweredProgram) -> CompiledProgram:
    """Compile a stage-1 stream into the kernel's stream (module doc)."""
    nodes, outs = _dataflow(lp)
    prog = _schedule(nodes, outs)
    # linear-scan slot allocation: a value lives from its definition to
    # its last read; a slot freed by an instruction's last read may be its
    # destination (the kernel reads every operand before it writes).  A
    # LOAD lands later: a WAIT goes before the first read of a slot whose
    # LOAD may still be in flight.
    last = {}
    for pos, (_, _, reads, _) in enumerate(prog):
        for lit in reads:
            last[lit >> 1] = pos
    slot = {0: 0}
    free: List[int] = []
    in_flight = set()
    n_slots = 1
    rows = []
    for pos, (kind, node, reads, field) in enumerate(prog):
        if in_flight & {lit >> 1 for lit in reads}:
            rows.append((0, 0, 0, WAIT))
            in_flight.clear()
        # the complemented operand of a MAJ (at most one) goes first
        refs = sorted((slot[lit >> 1] << 1 | (lit & 1) for lit in reads),
                      key=lambda f: -(f & 1))
        for lit in reads:
            if last[lit >> 1] == pos and lit >> 1:
                heapq.heappush(free, slot.pop(lit >> 1))
        dst = 0
        if node is not None:
            dst = heapq.heappop(free) if free else n_slots
            n_slots = max(n_slots, dst + 1)
            slot[node] = dst
        if kind == MAJ:
            assert sum(f & 1 for f in refs) <= 1
            rows.append((*refs, dst << 2 | kind))
        elif kind == LOAD:
            rows.append((*nodes[node][1:], 0, dst << 2 | kind))
            in_flight.add(node)
        else:
            rows.append((refs[0], field, 0, kind))
    if n_slots > MAX_COMPILED_SLOTS:
        raise ValueError(f"{n_slots} live rows exceed the VM's "
                         f"{MAX_COMPILED_SLOTS} slots")
    rows += [(0, 0, 0, WAIT)] * (-len(rows) % AHEAD + AHEAD)
    code = np.asarray(rows, np.uint32)
    words = code[:, 0::2] | code[:, 1::2] << np.uint32(16)
    return CompiledProgram(n_slots, np.ascontiguousarray(words).view(
        np.int32), sum(p[0] == MAJ for p in prog),
        sum(p[0] == LOAD for p in prog), len(outs))
