"""μOps, μPrograms, and the coalescing optimizer (Step 2b, Sec. 2.3.2).

A μProgram is a list of segments; each segment's body executes ``trips``
times with loop variable i = 0..trips-1 (the control unit's Loop Counter /
addi/bnez μOps).  D-group row references inside a body are affine in i, so a
single stored body generalizes the 1-bit cell to n-bit operation, exactly as
the paper describes.

Command-sequence μOps:
  Aap(dsts, src) — AAP: ACTIVATE(src) → ACTIVATE(dsts) → PRECHARGE.  If
      ``src`` is a TRA triple (coalescing Case 2), the first activation
      computes MAJ of the triple in place and the copy propagates it.
      Multiple dsts model the multi-target μRegisters (Case 1).
  Ap(triple)    — AP: triple-row activation (in-place MAJ) → PRECHARGE.

Control μOps (addi/subi/comp/bnez/done) are represented implicitly by the
segment structure; `listing()` renders the explicit form for display.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .subarray import MULTI_COPY_SETS, RowRef, TRA_TRIPLES


@dataclasses.dataclass(frozen=True)
class Aap:
    dsts: Tuple[RowRef, ...]
    src: object  # RowRef or Tuple[RowRef, RowRef, RowRef] (TRA triple)

    @property
    def is_maj_src(self) -> bool:
        return isinstance(self.src, tuple) and len(self.src) == 3 and \
            all(isinstance(r, tuple) and r and r[0] in ("B",) for r in self.src)


@dataclasses.dataclass(frozen=True)
class Ap:
    triple: Tuple[RowRef, RowRef, RowRef]


UOp = object


@dataclasses.dataclass
class Segment:
    body: List[UOp]
    trips: int = 1
    comment: str = ""


@dataclasses.dataclass
class UProgram:
    name: str
    n_bits: int
    segments: List[Segment]

    # -- cost -------------------------------------------------------------
    def command_count(self) -> dict:
        """AAP/AP command-sequence counts (the paper's latency unit).

        ``AAP_maj`` counts coalesced Case-2 AAPs whose first activation is a
        TRA — same single command sequence, but the TRA activation energy
        applies (cost model distinguishes them)."""
        aap = ap = aap_maj = 0
        for seg in self.segments:
            for op in seg.body:
                if isinstance(op, Ap):
                    ap += seg.trips
                elif isinstance(op, Aap):
                    if op.is_maj_src:
                        aap_maj += seg.trips
                    else:
                        aap += seg.trips
        return {"AAP": aap, "AAP_maj": aap_maj, "AP": ap,
                "total": aap + ap + aap_maj}

    def flatten(self) -> List[Tuple[UOp, int]]:
        """Unrolled (μOp, loop_i) stream — what the control unit issues."""
        out = []
        for seg in self.segments:
            for i in range(seg.trips):
                for op in seg.body:
                    out.append((op, i))
        return out

    def listing(self, max_lines: int = 60) -> str:
        """Human-readable μProgram (cf. Fig. 2.5c)."""
        lines = [f"; uProgram {self.name} (n={self.n_bits})"]

        def fmt_row(r):
            if isinstance(r, tuple) and r and r[0] == "B":
                return r[1]
            if isinstance(r, tuple) and r and r[0] == "C":
                return f"C{r[1]}"
            if isinstance(r, tuple) and r and r[0] == "D":
                _, nm, a, off = r
                if a == 0:
                    return f"{nm}[{off}]"
                pre = "i" if a == 1 else f"{a}*i"
                return f"{nm}[{pre}{off:+d}]" if off else f"{nm}[{pre}]"
            return str(r)

        for seg in self.segments:
            if seg.trips > 1:
                lines.append(f"  ; loop x{seg.trips}  {seg.comment}")
            for op in seg.body:
                if isinstance(op, Aap):
                    src = ("MAJ(" + ",".join(fmt_row(r) for r in op.src) + ")"
                           ) if op.is_maj_src else fmt_row(op.src)
                    lines.append("  AAP  " + ",".join(fmt_row(d) for d in op.dsts)
                                 + "  <-  " + src)
                elif isinstance(op, Ap):
                    lines.append("  AP   " + ",".join(fmt_row(r) for r in op.triple))
            if seg.trips > 1:
                lines.append("  addi i,1 ; bnez i,loop")
        lines.append("  done")
        if len(lines) > max_lines:
            lines = lines[:max_lines] + [f"  ... ({len(lines)-max_lines} more lines)"]
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Coalescing (Sec. 2.3.2 "Optimizing the Series of μOps")
# --------------------------------------------------------------------------
def coalesce(body: Sequence[UOp]) -> List[UOp]:
    """Apply Case 1 (multi-target AAP merge) and Case 2 (AP+AAP merge)."""
    ops = list(body)

    # Case 2: AP(triple) immediately followed by AAP(dst, row in triple)
    out: List[UOp] = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if (isinstance(op, Ap) and i + 1 < len(ops)
                and isinstance(ops[i + 1], Aap)
                and not ops[i + 1].is_maj_src
                and ops[i + 1].src in op.triple):
            out.append(Aap(dsts=ops[i + 1].dsts, src=op.triple))
            i += 2
            continue
        out.append(op)
        i += 1
    ops = out

    # Case 1: merge adjacent AAPs with identical src whose combined dst set
    # is covered by a multi-target μRegister.
    out = []
    for op in ops:
        if (out and isinstance(op, Aap) and isinstance(out[-1], Aap)
                and op.src == out[-1].src and not op.is_maj_src):
            names = set()
            ok = True
            for r in out[-1].dsts + op.dsts:
                if isinstance(r, tuple) and r[0] == "B":
                    names.add(r[1])
                else:
                    ok = False
                    break
            if ok and any(names <= s for s in MULTI_COPY_SETS):
                out[-1] = Aap(dsts=out[-1].dsts + op.dsts, src=op.src)
                continue
        out.append(op)
    return out


def assert_valid(prog: UProgram) -> None:
    """Structural validity: APs use legal TRA triples; AAP MAJ-sources too."""
    legal = {frozenset(t) for t in TRA_TRIPLES}
    for seg in prog.segments:
        for op in seg.body:
            if isinstance(op, Ap):
                names = frozenset(r[1] for r in op.triple)
                assert names in legal, f"illegal TRA triple {names} in {prog.name}"
            elif isinstance(op, Aap) and op.is_maj_src:
                names = frozenset(r[1] for r in op.src)
                assert names in legal, f"illegal MAJ source {names} in {prog.name}"
