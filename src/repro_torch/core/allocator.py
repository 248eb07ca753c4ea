"""Step 2a: row-to-operand allocation (Appendix B).

Maps each MAJ node of a cell MIG onto one of the four legal TRA triples,
emitting the AAP copies needed to stage operands, under the two PuM
constraints the paper highlights:

  (1) TRA is *destructive* — all three activated rows are overwritten with
      the majority value;
  (2) only six compute rows exist (T0–T3, DCC0, DCC1), so live intermediate
      values may need to be spilled to D-group temporary rows.

The allocator is a greedy linear-scan variant: nodes are visited in
topological order; for each node every (triple × operand-permutation) is
costed — reusing operands already resident in compute rows, preferring DCC
rows for complemented operands (1 AAP via the n-wordline instead of 2), and
charging spills for live sole-copy values in clobbered rows.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from .mig import Mig, Sig
from .subarray import (DCC_ROWS, TRA_TRIPLES, RowRef, b, c, is_dcc)
from .uprogram import Aap, Ap, UOp

Want = Tuple  # ('SIG', sig_id, phase) | ('CONST', v)


def _want(sig: Sig) -> Want:
    nid, neg = sig
    if nid == 0:
        return ("CONST", 1 if neg else 0)
    return ("SIG", nid, bool(neg))


def _neg_want(w: Want) -> Want:
    if w[0] == "CONST":
        return ("CONST", 1 - w[1])
    return ("SIG", w[1], not w[2])


class CellAllocator:
    def __init__(self, mig: Mig, outputs: Dict[RowRef, Sig],
                 inputs: Dict[str, RowRef], tmp_prefix: str = "__t"):
        self.mig = mig
        self.outputs = dict(outputs)
        self.tmp_prefix = tmp_prefix
        self.tmp_count = 0
        self.ops: List[UOp] = []
        # B-group row contents: name -> Want or None
        self.row_val: Dict[str, Optional[Want]] = {r: None for r in
                                                   ("T0", "T1", "T2", "T3",
                                                    "DCC0", "DCC1")}
        # off-subarray locations (D-group rows): Want -> RowRef
        self.d_loc: Dict[Want, RowRef] = {}
        for name, ref in inputs.items():
            sig = mig.input(name)
            if ref[0] == "B":
                # value already resident in a compute row (e.g. the carry
                # kept in a B-group row across loop iterations, Sec 2.3.2)
                self.row_val[ref[1]] = ("SIG", sig[0], False)
            else:
                self.d_loc[("SIG", sig[0], False)] = ref
        # liveness: remaining uses per sig id
        self.uses: Dict[int, int] = {}
        order = mig.maj_nodes(list(outputs.values()))
        self._order = order
        for nid in order:
            for (cid, _) in mig.nodes[nid].children:
                if cid != 0:
                    self.uses[cid] = self.uses.get(cid, 0) + 1
        for sig in outputs.values():
            if sig[0] != 0:
                self.uses[sig[0]] = self.uses.get(sig[0], 0) + 1

    # -- value availability -------------------------------------------------
    def _sources(self, want: Want, exclude: frozenset = frozenset()) -> List[RowRef]:
        """All rows readable via AAP that currently yield ``want``."""
        out: List[RowRef] = []
        for name, val in self.row_val.items():
            if name in exclude or val is None:
                continue
            if val == want:
                out.append(b(name))
            if is_dcc(name) and val == _neg_want(want):
                out.append(b("~" + name))       # n-wordline read
        if want in self.d_loc:
            out.append(self.d_loc[want])
        if want[0] == "CONST":
            out.append(c(want[1]))
        return out

    def _live(self, want: Optional[Want]) -> bool:
        if want is None or want[0] == "CONST":
            return False
        return self.uses.get(want[1], 0) > 0

    def _spill_if_sole(self, row: str, exclude: frozenset) -> None:
        """If `row` holds a live value with no other source, spill it."""
        val = self.row_val[row]
        if not self._live(val):
            return
        others = [s for s in self._sources(val, exclude=exclude | {row})]
        if others:
            return
        tmp = ("D", f"{self.tmp_prefix}{self.tmp_count}", 0, 0)
        self.tmp_count += 1
        self.ops.append(Aap((tmp,), b(row)))
        self.d_loc[val] = tmp

    # -- operand staging ----------------------------------------------------
    def _load_cost(self, want: Want, row: str) -> int:
        if self.row_val[row] == want:
            return 0
        if self._sources(want):
            return 1
        if self._sources(_neg_want(want)):
            # negation: via DCC n-wordline. 1 AAP if target is a DCC row,
            # else 2 (stage through a DCC then copy out).
            return 1 if is_dcc(row) else 2
        return 99  # unobtainable (should not happen)

    def _emit_load(self, want: Want, row: str, triple_rows: frozenset) -> None:
        if self.row_val[row] == want:
            return
        srcs = self._sources(want)
        if srcs:
            self.ops.append(Aap((b(row),), srcs[0]))
            self.row_val[row] = want
            return
        nsrcs = self._sources(_neg_want(want))
        assert nsrcs, f"value {want} unobtainable"
        if is_dcc(row):
            # write complement through the n-wordline
            self.ops.append(Aap((b("~" + row),), nsrcs[0]))
            self.row_val[row] = want
            return
        # stage through the DCC that is not part of this triple
        aux = next(dn for dn in DCC_ROWS if dn not in triple_rows)
        self._spill_if_sole(aux, triple_rows)
        self.ops.append(Aap((b("~" + aux),), nsrcs[0]))
        self.row_val[aux] = want
        self.ops.append(Aap((b(row),), b(aux)))
        self.row_val[row] = want

    # -- main ---------------------------------------------------------------
    def run(self) -> List[UOp]:
        for nid in self._order:
            node = self.mig.nodes[nid]
            wants = [_want(s) for s in node.children]
            best = None
            for triple in TRA_TRIPLES:
                trows = frozenset(triple)
                for perm in itertools.permutations(range(3)):
                    cost = sum(self._load_cost(wants[k], triple[j])
                               for j, k in enumerate(perm))
                    # spill penalty for live sole-copy values in clobbered rows
                    for r in triple:
                        val = self.row_val[r]
                        if self._live(val) and val not in [wants[k] for k in perm] \
                                and not self._sources(val, exclude=trows):
                            cost += 1
                    if best is None or cost < best[0]:
                        best = (cost, triple, perm)
            _, triple, perm = best
            trows = frozenset(triple)
            # spills first (any live sole value in a row about to be clobbered)
            for r in triple:
                self._spill_if_sole(r, trows)
            # stage operands; order loads so sources are read before their row
            # is overwritten
            pending = [(wants[k], triple[j]) for j, k in enumerate(perm)
                       if self.row_val[triple[j]] != wants[k]]
            # rows still matching their operand are "in place"
            for j, k in enumerate(perm):
                if self.row_val[triple[j]] == wants[k]:
                    pass
            emitted = True
            while pending and emitted:
                emitted = False
                for idx, (want, row) in enumerate(pending):
                    # does any other pending load read from `row`?
                    conflict = False
                    for w2, r2 in pending:
                        if (w2, r2) == (want, row):
                            continue
                        for s in self._sources(w2):
                            if s[0] == "B" and (s[1] == row or
                                                (s[1].startswith("~") and s[1][1:] == row)):
                                # only a conflict if `row` is the sole source
                                if len(self._sources(w2)) == 1:
                                    conflict = True
                        if conflict:
                            break
                    if not conflict:
                        self._emit_load(want, row, trows)
                        pending.pop(idx)
                        emitted = True
                        break
            if pending:  # cycle: break it by spilling one source to a tmp
                want, row = pending[0]
                self._spill_if_sole(row, frozenset())
                # force-spill even if not sole: stage via tmp
                val = self.row_val[row]
                if val is not None:
                    tmp = ("D", f"{self.tmp_prefix}{self.tmp_count}", 0, 0)
                    self.tmp_count += 1
                    self.ops.append(Aap((tmp,), b(row)))
                    self.d_loc[val] = tmp
                    self.row_val[row] = None
                for (w2, r2) in pending:
                    self._emit_load(w2, r2, trows)
                pending = []
            # the TRA
            self.ops.append(Ap(tuple(b(r) for r in triple)))
            res: Want = ("SIG", nid, False)
            for r in triple:
                self.row_val[r] = res
            # consume operand uses
            for (cid, _) in node.children:
                if cid != 0:
                    self.uses[cid] -= 1
        # write outputs
        for dst, sig in self.outputs.items():
            want = _want(sig)
            srcs = self._sources(want)
            if srcs:
                self.ops.append(Aap((dst,), srcs[0]))
            else:
                nsrcs = self._sources(_neg_want(want))
                assert nsrcs, f"output {want} unobtainable"
                aux = "DCC0" if not self._live(self.row_val["DCC0"]) else "DCC1"
                self.ops.append(Aap((b("~" + aux),), nsrcs[0]))
                self.row_val[aux] = want
                self.ops.append(Aap((dst,), b(aux)))
            if sig[0] != 0:
                self.uses[sig[0]] -= 1
            if want[0] == "SIG":
                if dst[0] == "B":
                    self.row_val[dst[1]] = want
                else:
                    self.d_loc[want] = dst
        return self.ops


def allocate_cell(mig: Mig, outputs: Dict[RowRef, Sig],
                  inputs: Dict[str, RowRef]) -> Tuple[List[UOp], int]:
    """Allocate one cell; returns (μOps, #tmp D-rows used)."""
    alloc = CellAllocator(mig, outputs, inputs)
    ops = alloc.run()
    return ops, alloc.tmp_count
