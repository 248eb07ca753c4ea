"""Majority-Inverter Graphs (MIGs) — SIMDRAM's compute representation.

Each node is a 3-input majority gate; edges may be complemented.  The MIG
axioms used by the greedy optimizer follow the transformation rules the
thesis adopts from Amarù et al. (Table A.1):

  Ω.C  commutativity          M(x,y,z) invariant under permutation
  Ω.M  majority               M(x,x,y) = x ;  M(x,¬x,y) = y
  Ω.I  inverter propagation   ¬M(x,y,z) = M(¬x,¬y,¬z)
  const folding               M(0,x,y) = AND,  M(1,x,y) = OR,
                              M(0,0,x)=0, M(1,1,x)=1, M(0,1,x)=x

plus hash-consing (structural sharing).  Together with the hand-derived
optimized cells in operations.py this reproduces the paper's Step 1 output
(e.g. the 3-node full-adder MIG of Fig. 2.5a).

Node ids: 0 is constant 0.  Signals are (node_id, complemented).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Sig = Tuple[int, bool]

CONST0: Sig = (0, False)
CONST1: Sig = (0, True)


@dataclasses.dataclass(frozen=True)
class MigNode:
    kind: str                   # 'const0' | 'input' | 'maj'
    name: str = ""
    children: Tuple[Sig, Sig, Sig] = (CONST0, CONST0, CONST0)


class Mig:
    def __init__(self, opt: bool = True):
        """``opt=False`` disables the axiomatic rewrites (keeps only Ω.C
        ordering + hash-consing) — used for the *naive* AOIG-substitution MIG
        that models the Ambit AND/OR/NOT baseline."""
        self.opt = opt
        self.nodes: List[MigNode] = [MigNode("const0")]
        self._cache: Dict[tuple, Sig] = {}
        self._inputs: Dict[str, int] = {}
        self.outputs: Dict[str, Sig] = {}

    # -- construction -----------------------------------------------------
    def input(self, name: str) -> Sig:
        if name not in self._inputs:
            self.nodes.append(MigNode("input", name=name))
            self._inputs[name] = len(self.nodes) - 1
        return (self._inputs[name], False)

    @staticmethod
    def not_(s: Sig) -> Sig:
        return (s[0], not s[1])

    def maj(self, a: Sig, b: Sig, c: Sig) -> Sig:
        """Create a MAJ node, applying local rewrite rules eagerly."""
        # Ω.C: canonical order
        a, b, c = sorted((a, b, c))
        if not self.opt:
            key = (a, b, c)
            if key not in self._cache:
                self.nodes.append(MigNode("maj", children=(a, b, c)))
                self._cache[key] = (len(self.nodes) - 1, False)
            return self._cache[key]
        # Ω.M duplicates: M(x,x,y) = x
        if a == b:
            return a
        if b == c:
            return b
        # Ω.M complements: M(x,¬x,y) = y
        if a[0] == b[0] and a[1] != b[1]:
            return c
        if b[0] == c[0] and b[1] != c[1]:
            return a
        if a[0] == c[0] and a[1] != c[1]:
            return b
        # const folding beyond the duplicate rules: M(0,1,x)=x handled above
        # (a==(0,False), b==(0,True) differ only in neg -> returns c).
        # Ω.I canonical polarity: majority of complemented children -> push out
        negs = sum(1 for s in (a, b, c) if s[1])
        out_neg = False
        if negs >= 2:
            # Only safe to invert *all three* (self-duality); flipping when
            # exactly 2 are complemented would change the function, so only
            # apply when all 3 are complemented.
            if negs == 3:
                a, b, c = (a[0], False), (b[0], False), (c[0], False)
                a, b, c = sorted((a, b, c))
                out_neg = True
        key = (a, b, c)
        if key not in self._cache:
            self.nodes.append(MigNode("maj", children=(a, b, c)))
            self._cache[key] = (len(self.nodes) - 1, False)
        base = self._cache[key]
        return (base[0], base[1] ^ out_neg)

    def and_(self, a: Sig, b: Sig) -> Sig:
        return self.maj(a, b, CONST0)

    def or_(self, a: Sig, b: Sig) -> Sig:
        return self.maj(a, b, CONST1)

    xor_mode = "aoi"  # 'aoi' | 'maj' — candidate forms costed by the allocator

    def xor_(self, a: Sig, b: Sig) -> Sig:
        if self.opt and self.xor_mode == "maj":
            # a⊕b = M( M(a,b,1), ¬M(a,b,0), 0 ) — the complement lands on an
            # *intermediate* (free via a DCC n-wordline) instead of on the
            # two inputs.
            return self.maj(self.maj(a, b, CONST1),
                            self.not_(self.maj(a, b, CONST0)), CONST0)
        return self.or_(self.and_(a, self.not_(b)), self.and_(self.not_(a), b))

    def mux(self, sel: Sig, t: Sig, f: Sig) -> Sig:
        return self.or_(self.and_(sel, t), self.and_(self.not_(sel), f))

    # -- stats ------------------------------------------------------------
    def maj_nodes(self, outputs: Sequence[Sig] | None = None) -> List[int]:
        """Topologically ordered MAJ node ids in the transitive fanin of
        ``outputs`` (all outputs if None)."""
        outs = list(outputs) if outputs is not None else list(self.outputs.values())
        seen: set[int] = set()
        order: List[int] = []

        def visit(nid: int):
            if nid in seen:
                return
            seen.add(nid)
            node = self.nodes[nid]
            if node.kind == "maj":
                for (cid, _) in node.children:
                    visit(cid)
                order.append(nid)

        for (nid, _) in outs:
            visit(nid)
        return order

    def size(self, outputs: Sequence[Sig] | None = None) -> int:
        return len(self.maj_nodes(outputs))

    def depth(self, outputs: Sequence[Sig] | None = None) -> int:
        outs = list(outputs) if outputs is not None else list(self.outputs.values())
        memo: Dict[int, int] = {}

        def d(nid: int) -> int:
            if nid in memo:
                return memo[nid]
            node = self.nodes[nid]
            if node.kind != "maj":
                memo[nid] = 0
            else:
                memo[nid] = 1 + max(d(c) for (c, _) in node.children)
            return memo[nid]

        return max((d(n) for (n, _) in outs), default=0)

    # -- evaluation (oracle) ----------------------------------------------
    def eval(self, outputs: Sequence[Sig], env: Dict[str, int]) -> List[int]:
        """Bitwise evaluation; env values are Python ints used as bitvectors
        (complement = XOR with -1; mask final results to the word width)."""
        memo: Dict[int, int] = {0: 0}
        for nid, node in enumerate(self.nodes):
            if node.kind == "input":
                memo[nid] = env[node.name]
        for nid in self.maj_nodes(outputs):
            ch = self.nodes[nid].children
            vals = [memo[c] ^ (-1 if neg else 0) for (c, neg) in ch]
            memo[nid] = (vals[0] & vals[1]) | (vals[0] & vals[2]) | (vals[1] & vals[2])
        return [memo[nid] ^ (-1 if neg else 0) for (nid, neg) in outputs]
