"""AND-OR-Inverter Graphs (AOIGs) — the input representation to Step 1.

Users (or the built-in operation library) describe a 1-bit cell of an
operation with AND/OR/NOT logic; SIMDRAM Step 1 (synthesis.py) converts it to
an optimized Majority-Inverter Graph.

Edges are (node_id, negated) pairs; nodes are hash-consed so structurally
identical subcircuits share one node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

Sig = Tuple[int, bool]  # (node id, complemented edge)


@dataclasses.dataclass(frozen=True)
class AoigNode:
    kind: str                  # 'const0' | 'input' | 'and' | 'or'
    name: str = ""             # for inputs
    a: Sig = (0, False)
    b: Sig = (0, False)


class Aoig:
    """Hash-consed AND/OR/NOT DAG.  Node 0 is constant 0."""

    def __init__(self):
        self.nodes: List[AoigNode] = [AoigNode("const0")]
        self._cache: Dict[tuple, int] = {}
        self._inputs: Dict[str, int] = {}

    # -- construction -----------------------------------------------------
    def const(self, v: bool) -> Sig:
        return (0, bool(v))

    def input(self, name: str) -> Sig:
        if name not in self._inputs:
            self.nodes.append(AoigNode("input", name=name))
            self._inputs[name] = len(self.nodes) - 1
        return (self._inputs[name], False)

    def _mk(self, kind: str, a: Sig, b: Sig) -> Sig:
        if a > b:
            a, b = b, a
        key = (kind, a, b)
        if key not in self._cache:
            self.nodes.append(AoigNode(kind, a=a, b=b))
            self._cache[key] = len(self.nodes) - 1
        return (self._cache[key], False)

    @staticmethod
    def not_(s: Sig) -> Sig:
        return (s[0], not s[1])

    def and_(self, a: Sig, b: Sig) -> Sig:
        return self._mk("and", a, b)

    def or_(self, a: Sig, b: Sig) -> Sig:
        return self._mk("or", a, b)

    def xor_(self, a: Sig, b: Sig) -> Sig:
        return self.or_(self.and_(a, self.not_(b)), self.and_(self.not_(a), b))

    def mux(self, sel: Sig, t: Sig, f: Sig) -> Sig:
        """sel ? t : f"""
        return self.or_(self.and_(sel, t), self.and_(self.not_(sel), f))

    # -- evaluation (oracle) ----------------------------------------------
    def eval(self, outputs: List[Sig], env: Dict[str, object]):
        """Evaluate signals; env maps input name -> bool/int/array (bitwise)."""
        memo: Dict[int, object] = {0: 0}
        order = list(range(len(self.nodes)))
        for nid in order:
            node = self.nodes[nid]
            if node.kind == "const0":
                memo[nid] = 0
            elif node.kind == "input":
                memo[nid] = env[node.name]
            else:
                va = memo[node.a[0]] ^ (-1 if node.a[1] else 0)
                vb = memo[node.b[0]] ^ (-1 if node.b[1] else 0)
                memo[nid] = (va & vb) if node.kind == "and" else (va | vb)
        out = []
        for (nid, neg) in outputs:
            v = memo[nid]
            out.append(v ^ (-1 if neg else 0))
        return out

    def num_gates(self) -> int:
        return sum(1 for n in self.nodes if n.kind in ("and", "or"))
