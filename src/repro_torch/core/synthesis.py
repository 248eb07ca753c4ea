"""Step 1 of the SIMDRAM framework: AOIG → optimized MIG.

Two entry points:

* :func:`aoig_to_mig` — the paper's two-part transformation: (1) naive
  substitution (AND→MAJ(·,·,0), OR→MAJ(·,·,1)), then (2) greedy axiomatic
  optimization (``optimize=True``) or not (``optimize=False``, the Ambit
  AND/OR/NOT-equivalent baseline used for the Fig 2.9/2.10 comparisons).

* :func:`optimize_mig` — the greedy fixpoint pass: rebuilds the graph bottom
  up through the eagerly-rewriting constructor (Ω.C/Ω.M/Ω.I + const folding +
  hash-consing) until the node count stops shrinking.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .aoig import Aoig
from .mig import CONST0, CONST1, Mig, Sig


def aoig_to_mig(aoig: Aoig, outputs: Sequence[Sig], optimize: bool = True
                ) -> Tuple[Mig, List[Sig]]:
    mig = Mig(opt=optimize)
    memo: Dict[int, Sig] = {0: CONST0}
    for nid, node in enumerate(aoig.nodes):
        if node.kind == "const0":
            continue
        if node.kind == "input":
            memo[nid] = mig.input(node.name)
            continue
        a = memo[node.a[0]]
        b = memo[node.b[0]]
        if node.a[1]:
            a = Mig.not_(a)
        if node.b[1]:
            b = Mig.not_(b)
        memo[nid] = mig.maj(a, b, CONST0 if node.kind == "and" else CONST1)
    outs = []
    for (nid, neg) in outputs:
        s = memo[nid]
        outs.append((s[0], s[1] ^ neg))
    if optimize:
        return optimize_mig(mig, outs)
    return mig, outs


def optimize_mig(mig: Mig, outputs: Sequence[Sig],
                 max_rounds: int = 8) -> Tuple[Mig, List[Sig]]:
    """Greedy size-reduction: repeatedly reconstruct the transitive fanin of
    ``outputs`` through an eagerly-rewriting Mig until fixpoint."""
    cur, outs = mig, list(outputs)
    best = cur.size(outs)
    for _ in range(max_rounds):
        new = Mig(opt=True)
        memo: Dict[int, Sig] = {0: CONST0}
        for nid, node in enumerate(cur.nodes):
            if node.kind == "input":
                memo[nid] = new.input(node.name)
        for nid in cur.maj_nodes(outs):
            ch = []
            for (cid, neg) in cur.nodes[nid].children:
                s = memo[cid]
                ch.append((s[0], s[1] ^ neg))
            memo[nid] = new.maj(*ch)
        new_outs = []
        for (nid, neg) in outs:
            s = memo[nid]
            new_outs.append((s[0], s[1] ^ neg))
        sz = new.size(new_outs)
        cur, outs = new, new_outs
        if sz >= best:
            break
        best = sz
    return cur, outs
