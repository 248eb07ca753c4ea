"""Monte-Carlo reliability model for multi-row activation (Sec. 2.6.5; the
port's copy of the reference's numpy model, which seeds the fault plane's
rates in ``serve/faults.py::simdram_rates``).

The paper runs SPICE over a Rambus DRAM model; we reproduce the *trend* with
an analytic charge-sharing model (clearly a simulation — there is no DRAM
here):

After simultaneously activating N rows of which k cells store '1', the
bitline settles (before sensing) at

    V = (k · Cc·Vdd + Cb · Vdd/2) / (N · Cc + Cb)

with per-cell capacitance drawn from N(Cc0, σ) (manufacturing process
variation) and the sense amp resolving '1' iff V > Vdd/2 (+ offset noise).
A TRA (N=3) has larger worst-case margin than a QRA (N=5): the deciding
charge fraction per cell shrinks as N grows and as the technology node (the
cell-to-bitline capacitance ratio) scales down — QRA fails first, matching
Table 2.3.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

# cell-to-bitline capacitance ratio per node (smaller node → lower ratio)
NODE_RATIO = {45: 0.200, 32: 0.160, 22: 0.120}
SENSE_OFFSET_SIGMA = 0.015  # fraction of Vdd


def activation_failure_rate(n_rows: int, variation: float, node_nm: int,
                            trials: int = 10_000, seed: int = 0,
                            back_to_back: int = 1) -> float:
    """Fraction of majority results mis-sensed under the given variation
    (uniform ±variation on cell capacitance, like the paper's ±x%)."""
    rng = np.random.default_rng(seed + node_nm + n_rows)
    ratio = NODE_RATIO[node_nm]
    fails = 0
    # enumerate worst-case input patterns: k charged cells, majority boundary
    patterns = [k for k in range(n_rows + 1)]
    for _ in range(trials):
        ok = True
        for _ in range(back_to_back):
            k = int(rng.integers(0, n_rows + 1))
            cc = 1.0 + rng.uniform(-variation, variation, size=n_rows)
            cc *= ratio
            cb = 1.0
            charged = cc[:k].sum()
            v = (charged + cb * 0.5) / (cc.sum() + cb)
            off = rng.normal(0.0, SENSE_OFFSET_SIGMA)
            sensed = v > 0.5 + off
            expect = k > n_rows // 2
            if sensed != expect:
                ok = False
        if not ok:
            fails += 1
    _ = patterns
    return fails / trials


def table_2_3(trials: int = 10_000) -> Dict[int, Dict[str, Dict[float, float]]]:
    """Reproduce the structure of Table 2.3 (failure % per node/variation)."""
    out: Dict[int, Dict[str, Dict[float, float]]] = {}
    for node in (45, 32, 22):
        rows = {}
        for label, n_rows, b2b in (("TRA", 3, 1), ("TRAb2b", 3, 2), ("QRA", 5, 1)):
            rates = {}
            for var in (0.0, 0.05, 0.10, 0.20):
                rates[var] = 100.0 * activation_failure_rate(
                    n_rows, var, node, trials=trials, back_to_back=b2b)
            rows[label] = rates
        out[node] = rows
    return out
