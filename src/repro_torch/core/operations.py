"""The SIMDRAM operation library (Sec. 2.3.4): the paper's 16 operations
(plus extras) expressed as cell MIGs, allocated to compute rows, and packed
into μPrograms.

Each op is described by an :class:`OpSpec` with
  * ``build(n, style)`` — μProgram generator.  ``style='simdram'`` uses the
    optimized MAJ/NOT cells (Step 1 output); ``style='ambit'`` expresses the
    same cell in AND/OR/NOT form on an *unoptimized* MIG — the Ambit-
    equivalent baseline the paper compares against in Figs. 2.9/2.10.
  * ``oracle`` — numpy reference semantics (two's complement, width n).

The canonical 16 evaluated operations are in :data:`PAPER_16`.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Callable, Dict, List

from .allocator import allocate_cell
from .bitplane import BitPlaneArray
from .mig import Mig
from .subarray import c, d
from .uprogram import Aap, Segment, UProgram, assert_valid, coalesce


# --------------------------------------------------------------------------
# cell helpers
# --------------------------------------------------------------------------
def _cell(inputs: Dict[str, tuple], build: Callable, style: str) -> List:
    """Build a cell body.  For the optimized style, cost the candidate XOR
    decompositions through the allocator and keep the cheapest (greedy
    exploration, Step 1+2 interplay)."""
    if style != "simdram":
        m = Mig(opt=False)
        outs = build(m)
        ops, _ = allocate_cell(m, outs, inputs)
        return coalesce(ops)
    best = None
    for mode in ("aoi", "maj"):
        m = Mig(opt=True)
        m.xor_mode = mode
        outs = build(m)
        ops, _ = allocate_cell(m, outs, inputs)
        ops = coalesce(ops)
        if best is None or len(ops) < len(best):
            best = ops
    return best


def _fa(m: Mig, x, y, z, style: str):
    """Full adder cell: returns (sum, carry_out)."""
    if style == "simdram":
        cout = m.maj(x, y, z)
        s = m.maj(Mig.not_(cout), z, m.maj(x, y, Mig.not_(z)))
        return s, cout
    cout = m.or_(m.or_(m.and_(x, y), m.and_(x, z)), m.and_(y, z))
    s = m.xor_(m.xor_(x, y), z)
    return s, cout


def _gt_step(m: Mig, a, b, g, style: str):
    """g' = (a AND NOT b) OR ((a XNOR b) AND g)  ==  MAJ(a, ¬b, g)."""
    if style == "simdram":
        return m.maj(a, Mig.not_(b), g)
    return m.or_(m.and_(a, Mig.not_(b)),
                 m.and_(Mig.not_(m.xor_(a, b)), g))


def _seg(body, trips=1, comment=""):
    return Segment(list(body), trips, comment)


# --------------------------------------------------------------------------
# μProgram builders
# --------------------------------------------------------------------------
def build_add(n, style="simdram", sub=False):
    def cell(m):
        a = m.input("a")
        b = m.input("b")
        cin = m.input("cin")
        s, cout = _fa(m, a, Mig.not_(b) if sub else b, cin, style)
        return {d("OUT", 1, 0): s, d("__c"): cout}

    segs = [_seg([Aap((d("__c"),), c(1 if sub else 0))], comment="init carry"),
            _seg(_cell({"a": d("A", 1, 0), "b": d("B", 1, 0),
                        "cin": d("__c")}, cell, style),
                 trips=n, comment="full adder")]
    return UProgram("sub" if sub else "add", n, segs)


def _gt_segments(n, style, a_name, b_name, g_row, signed):
    """Emit segments computing (a > b) into g_row (bit mask)."""
    def cell(m):
        a = m.input("a")
        b = m.input("b")
        g = m.input("g")
        return {g_row: _gt_step(m, a, b, g, style)}

    segs = [_seg([Aap((g_row,), c(0))], comment="g=0"),
            _seg(_cell({"a": d(a_name, 1, 0), "b": d(b_name, 1, 0),
                        "g": g_row}, cell, style),
                 trips=n, comment="compare LSB->MSB")]
    if signed:
        def fix(m):
            sa = m.input("sa")
            sb = m.input("sb")
            g = m.input("g")
            x = m.xor_(sa, sb)
            return {g_row: m.mux(x, Mig.not_(sa), g)}

        segs.append(_seg(_cell({"sa": d(a_name, 0, n - 1),
                                "sb": d(b_name, 0, n - 1),
                                "g": g_row}, fix, style),
                         comment="sign fix"))
    return segs


def build_gt(n, style="simdram", signed=True):
    segs = _gt_segments(n, style, "A", "B", d("__g"), signed)
    segs.append(_seg([Aap((d("OUT", 0, 0),), d("__g"))]))
    return UProgram("gt", n, segs)


def build_ge(n, style="simdram", signed=True):
    # a >= b  ==  NOT (b > a)
    segs = _gt_segments(n, style, "B", "A", d("__g"), signed)

    def neg(m):
        g = m.input("g")
        return {d("OUT", 0, 0): Mig.not_(g)}

    segs.append(_seg(_cell({"g": d("__g")}, neg, style)))
    return UProgram("ge", n, segs)


def build_eq(n, style="simdram", neq=False):
    def cell(m):
        a = m.input("a")
        b = m.input("b")
        dd = m.input("d")
        return {d("__d"): m.or_(dd, m.xor_(a, b))}

    segs = [_seg([Aap((d("__d"),), c(0))]),
            _seg(_cell({"a": d("A", 1, 0), "b": d("B", 1, 0),
                        "d": d("__d")}, cell, style), trips=n)]
    if neq:
        segs.append(_seg([Aap((d("OUT", 0, 0),), d("__d"))]))
    else:
        def neg(m):
            dd = m.input("d")
            return {d("OUT", 0, 0): Mig.not_(dd)}
        segs.append(_seg(_cell({"d": d("__d")}, neg, style)))
    return UProgram("neq" if neq else "eq", n, segs)


def build_minmax(n, style="simdram", is_min=False):
    segs = _gt_segments(n, style, "A", "B", d("__g"), signed=True)

    def sel(m):
        g = m.input("g")
        a = m.input("a")
        b = m.input("b")
        t, f = (b, a) if is_min else (a, b)
        return {d("OUT", 1, 0): m.mux(g, t, f)}

    segs.append(_seg(_cell({"g": d("__g"), "a": d("A", 1, 0),
                            "b": d("B", 1, 0)}, sel, style), trips=n,
                     comment="select"))
    return UProgram("min" if is_min else "max", n, segs)


def build_relu(n, style="simdram"):
    def cell(m):
        a = m.input("a")
        s = m.input("s")
        return {d("OUT", 1, 0): m.and_(a, Mig.not_(s))}

    return UProgram("relu", n, [
        _seg(_cell({"a": d("A", 1, 0), "s": d("A", 0, n - 1)}, cell, style),
             trips=n)])


def build_abs(n, style="simdram"):
    def cell(m):
        a = m.input("a")
        s = m.input("s")
        cin = m.input("cin")
        x = m.xor_(a, s)
        out = m.xor_(x, cin)
        cout = m.and_(x, cin)
        return {d("OUT", 1, 0): out, d("__c"): cout}

    return UProgram("abs", n, [
        _seg([Aap((d("__c"),), d("A", 0, n - 1))], comment="carry=sign"),
        _seg(_cell({"a": d("A", 1, 0), "s": d("A", 0, n - 1),
                    "cin": d("__c")}, cell, style), trips=n)])


def build_if_else(n, style="simdram"):
    def cell(m):
        s = m.input("s")
        a = m.input("a")
        b = m.input("b")
        return {d("OUT", 1, 0): m.mux(s, a, b)}

    return UProgram("if_else", n, [
        _seg([Aap((d("__s"),), d("SEL", 0, 0))]),
        _seg(_cell({"s": d("__s"), "a": d("A", 1, 0), "b": d("B", 1, 0)},
                   cell, style), trips=n)])


def build_reduction(n, style="simdram", kind="and"):
    def cell(m):
        acc = m.input("acc")
        a = m.input("a")
        if kind == "and":
            nxt = m.and_(acc, a)
        elif kind == "or":
            nxt = m.or_(acc, a)
        else:
            nxt = m.xor_(acc, a)
        return {d("__acc"): nxt}

    init = 1 if kind == "and" else 0
    return UProgram(f"{kind}_red", n, [
        _seg([Aap((d("__acc"),), c(init))]),
        _seg(_cell({"acc": d("__acc"), "a": d("A", 1, 0)}, cell, style),
             trips=n),
        _seg([Aap((d("OUT", 0, 0),), d("__acc"))])])


def build_bitcount(n, style="simdram"):
    m_bits = n.bit_length()

    def inc(m):
        acc = m.input("acc")
        cb = m.input("cb")
        return {d("__acc", 1, 0): m.xor_(acc, cb),
                d("__cb"): m.and_(acc, cb)}

    segs = [_seg([Aap((d("__acc", 1, 0),), c(0))], trips=m_bits,
                 comment="acc=0")]
    inc_body = _cell({"acc": d("__acc", 1, 0), "cb": d("__cb")}, inc, style)
    for i in range(n):
        segs.append(_seg([Aap((d("__cb"),), d("A", 0, i))]))
        segs.append(_seg(inc_body, trips=m_bits, comment=f"acc += A[{i}]"))
    segs.append(_seg([Aap((d("OUT", 1, 0),), d("__acc", 1, 0))], trips=m_bits))
    return UProgram("bitcount", n, segs)


def build_mul(n, style="simdram"):
    segs = [_seg([Aap((d("OUT", 1, 0),), c(0))], trips=n, comment="acc=0")]
    for j in range(n):
        def cell_j(m, j=j):
            a = m.input("a")
            bj = m.input("bj")
            acc = m.input("acc")
            cin = m.input("cin")
            p = m.and_(a, bj)
            s, cout = _fa(m, p, acc, cin, style)
            return {d("OUT", 1, j): s, d("__c"): cout}

        body = _cell({"a": d("A", 1, 0), "bj": d("__bj"),
                      "acc": d("OUT", 1, j), "cin": d("__c")}, cell_j, style)
        segs.append(_seg([Aap((d("__bj"),), d("B", 0, j)),
                          Aap((d("__c"),), c(0))], comment=f"pp {j}"))
        segs.append(_seg(body, trips=n - j, comment=f"acc += (A & b{j}) << {j}"))
    return UProgram("mul", n, segs)


def build_div(n, style="simdram"):
    """Restoring division (unsigned): OUT = A // B."""
    segs = [_seg([Aap((d("__r", 1, 0),), c(0))], trips=n, comment="rem=0")]

    def cmp_cell(m):
        bb = m.input("b")
        r = m.input("r")
        g = m.input("g")
        return {d("__t"): _gt_step(m, bb, r, g, style)}

    def q_cell(m):
        g = m.input("g")
        return {d("OUT", 0, None): Mig.not_(g), d("__q"): Mig.not_(g)}

    def sub_cell(m):
        r = m.input("r")
        bb = m.input("b")
        cin = m.input("cin")
        s, cout = _fa(m, r, Mig.not_(bb), cin, style)
        return {d("__df", 1, 0): s, d("__c"): cout}

    def mux_cell(m):
        q = m.input("q")
        df = m.input("df")
        r = m.input("r")
        return {d("__r", 1, 0): m.mux(q, df, r)}

    cmp_body = _cell({"b": d("B", 1, 0), "r": d("__r", 1, 0),
                      "g": d("__t")}, cmp_cell, style)
    sub_body = _cell({"r": d("__r", 1, 0), "b": d("B", 1, 0),
                      "cin": d("__c")}, sub_cell, style)
    mux_body = _cell({"q": d("__q"), "df": d("__df", 1, 0),
                      "r": d("__r", 1, 0)}, mux_cell, style)
    for k in range(n - 1, -1, -1):
        if n > 1:
            segs.append(_seg([Aap((d("__r", -1, n - 1),), d("__r", -1, n - 2))],
                             trips=n - 1, comment="rem <<= 1"))
        segs.append(_seg([Aap((d("__r", 0, 0),), d("A", 0, k))]))
        segs.append(_seg([Aap((d("__t"),), c(0))]))
        segs.append(_seg(cmp_body, trips=n, comment="B > rem ?"))

        def q_cell_k(m, k=k):
            g = m.input("g")
            return {d("OUT", 0, k): Mig.not_(g), d("__q"): Mig.not_(g)}

        segs.append(_seg(_cell({"g": d("__t")}, q_cell_k, style)))
        segs.append(_seg([Aap((d("__c"),), c(1))]))
        segs.append(_seg(sub_body, trips=n, comment="diff = rem - B"))
        segs.append(_seg(mux_body, trips=n, comment="rem = q ? diff : rem"))
    return UProgram("div", n, segs)


# --------------------------------------------------------------------------
# oracles (host-side numpy, two's-complement width-n semantics)
# --------------------------------------------------------------------------
import numpy as np


def _mask(v, n):
    v = np.asarray(v, np.int64).astype(np.uint64)
    if n < 64:
        v = v & np.uint64((1 << n) - 1)
    return v


def _sgn(v, n):
    m = _mask(v, n).astype(np.int64)
    if n < 64:
        m = np.where(m >> (n - 1) & 1, m - (np.int64(1) << np.int64(n)), m)
    return m


def _popcount(v, n):
    u = _mask(v, n)
    cnt = np.zeros_like(u)
    for i in range(n):
        cnt = cnt + ((u >> np.uint64(i)) & np.uint64(1))
    return cnt


ORACLES = {
    "add": lambda a, b, n: _mask(np.asarray(a, np.int64) + b, n),
    "sub": lambda a, b, n: _mask(np.asarray(a, np.int64) - b, n),
    "mul": lambda a, b, n: _mask((_mask(a, n) * _mask(b, n)).astype(np.int64), n),
    "div": lambda a, b, n: _mask(a, n) // np.maximum(_mask(b, n), 1),
    "gt": lambda a, b, n: (_sgn(a, n) > _sgn(b, n)).astype(np.uint64),
    "ge": lambda a, b, n: (_sgn(a, n) >= _sgn(b, n)).astype(np.uint64),
    "eq": lambda a, b, n: (_mask(a, n) == _mask(b, n)).astype(np.uint64),
    "neq": lambda a, b, n: (_mask(a, n) != _mask(b, n)).astype(np.uint64),
    "max": lambda a, b, n: _mask(np.where(_sgn(a, n) > _sgn(b, n), a, b), n),
    "min": lambda a, b, n: _mask(np.where(_sgn(a, n) > _sgn(b, n), b, a), n),
    "relu": lambda a, n: np.where(_sgn(a, n) < 0, np.uint64(0), _mask(a, n)),
    "abs": lambda a, n: _mask(np.abs(_sgn(a, n)), n),
    "bitcount": lambda a, n: _popcount(a, n),
    "and_red": lambda a, n: (_mask(a, n) == _mask(-1, n)).astype(np.uint64),
    "or_red": lambda a, n: (_mask(a, n) != 0).astype(np.uint64),
    "xor_red": lambda a, n: (_popcount(a, n) & np.uint64(1)),
    "if_else": lambda s, a, b, n: _mask(np.where((np.asarray(s) & 1) == 1, a, b), n),
}


# --------------------------------------------------------------------------
# op registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    n_inputs: int
    input_names: tuple
    build: Callable                      # (n, style) -> UProgram
    out_bits: Callable                   # n -> result width
    scaling: str                         # latency class vs n


def _spec(name, n_inputs, build, out_bits, scaling):
    names = {1: ("A",), 2: ("A", "B"), 3: ("SEL", "A", "B")}[n_inputs]
    return OpSpec(name, n_inputs, names, build, out_bits, scaling)


OPS: Dict[str, OpSpec] = {s.name: s for s in [
    _spec("add", 2, partial(build_add, sub=False), lambda n: n, "linear"),
    _spec("sub", 2, partial(build_add, sub=True), lambda n: n, "linear"),
    _spec("mul", 2, build_mul, lambda n: n, "quadratic"),
    _spec("div", 2, build_div, lambda n: n, "quadratic"),
    _spec("gt", 2, build_gt, lambda n: 1, "linear"),
    _spec("ge", 2, build_ge, lambda n: 1, "linear"),
    _spec("eq", 2, partial(build_eq, neq=False), lambda n: 1, "linear"),
    _spec("neq", 2, partial(build_eq, neq=True), lambda n: 1, "linear"),
    _spec("max", 2, partial(build_minmax, is_min=False), lambda n: n, "linear"),
    _spec("min", 2, partial(build_minmax, is_min=True), lambda n: n, "linear"),
    _spec("relu", 1, build_relu, lambda n: n, "linear"),
    _spec("abs", 1, build_abs, lambda n: n, "linear"),
    _spec("bitcount", 1, build_bitcount, lambda n: n.bit_length(), "nlogn"),
    _spec("and_red", 1, partial(build_reduction, kind="and"), lambda n: 1, "linear"),
    _spec("or_red", 1, partial(build_reduction, kind="or"), lambda n: 1, "linear"),
    _spec("xor_red", 1, partial(build_reduction, kind="xor"), lambda n: 1, "linear"),
    _spec("if_else", 3, build_if_else, lambda n: n, "linear"),
]}

# The paper's canonical 16 evaluated operations (Sec. 2.3.4).
PAPER_16 = ("and_red", "or_red", "xor_red", "eq", "gt", "ge", "max", "min",
            "add", "sub", "mul", "div", "abs", "if_else", "bitcount", "relu")


@lru_cache(maxsize=None)
def get_uprogram(name: str, n: int, style: str = "simdram") -> UProgram:
    prog = OPS[name].build(n, style=style)
    assert_valid(prog)
    return prog


def apply_op(name: str, *inputs: BitPlaneArray, style: str = "simdram"
             ) -> BitPlaneArray:
    """Run a SIMDRAM operation on vertically-laid-out inputs of one width:
    through the μProgram-VM kernel for planes on the card, through
    :func:`~repro_torch.core.engine.execute` for planes on the CPU."""
    from ..kernels.simdram_vm.ops import simdram_op
    for x in inputs:
        assert x.n_bits == inputs[0].n_bits
        assert x.n_words == inputs[0].n_words
    return simdram_op(name, *inputs, style=style)
