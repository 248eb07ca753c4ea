"""SIMDRAM subarray organization (Fig. 2.2) and row-reference model.

Row groups (identical to Ambit's organization):
  * D-group — regular data rows (operands, outputs, temporaries).
  * C-group — constant rows C0 (all-0) and C1 (all-1), regular decoder.
  * B-group — six compute rows T0–T3 plus two dual-contact-cell rows
    DCC0/DCC1.  DCC rows expose a d-wordline (stored value) and an
    n-wordline (negated value); writing through the n-wordline stores the
    complement (the Ambit NOT mechanism).

The special B-group row decoder can only activate the row combinations that
have μRegisters in Fig. 2.6; those define the legal TRA triples and
multi-target copy registers below.

Row references (hashable tuples):
  ('B', name)            name in T0..T3, DCC0, DCC1, ~DCC0, ~DCC1
  ('C', v)               v in {0, 1}
  ('D', name, a, b)      D-group row holding bit (a*i + b) of object `name`,
                         where i is the enclosing segment's loop variable.
"""
from __future__ import annotations

from typing import Tuple

RowRef = Tuple  # ('B', str) | ('C', int) | ('D', str, int, int)

T_ROWS = ("T0", "T1", "T2", "T3")
DCC_ROWS = ("DCC0", "DCC1")
B_ROWS = T_ROWS + DCC_ROWS

# Legal triple-row activations (μRegisters B12–B15 in Fig. 2.6).
TRA_TRIPLES = (
    ("T0", "T1", "T2"),
    ("T0", "T1", "T3"),
    ("DCC0", "T1", "T3"),
    ("DCC1", "T0", "T2"),
)

# Multi-target copy registers (μRegisters B8–B11): one AAP fills all rows.
MULTI_COPY_SETS = (
    frozenset({"~DCC0", "T0"}),
    frozenset({"~DCC1", "T1"}),
    frozenset({"T2", "T3"}),
    frozenset({"T0", "T3"}),
    frozenset({"T0", "T1", "T2"}),
    frozenset({"T0", "T1", "T3"}),
)

# Typical subarray geometry (Sec. 2.2.1 / 2.5): 1024 rows, 8 kB row buffer.
SUBARRAY_ROWS = 1024
D_GROUP_ROWS = 1006
ROW_BITS = 8 * 1024 * 8          # 65536 bitlines = SIMD lanes per subarray row


def b(name: str) -> RowRef:
    return ("B", name)


def c(v: int) -> RowRef:
    return ("C", int(v))


def d(name: str, a: int = 0, off: int = 0) -> RowRef:
    """D-group row for bit (a*i + off) of object `name` (i = loop var)."""
    return ("D", name, int(a), int(off))


def is_dcc(name: str) -> bool:
    return name in ("DCC0", "DCC1")


def neg_name(name: str) -> str:
    return name[1:] if name.startswith("~") else "~" + name


def base_dcc(name: str) -> str:
    return name[1:] if name.startswith("~") else name
