"""μPrograms shared by the port's SIMDRAM tests on the CPU and on the card
(imports only ``repro_torch``, so the card tests run without JAX)."""
from repro_torch.core.subarray import b, c, d
from repro_torch.core.uprogram import Aap, Ap, Segment, UProgram


def hand_program() -> UProgram:
    """Two trips of a body that reads rows past an input's width, writes
    through ~DCC, copies one row to six (more than one VM instruction
    writes), overwrites an input row and leaves OUT bit 2 unwritten."""
    body = [Aap((b("T0"),), d("A", 0, 3)),              # A[3]: past width
            Aap((b("~DCC0"),), d("A", 1, 0)),
            Aap((b("T1"), b("T2"), b("T3"), d("X", 0, 0), d("X", 0, 1),
                 d("X", 0, 2)), b("DCC0")),
            Ap((b("T0"), b("T1"), b("T2"))),
            Aap((d("OUT", 1, 0),), (b("DCC0"), b("T1"), b("T3"))),
            Aap((d("A", 1, 0),), c(1)),                   # overwrite input
            Aap((d("OUT", 0, 3),), d("A", 0, 1))]
    return UProgram("hand", 2, [Segment(body, trips=2)])


def alias_program() -> UProgram:
    """Outputs that need no MAJ: an input plane stored to two output
    planes, the complement of another through ~DCC0, the constant C1, and
    OUT bit 4 never written; then one real MAJ; then one AAP that writes
    DCC1 twice, through both wordlines: the last write wins."""
    body = [Aap((d("OUT", 0, 0), d("OUT", 0, 2)), d("A", 0, 1)),
            Aap((b("~DCC0"),), d("A", 0, 0)),
            Aap((d("OUT", 0, 1),), b("DCC0")),
            Aap((d("OUT", 0, 3),), c(1)),
            Aap((b("T0"),), d("A", 0, 0)),
            Aap((b("T1"),), d("B", 0, 0)),
            Aap((b("T2"),), c(0)),
            Aap((d("OUT", 0, 5),), (b("T0"), b("T1"), b("T2"))),
            Aap((b("DCC1"), b("~DCC1")), d("B", 0, 0)),
            Aap((d("OUT", 0, 6),), b("DCC1"))]
    return UProgram("alias", 1, [Segment(body)])
