"""The port's SIMDRAM pipeline on the CPU against the reference package,
bit-exact, on the same numpy-seeded inputs:

  * Steps 1–2: every op's μProgram, flattened, equals the reference's
    (both styles), and so do the quickstart op's MIG and allocated μOps;
  * Step 3: ``apply_op`` (``execute`` on CPU tensors) against the
    reference's ``apply_op`` and the numpy ``ORACLES``; ``simdram_op``
    against the reference's Pallas VM kernel in interpret mode;
  * the cost model and the control unit's accounting;
  * the μProgram-VM kernel's instruction streams: numpy interpreters of
    the stage-1 μOp stream (``lower``) and of the compiled stream the CUDA
    kernel runs (``compile_lowered``, ``kernels/simdram_vm/lower.py``)
    against ``execute``, and the compiled stream's structure (fewer MAJ
    than μOps, fewer slots than stage 1, every slot written before it is
    read, every output plane stored once).  The kernel itself is held
    against ``execute`` on the card (``tests/test_torch_cuda.py``,
    ``chip_smoke.py``)."""
from dataclasses import asdict
from functools import partial

import numpy as np
import pytest
import torch

from repro import core as jc
from repro.core.allocator import allocate_cell as j_allocate_cell
from repro.core.subarray import ROW_BITS
from repro.core.subarray import d as j_d
from repro.core.uprogram import Segment as JSegment
from repro.core.uprogram import UProgram as JUProgram
from repro.core.uprogram import coalesce as j_coalesce
from repro.kernels import simdram_op as j_simdram_op
from repro_torch import core as tc
from repro_torch.core.uprogram import Aap, Segment, UProgram
from repro_torch.examples import quickstart
from repro_torch.kernels.simdram_vm import (compile_lowered, lower,
                                           run_uprogram, simdram_op)
from repro_torch.kernels.simdram_vm.lower import (AHEAD, LOAD, MAJ, STORE,
                                                 WAIT)
from repro_torch.kernels.simdram_vm.ops import launch_shape

from _torch_simdram_cases import alias_program, hand_program

CPU = torch.device("cpu")
STYLES = ("simdram", "ambit")
#: the grid of tests/test_kernels.py::test_vm_kernel_matches_oracle
VM_OPS = ("add", "gt", "relu", "bitcount", "if_else")


def _norm(uop):
    """A μOp of either package as plain tuples."""
    if type(uop).__name__ == "Ap":
        return ("AP", uop.triple)
    return ("AAP", uop.dsts, uop.src, uop.is_maj_src)


def _inputs(op, n, size, seed):
    spec = tc.OPS[op]
    rng = np.random.default_rng(seed)
    lo = -(1 << (n - 1))
    ins = [rng.integers(lo, -lo, size) for _ in range(spec.n_inputs)]
    if spec.n_inputs == 3:
        ins[0] = rng.integers(0, 2, size)            # predicate
    if spec.scaling == "quadratic":                  # as test_operations
        ins = [rng.integers(0, 1 << n, size), rng.integers(1, 1 << n, size)]
    return ins


def _masked(values, bits):
    m = np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(2**64 - 1)
    return np.asarray(values).astype(np.uint64) & m


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("op", list(tc.OPS))
def test_uprogram_stream_matches_reference(op, n, style):
    got = tc.get_uprogram(op, n, style)
    ref = jc.get_uprogram(op, n, style)
    assert (got.name, got.n_bits) == (ref.name, ref.n_bits)
    assert [(_norm(u), i) for u, i in got.flatten()] == \
        [(_norm(u), i) for u, i in ref.flatten()]
    assert got.command_count() == ref.command_count()
    assert got.listing() == ref.listing()


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("op", list(tc.OPS))
def test_apply_op_matches_reference_and_oracle(op, style):
    n = 8
    ins = _inputs(op, n, 33, seed=len(op) * 7 + n)
    ref = jc.apply_op(op, *[jc.pack_np(x, n) for x in ins], style=style)
    got = tc.apply_op(op, *[tc.pack_np(x, n, device=CPU) for x in ins],
                      style=style)
    assert got.planes.dtype == torch.int32
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.planes))
    assert (got.n_elems, got.signed) == (ref.n_elems, ref.signed)
    np.testing.assert_array_equal(
        _masked(tc.unpack_np(got), got.n_bits),
        _masked(tc.ORACLES[op](*ins, n), got.n_bits))


@pytest.mark.parametrize("op,n", [("add", 16), ("add", 32), ("add", 64),
                                  ("gt", 64), ("mul", 16)])
def test_apply_op_matches_reference_at_other_widths(op, n):
    ins = _inputs(op, n, 33, seed=n)
    ref = jc.apply_op(op, *[jc.pack_np(x, n) for x in ins])
    got = tc.apply_op(op, *[tc.pack_np(x, n, device=CPU) for x in ins])
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.planes))
    np.testing.assert_array_equal(
        _masked(tc.unpack_np(got), got.n_bits),
        _masked(tc.ORACLES[op](*ins, n), got.n_bits))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("op", VM_OPS)
def test_simdram_op_matches_reference_kernel(op, n):
    ins = _inputs(op, n, 150, seed=42)
    ref = j_simdram_op(op, *[jc.pack_np(x, n) for x in ins], block_words=2)
    got = simdram_op(op, *[tc.pack_np(x, n, device=CPU) for x in ins],
                     block_words=2)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.planes))


def test_simdram_op_block_words_do_not_matter():
    rng = np.random.default_rng(7)
    a, b = (tc.pack_np(rng.integers(-128, 128, 500), 8, device=CPU)
            for _ in range(2))
    o1 = simdram_op("add", a, b, block_words=1)
    o2 = simdram_op("add", a, b, block_words=16)
    assert torch.equal(o1.planes, o2.planes)


def _interpret(lp, planes, n_words):
    """Numpy model of the CUDA VM kernel: the row file, the slot loads,
    and per instruction MAJ(s0, s1, s2) written to d0..d3 in order."""
    ones = np.uint32(0xFFFFFFFF)
    rf = np.zeros((lp.n_slots, n_words), np.uint32)
    for slot, code in enumerate(lp.init):
        if code >= 0:
            rf[slot] = planes[code >> 16][code & 0xFFFF]
    words = lp.instrs.view(np.uint32)
    fields = np.stack([words & 0xFFFF, words >> 16], axis=-1).reshape(-1, 8)
    for row in fields:
        a, b, c = (rf[f >> 1] ^ (ones * (f & 1)) for f in row[:3])
        v = (a & b) | (a & c) | (b & c)
        for f in row[3:7]:
            rf[f >> 1] = v ^ (ones * (f & 1))
    return rf[lp.out_slots]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("op,n", [(op, n) for op in VM_OPS for n in (8, 16)]
                         + [("mul", 8), ("div", 8)])
def test_lowered_stream_matches_execute(op, n, style):
    spec = tc.OPS[op]
    prog = tc.get_uprogram(op, n, style)
    ins = _inputs(op, n, 150, seed=n + len(op))
    bps = [tc.pack_np(x, n, device=CPU) for x in ins]
    lp = lower(prog, spec.input_names, [n] * spec.n_inputs, spec.out_bits(n))
    got = _interpret(lp, [bp.to_numpy() for bp in bps], bps[0].n_words)
    ref = tc.execute(prog, dict(zip(spec.input_names,
                                    [bp.planes for bp in bps])),
                     bps[0].n_words, out_bits=spec.out_bits(n))
    np.testing.assert_array_equal(got, ref.numpy().view(np.uint32))


def test_lowering_corner_cases_match_execute():
    prog = hand_program()
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 1 << 32, (2, 3), dtype=np.uint64)
    planes = planes.astype(np.uint32)
    lp = lower(prog, ["A"], [2], 4)
    # the six-row copy takes two instructions on each of the two trips
    assert lp.n_instr == len(prog.flatten()) + 2
    got = _interpret(lp, [planes], 3)
    tplanes = torch.from_numpy(planes.view(np.int32).copy())
    ref = tc.execute(prog, {"A": tplanes}, 3, out_bits=4)
    np.testing.assert_array_equal(got, ref.numpy().view(np.uint32))
    assert not got[2].any()                   # OUT[2] never written
    np.testing.assert_array_equal(tplanes.numpy().view(np.uint32), planes)
    assert torch.equal(run_uprogram(prog, [tplanes], ["A"], 4), ref)


def test_lowering_refuses_writes_to_constant_rows():
    prog = UProgram("bad", 1, [Segment([Aap((("C", 1),), ("B", "T0"))])])
    with pytest.raises(ValueError, match="constant"):
        lower(prog, [], [], 1)
    with pytest.raises(ValueError, match="constant"):
        tc.execute(prog, {}, 1)


def _fields(cp):
    words = cp.code.view(np.uint32)
    return np.stack([words & 0xFFFF, words >> 16], axis=-1).reshape(-1, 4)


def _interpret_compiled(cp, planes, n_words, seed=0):
    """Numpy model of the CUDA VM kernel on the compiled stream: slot 0
    the zero row, every other slot and the output starting as garbage;
    MAJ, LOAD, WAIT and STORE as ``csrc/simdram_vm.cu`` documents them (a
    LOAD lands at once here; ``_check_structure`` checks the WAITs)."""
    ones = np.uint32(0xFFFFFFFF)
    rng = np.random.default_rng(seed)
    rf = rng.integers(0, 1 << 32, (cp.n_slots, n_words),
                      dtype=np.uint64).astype(np.uint32)
    rf[0] = 0
    out = rng.integers(0, 1 << 32, (cp.out_bits, n_words),
                       dtype=np.uint64).astype(np.uint32)
    for f0, f1, f2, f3 in _fields(cp).tolist():
        kind, dst = f3 & 3, f3 >> 2
        if kind == MAJ:
            a, b, c = (rf[f >> 1] ^ (ones * (f & 1)) for f in (f0, f1, f2))
            rf[dst] = (a & b) | (a & c) | (b & c)
        elif kind == LOAD:
            rf[dst] = planes[f0][f1]
        elif kind == STORE:
            out[f1] = rf[f0 >> 1] ^ (ones * (f0 & 1))
    return out


def _check_structure(cp, n_uops, stage1_slots):
    """Fewer MAJ than μOps and no more slots than stage 1; every slot is
    written before it is read (slot 0, the zero row, never written), and
    a slot whose LOAD may be in flight only after a WAIT; only a MAJ's
    first operand complemented; every output plane stored exactly once;
    the stream padded with WAITs as the kernel's fetch of it needs."""
    assert cp.n_maj <= n_uops
    assert cp.n_slots <= stage1_slots
    fields = _fields(cp).tolist()
    assert cp.n_instr % AHEAD == 0
    assert all(f[3] == WAIT for f in fields[cp.n_instr:])
    assert len(fields) == cp.n_instr + AHEAD
    written, stored, in_flight = {0}, [], set()
    for f0, f1, f2, f3 in fields:
        kind, dst = f3 & 3, f3 >> 2
        if kind == WAIT:
            in_flight.clear()
            continue
        reads = {MAJ: (f0, f1, f2), LOAD: (), STORE: (f0,)}[kind]
        assert {f >> 1 for f in reads} <= written - in_flight
        if kind == STORE:
            stored.append(f1)
            continue
        assert 0 < dst < cp.n_slots
        written.add(dst)
        if kind == MAJ:
            assert not (f1 & 1 or f2 & 1)
        else:
            in_flight.add(dst)
    assert sorted(stored) == list(range(cp.out_bits))
    assert cp.n_maj == sum(f[3] & 3 == MAJ for f in fields)
    assert cp.n_loads == sum(f[3] & 3 == LOAD for f in fields)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("op,n", [(op, n) for op in tc.PAPER_16
                                  for n in (8, 16)]
                         + [("mul", 8), ("div", 8)])
def test_compiled_stream_matches_execute(op, n, style):
    spec = tc.OPS[op]
    prog = tc.get_uprogram(op, n, style)
    ins = _inputs(op, n, 150, seed=n + len(op))
    bps = [tc.pack_np(x, n, device=CPU) for x in ins]
    lp = lower(prog, spec.input_names, [n] * spec.n_inputs, spec.out_bits(n))
    cp = compile_lowered(lp)
    _check_structure(cp, len(prog.flatten()), lp.n_slots)
    got = _interpret_compiled(cp, [bp.to_numpy() for bp in bps],
                              bps[0].n_words)
    ref = tc.execute(prog, dict(zip(spec.input_names,
                                    [bp.planes for bp in bps])),
                     bps[0].n_words, out_bits=spec.out_bits(n))
    np.testing.assert_array_equal(got, ref.numpy().view(np.uint32))


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("op", list(tc.PAPER_16))
def test_compiled_stream_at_32_bits_is_smaller(op, style):
    spec = tc.OPS[op]
    prog = tc.get_uprogram(op, 32, style)
    lp = lower(prog, spec.input_names, [32] * spec.n_inputs,
               spec.out_bits(32))
    cp = compile_lowered(lp)
    _check_structure(cp, len(prog.flatten()), lp.n_slots)
    assert cp.n_maj < len(prog.flatten())


@pytest.mark.parametrize("case,widths,out_bits", [
    (hand_program, {"A": 2}, 4), (alias_program, {"A": 2, "B": 1}, 7)])
def test_compiled_corner_cases_match_execute(case, widths, out_bits):
    prog = case()
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 1 << 32, (w, 3), dtype=np.uint64).astype(
        np.uint32) for w in widths.values()]
    lp = lower(prog, list(widths), list(widths.values()), out_bits)
    cp = compile_lowered(lp)
    _check_structure(cp, len(prog.flatten()), lp.n_slots)
    got = _interpret_compiled(cp, planes, 3)
    tplanes = [torch.from_numpy(p.view(np.int32).copy()) for p in planes]
    ref = tc.execute(prog, dict(zip(widths, tplanes)), 3, out_bits=out_bits)
    np.testing.assert_array_equal(got, ref.numpy().view(np.uint32))
    for tp, p in zip(tplanes, planes):          # inputs never written
        np.testing.assert_array_equal(tp.numpy().view(np.uint32), p)


def test_compiled_stream_of_aliased_outputs():
    cp = compile_lowered(lower(alias_program(), ["A", "B"], [2, 1], 7))
    kinds = [f[3] & 3 for f in _fields(cp)[:cp.n_instr]]
    # A[0] and A[1] and B[0] loaded once each, one MAJ (A[0] & B[0]), seven
    # stores: A[1] twice, ~A[0], the constants C1 and C0, the MAJ, ~B[0]
    assert (kinds.count(LOAD), kinds.count(MAJ), kinds.count(STORE)) == \
        (3, 1, 7)
    out = _interpret_compiled(cp, [np.array([[5], [6]], np.uint32),
                                   np.array([[3]], np.uint32)], 1)
    assert out[:, 0].tolist() == [6, 0xFFFFFFFA, 6, 0xFFFFFFFF, 0, 1,
                                  0xFFFFFFFC]


def test_launch_shape_fills_the_card_then_widens_threads():
    # the main path (2^20 elements, 32,768 words): one word per thread
    assert launch_shape(5, 1 << 15, 128, 132) == (128, 1)
    # 2^26 elements: four words per thread, the grid still 2 blocks/SM
    assert launch_shape(5, 1 << 21, 128, 132) == (128, 4)
    assert launch_shape(5, 1 << 21, 512, 132) == (512, 2)
    # div at 32 bits: the row file caps the words per thread
    assert launch_shape(99, 1 << 21, 128, 132) == (128, 2)
    assert launch_shape(99, 1 << 21, 1024, 132) == (576, 1)
    assert launch_shape(5, 1, 1, 132) == (1, 1)
    # words per thread divide the word count and the planes' alignment
    assert launch_shape(5, (1 << 21) - 2, 128, 132) == (128, 2)
    assert launch_shape(5, 1 << 21, 128, 132, align_words=2) == (128, 2)


@pytest.mark.parametrize("style", STYLES)
def test_costs_match_reference(style):
    for op in tc.OPS:
        for n in (8, 32):
            assert asdict(tc.op_cost(op, n, style)) == \
                asdict(jc.op_cost(op, n, style))
    assert tc.compare_to_ambit(list(tc.PAPER_16), 32) == \
        jc.compare_to_ambit(list(jc.PAPER_16), 32)
    for seq, width in (([("add", 3), ("gt", 1), ("if_else", 2)], 8),
                       ([("ge", 1), ("if_else", 1), ("add", 4),
                         ("mul", 2)], 32)):
        for banks in (1, 16):
            assert tc.kernel_cost(seq, width, 1 << 20, banks, style) == \
                jc.kernel_cost(seq, width, 1 << 20, banks, style)


def test_control_unit_stats_match_reference():
    stats = []
    for pkg, pack in ((jc, jc.pack_np), (tc, partial(tc.pack_np, device=CPU))):
        cu = pkg.ControlUnit(scratchpad_entries=2)
        for op in ("add", "sub", "gt"):
            cu.register(pkg.get_uprogram(op, 8))
        big = pack(np.zeros(ROW_BITS * 2 + 5, np.int64), 8)
        for op in ("add", "add", "sub", "gt", "add"):
            cu.enqueue(pkg.BbopRequest(op, [big, big], 8))
        stats.append((cu.drain(), dict(cu.stats)))
    assert stats[0] == stats[1]
    assert stats[1][0][0]["trips"] == 3


def test_quickstart_op_matches_reference():
    out = quickstart.main(device="cpu")
    g = jc.Aoig()
    a, b, m = g.input("a"), g.input("b"), g.input("m")
    mig, outs = jc.aoig_to_mig(g, [g.and_(g.xor_(a, b), m)], optimize=True)
    naive, outs_n = jc.aoig_to_mig(g, [g.and_(g.xor_(a, b), m)],
                                   optimize=False)
    assert (out["mig_size"], out["mig_depth"], out["naive_size"]) == \
        (mig.size(outs), mig.depth(outs), naive.size(outs_n))
    uops, n_tmp = j_allocate_cell(
        mig, {j_d("OUT", 1, 0): outs[0]},
        {"a": j_d("A", 1, 0), "b": j_d("B", 1, 0), "m": j_d("M", 1, 0)})
    assert [_norm(u) for u in out["uops"]] == [_norm(u) for u in uops]
    assert out["n_tmp"] == n_tmp
    A, B, M = out["inputs"]
    np.testing.assert_array_equal(out["xor_mask"], (A ^ B) & M)
    # the reference's program executes to the same planes
    jprog = JUProgram("xor_mask", 8, [JSegment(j_coalesce(uops), trips=8)])
    assert [(_norm(u), i) for u, i in out["program"].flatten()] == \
        [(_norm(u), i) for u, i in jprog.flatten()]
    planes = {k: jc.pack_np(v, 8).planes for k, v in
              {"A": A, "B": B, "M": M}.items()}
    ref = np.asarray(jc.execute(jprog, planes, 1, out_bits=8))
    np.testing.assert_array_equal(
        tc.pack_np(out["xor_mask"], 8, signed=False, device=CPU).to_numpy(),
        ref)
