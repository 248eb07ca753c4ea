"""Sealed block images, the tracer hook and the fault hook of the port's
allocator (``repro_torch/core/vbi/blocks.py``) against the JAX package's:

  * a port ``BlockImage`` (export and snapshot) carries the reference's
    arrays and CRC-32 for the same state, ring frames and recurrent rows
    included; ``verify`` fails on a flipped payload bit and on a falsified
    charge; a corrupt image raises ``ImageIntegrityError`` before anything
    changes; an image imports into a pool of another size (device state
    equal to the reference's there); a re-delivered image is deduplicated;
    ``snapshot_image`` leaves the block resident;
  * for one op sequence (alloc, reserve, commit, unreserve, retain,
    map_shared, cow_break, release, swap_out, swap_in, export, import, a
    deduplicated import, snapshot, drop, free), the port's events, recorded
    by the reference's ``TraceRecorder``, equal the reference allocator's
    field for field, and the reference's ``check_trace`` accepts them;
  * a reference ``FaultPlan`` forced at ``alloc``, ``swap_out`` and
    ``swap_in`` raises before the op and leaves the port's allocator, its
    tier and its device state exactly as they were."""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vbi import kvcache as jk
from repro.core.vbi.blocks import PagePool as JPagePool
from repro.core.vbi.blocks import VBIAllocator as JAlloc
from repro.serve.faults import FaultPlan, TransientFault, install_faults
from repro.serve.telemetry import TraceRecorder, check_trace
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.blocks import (BlockImage, ImageIntegrityError,
                                         PagePool, VBIAllocator)

FIELDS = [f.name for f in dataclasses.fields(tk.PagedServeState)]
PAYLOAD = ("k_pages", "v_pages", "k_ring", "v_ring", "rg_h", "rg_conv")
#: a hetero pool: one full layer, two ring layers (2 frames), one RG-LRU
GEO = dict(n_layers=1, n_pages=33, page_size=2, n_kv=1, head_dim=2,
           max_seqs=4, max_pages_per_seq=8, ring_layers=2, ring_pages=2,
           rg_layers=1, rnn_width=4)


class Pair:
    """The same pool and allocator on both sides, the payload seeded
    alike, driven by the same calls."""

    def __init__(self, seed=0, swap=32, **geo):
        geo = dict(GEO, **geo)
        self.jpool = JPagePool(**geo)
        self.tpool = PagePool(device="cpu", **geo)
        rng = np.random.default_rng(seed)
        for name in PAYLOAD:
            x = rng.standard_normal(
                getattr(self.tpool.state, name).shape).astype(np.float32)
            self.jpool.state = dataclasses.replace(
                self.jpool.state, **{name: jnp.asarray(x)})
            getattr(self.tpool.state, name).copy_(torch.from_numpy(x))
        self.jal = JAlloc(self.jpool, host_swap_pages=swap)
        self.tal = VBIAllocator(self.tpool, host_swap_pages=swap)
        self.blocks = {}                         # name -> (ref, port)

    def call(self, op, *args, name=None, **kw):
        """``op`` on both allocators, block arguments given by name."""
        def pick(side):
            return [self.blocks[a][side] if isinstance(a, str) else a
                    for a in args]
        out = (getattr(self.jal, op)(*pick(0), **kw),
               getattr(self.tal, op)(*pick(1), **kw))
        if name is not None:
            self.blocks[name] = out
        return out

    def feed(self, name, n):
        """``n`` tokens of a block: reserve, device allocation, commit."""
        jb, tb = self.blocks[name]
        for _ in range(n):
            self.call("reserve", name, jb.n_tokens + 1)
            mask = np.arange(self.tpool.max_seqs) == tb.slot
            self.jpool.state, _ = jk.reserve_positions(
                self.jpool.state, jnp.asarray(mask))
            tk.reserve_positions(self.tpool.state, torch.from_numpy(mask))
            self.call("commit", name, jb.n_tokens + 1)

    def assert_same(self, where=""):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(self.tpool.state, f).numpy(),
                np.asarray(getattr(self.jpool.state, f)),
                err_msg=f"{f} {where}")
        assert self.tal.free_pages == self.jal.free_pages
        assert self.tal.stats == self.jal.stats


def _same_image(ti, ji):
    for f in ("tokens", "n_tokens", "page_size", "n_pages", "charge",
              "lineage", "src_bid", "src_pool", "checksum"):
        assert getattr(ti, f) == getattr(ji, f), f
    assert int(ti.props) == int(ji.props) and ti.nbytes == ji.nbytes
    np.testing.assert_array_equal(ti.k, ji.k)
    np.testing.assert_array_equal(ti.v, ji.v)
    assert len(ti.aux) == len(ji.aux) == 6
    for a, b in zip(ti.aux, ji.aux):
        np.testing.assert_array_equal(a, b)


def _state_copy(al):
    st = al.pool.state
    return ({f: getattr(st, f).clone() for f in FIELDS}, al.free_pages,
            dict(al.stats), {s: dataclasses.replace(b)
                             for s, b in al.blocks.items()},
            al.swap.used_pages, dict(al.swap.images))


def _assert_unchanged(al, before):
    st, free, stats, blocks, used, images = before
    for f in FIELDS:
        assert torch.equal(getattr(al.pool.state, f), st[f]), f
    assert al.free_pages == free and al.stats == stats
    assert al.blocks.keys() == blocks.keys()
    for s, b in al.blocks.items():
        assert dataclasses.asdict(b) == dataclasses.asdict(blocks[s])
    assert al.swap.used_pages == used and al.swap.images == images


# --------------------------------------------------------------------------
# sealed images
# --------------------------------------------------------------------------
def test_images_carry_the_reference_crc():
    """Snapshot and export of the same block give the reference's arrays
    and checksum; a snapshot leaves the block resident and the pool as it
    was."""
    p = Pair()
    p.call("alloc", 1, name="a")
    p.feed("a", 5)                               # 3 pages at ps=2
    tokens, lineage = list(range(5)), {"rid": 7, "preemptions": 1}
    before = _state_copy(p.tal)
    js, ts = p.call("snapshot_image", "a", tokens=tokens, lineage=lineage)
    _same_image(ts, js)
    assert ts.lineage == {"rid": 7, "preemptions": 1, "snapshot": True}
    assert ts.verify() and ts.checksum == ts.compute_checksum()
    tb = p.blocks["a"][1]
    assert tb.status == "resident" and tb.slot == 1
    before[2]["image_snapshots"] += 1
    _assert_unchanged(p.tal, before)
    je, te = p.call("export_image", "a", tokens=tokens, lineage=lineage)
    _same_image(te, je)
    assert te.verify() and te.n_pages == 3 and te.charge == 3 + 3
    assert tb.status == "exported" and tb.slot == -1
    p.assert_same("after export")
    p.call("free", "a")                          # custody left: a no-op
    assert p.tal.pages_in_use == 0


def test_verify_catches_a_flipped_bit_and_a_falsified_charge():
    p = Pair()
    p.call("alloc", 0, name="a")
    p.feed("a", 4)
    img = p.tal.export_image(p.blocks["a"][1], tokens=[1, 2, 3, 4])
    assert img.verify()
    k = img.k.copy()
    k.view(np.uint8).reshape(-1)[5] ^= 0x01
    assert not dataclasses.replace(img, k=k).verify()
    aux = list(img.aux)
    aux[2] = aux[2].copy()
    aux[2].view(np.uint8).reshape(-1)[0] ^= 0x80
    assert not dataclasses.replace(img, aux=tuple(aux)).verify()
    assert not dataclasses.replace(img, charge=img.charge + 1).verify()
    assert not dataclasses.replace(img, tokens=[1, 2, 3, 5]).verify()
    assert not dataclasses.replace(img, checksum=None).verify()
    assert isinstance(img, BlockImage) and img.verify()


def test_corrupt_image_is_refused_before_any_state_changes():
    p = Pair()
    p.call("alloc", 0, name="a")
    p.feed("a", 4)
    img = p.tal.export_image(p.blocks["a"][1], tokens=[1, 2, 3, 4])
    bad = dataclasses.replace(img, charge=img.charge + 1)
    p.tal.alloc(2)
    before = _state_copy(p.tal)
    with pytest.raises(ImageIntegrityError, match="checksum") as ei:
        p.tal.import_image(bad, 1)
    assert ei.value.fault_id is None
    _assert_unchanged(p.tal, before)
    # a FaultPlan's transit corruption names its fault
    plan = FaultPlan({}, seed=3)
    install_faults(p.tal, plan)
    plan.force("image_corrupt")
    with pytest.raises(ImageIntegrityError) as ei:
        p.tal.import_image(img, 1)
    assert ei.value.fault_id == 0 and plan.stats["unresolved"] == 1
    _assert_unchanged(p.tal, before)
    p.tal.drop_image(img)
    assert p.tal.stats["image_drops"] == 1


def test_import_into_a_pool_of_another_size_matches_reference():
    """An image exported from a 4-slot, 33-page pool with 8-page rows
    lands in a 2-slot, 14-page pool with 5-page rows: the destination's
    device state equals the reference's after the same import, and the
    block decodes on from the imported length."""
    src = Pair(seed=1)
    src.call("alloc", 3, name="a")
    src.feed("a", 7)                             # 4 pages
    jimg, timg = src.call("export_image", "a", tokens=list(range(7)))
    dst = Pair(seed=2, n_pages=14, max_seqs=2, max_pages_per_seq=5)
    dst.call("alloc", 0, name="x")
    dst.feed("x", 3)
    jb = dst.jal.import_image(jimg, 1, reserve_pages=5)
    tb = dst.tal.import_image(timg, 1, reserve_pages=5)
    dst.blocks["b"] = (jb, tb)
    dst.assert_same("after import")
    assert tb.bid == jb.bid and tb.slot == 1 and tb.n_tokens == 7
    assert tb.reserved_pages == 5 and int(tb.props) == int(jb.props)
    got = dst.call("snapshot_image", "b")[1]
    np.testing.assert_array_equal(got.k, timg.k)
    for a, b in zip(got.aux, timg.aux):
        np.testing.assert_array_equal(a, b)
    dst.feed("b", 2)
    dst.assert_same("decoding on")
    with pytest.raises(ValueError, match="row width"):
        Pair(max_pages_per_seq=3).tal.import_image(timg, 0)
    with pytest.raises(ValueError, match="page-size"):
        Pair(page_size=4).tal.import_image(timg, 0)
    with pytest.raises(ValueError, match="layer kinds"):
        Pair(ring_layers=0).tal.import_image(timg, 0)


def test_duplicate_import_is_deduplicated():
    p = Pair()
    p.call("alloc", 0, name="a")
    p.feed("a", 3)
    img = p.tal.export_image(p.blocks["a"][1], lineage={"rid": 1})
    free0 = p.tal.free_pages
    blk = p.tal.import_image(img, 2)
    again = p.tal.import_image(copy.deepcopy(img), 3)
    assert again is blk and p.tal.stats["image_imports_deduped"] == 1
    assert p.tal.stats["image_imports"] == 1 and 3 not in p.tal.blocks
    assert p.tal.free_pages == free0 - img.n_pages
    p.tal.swap_out(blk)                          # leaves residency ...
    fresh = p.tal.import_image(img, 3)           # ... so a new import
    assert fresh is not blk and fresh.bid != blk.bid


# --------------------------------------------------------------------------
# the tracer hook
# --------------------------------------------------------------------------
def test_trace_events_equal_the_reference():
    p = Pair()
    recs = (TraceRecorder(clock=lambda: 0.0), TraceRecorder(clock=lambda: 0.0))
    p.jal.attach_tracer(recs[0])
    p.tal.attach_tracer(recs[1])
    p.call("alloc", 0, name="a")
    p.feed("a", 4)
    p.call("reserve_span", "a", 4, 3)
    p.call("commit", "a", 5)
    p.call("unreserve", "a", 5)
    rows = p.call("page_row", "a", 2)
    assert rows[0] == rows[1]
    p.call("alloc", 1, name="b")
    p.call("swap_out", "b")                      # nothing to save: False
    p.feed("b", 3)
    assert p.call("swap_out", "b") == (True, True)
    p.call("alloc", 2, name="c")
    p.feed("c", 2)
    p.call("swap_in", "b", 3, reserve_pages=3)
    imgs = p.call("export_image", "c", tokens=[4, 5],
                  lineage={"rid": 2})
    p.jal.import_image(imgs[0], 2)
    p.tal.import_image(imgs[1], 2)
    p.jal.import_image(imgs[0], 1)               # re-delivered: dedup
    p.tal.import_image(imgs[1], 1)
    snaps = p.call("snapshot_image", "a", tokens=[1, 2, 3, 4, 5])
    p.jal.drop_image(snaps[0])
    p.tal.drop_image(snaps[1])
    p.call("free", "a")
    p.call("free", "a")
    p.call("free", "b")
    for al in (p.jal, p.tal):
        for blk in list(al.blocks.values()):
            al.free(blk)
    p.assert_same("end")
    # the uniform pool's sharing ops trace too
    u = Pair(ring_layers=0, rg_layers=0)
    urecs = (TraceRecorder(clock=lambda: 0.0),
             TraceRecorder(clock=lambda: 0.0))
    u.jal.attach_tracer(urecs[0])
    u.tal.attach_tracer(urecs[1])
    u.call("alloc", 0, name="a")
    u.feed("a", 4)
    jpages, pages = u.call("page_row", "a", 2)
    assert pages == jpages
    for side, al in enumerate((u.jal, u.tal)):      # cache custody
        al.retain(pages, from_block=u.blocks["a"][side])
    u.jal.retain([], from_block=None)
    u.tal.retain([], from_block=None)
    u.call("alloc", 1, name="b")
    u.call("reserve_pages", "b", 1)
    u.call("map_shared", "b", pages[:1], 2)
    u.call("cow_break", "b", 1, pages[1], 3)
    assert u.call("swap_out", "b") == (True, True)   # shared + COW pages
    u.call("free", "b")                              # drops the image
    u.call("free", "a")
    u.call("release", pages)
    u.assert_same("uniform end")
    for (jr, tr) in (recs, urecs):
        strip = [[{k: v for k, v in e.items() if k != "ts"}
                  for e in r.events] for r in (jr, tr)]
        assert len(strip[1]) > 15
        assert strip[1] == strip[0]
        summary = check_trace(tr.events)
        assert summary["live_blocks"] == 0 and summary["swap_pages_held"] == 0
    ops = {e["op"] for r in (recs[1], urecs[1]) for e in r.events
           if e["type"] == "block"}
    assert ops >= {"alloc", "place", "reserve", "commit", "unreserve",
                   "swap_out", "swap_in", "export_image", "import_image",
                   "import_dedup", "snapshot_image", "drop_image", "free",
                   "retain", "map_shared", "cow_break", "release"}


# --------------------------------------------------------------------------
# the fault hook
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["alloc", "swap_out", "swap_in"])
def test_forced_fault_leaves_the_allocator_as_it_was(kind):
    p = Pair()
    al = p.tal
    plan = FaultPlan({}, seed=1)
    install_faults(al, plan)
    rec = TraceRecorder(clock=lambda: 0.0)
    al.attach_tracer(rec)
    p.call("alloc", 0, name="a")
    p.feed("a", 5)
    blk = p.blocks["a"][1]
    if kind == "swap_in":
        assert al.swap_out(blk)
    op = {"alloc": lambda: al.reserve(blk, 9),
          "swap_out": lambda: al.swap_out(blk),
          "swap_in": lambda: al.swap_in(blk, 2)}[kind]
    before = _state_copy(al)
    n_events = len(rec.events)
    plan.force(kind)
    with pytest.raises(TransientFault) as ei:
        op()
    assert ei.value.kind == kind
    _assert_unchanged(al, before)
    assert [e["type"] for e in rec.events[n_events:]] == ["fault"]
    op()                                         # the retry goes through
    plan.resolve([ei.value], "retry_ok", tracer=rec)
    assert plan.stats["unresolved"] == 0
    al.free(blk)
    assert al.pages_in_use == 0 and al.swap.used_pages == 0
    install_faults(al, None)
    assert al.faults is None
    check_trace(rec.events)
