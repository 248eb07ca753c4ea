"""The host swap tier in the port against the JAX package:

  * the device ops (``core/vbi/kvcache.py``: ``snapshot_block``,
    ``restore_block``, ``snapshot_aux``, ``restore_aux``,
    ``pad_block_image``, ``kv_payload_checksum``): random sequences of
    admit / token / release / swap (gather, release, restore into any free
    slot, ring frames and recurrent rows with it) on a seeded payload leave
    every field of the state equal to the reference's after every op —
    exactly, since these are integer ops and copies;
  * the allocator keeps conservation (refcounts, free stack, host mirror,
    cache ledger) under random admit / feed / share / COW / swap / export /
    import / fault traces in the uniform, hetero and ring-recurrent
    flavours, and the reference's offline ``check_trace`` replays the
    recorded events clean (the reference's own sweep, on the port);
  * the declared properties decide swapping (PINNED, not SWAPPABLE, the
    tier's capacity), and a RING/RECURRENT block's image carries and is
    charged for its aux state;
  * the legacy ``PagedKVManager`` matches the reference's and, behind
    ``LegacyKVAllocator``, agrees with the allocator's reservation
    arithmetic;
  * scheduler level: discard, swap and swap + overlap, cache off and on,
    each request equal to the reference model's greedy decode of it (not
    to the JAX scheduler's: ROADMAP.md § C1), each swap serve prefilling
    fewer tokens than the matching discard serve; a victim whose restore
    could not fit the pool is discarded;
  * the mixed stacks: gemma3 swaps its ring frames under pool pressure,
    and recurrentgemma's and mamba2's recurrent rows resume on another
    slot, equal to the uninterrupted decode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro.core.vbi import kvcache as jk
from repro.serve.faults import FaultPlan, install_faults
from repro.serve.recovery import retry_call
from repro.serve.telemetry import TraceRecorder, check_trace
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.core.vbi.blocks import (ImageIntegrityError,
                                         LegacyKVAllocator, PagePool,
                                         VBIAllocator)
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Scheduler

FIELDS = [f.name for f in dataclasses.fields(tk.PagedServeState)]
PAYLOAD = ("k_pages", "v_pages", "k_ring", "v_ring", "rg_h", "rg_conv",
           "ssm_state", "ssm_conv")


# --------------------------------------------------------------------------
# the device ops
# --------------------------------------------------------------------------
STATE = dict(n_layers=2, n_pages=12, page_size=2, n_kv=2, head_dim=4,
             max_seqs=3, max_pages_per_seq=4, n_ring_layers=1, ring_pages=2,
             n_rg=1, rnn_width=5, n_ssm=1, ssm_heads=2, ssm_proj=3,
             ssm_state_size=4, ssm_conv_ch=6)


def _assert_same(js, ts, where):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=f"{name} {where}")


def _seeded_states(rng):
    """The same pool on both sides, every payload tensor filled with the
    same seeded numbers (so a page or row restored in the wrong place
    shows)."""
    js = jk.init_serve_state(**STATE)
    ts = tk.init_serve_state(device="cpu", **STATE)
    for name in PAYLOAD:
        x = rng.standard_normal(getattr(ts, name).shape).astype(np.float32)
        js = dataclasses.replace(js, **{name: jnp.asarray(x)})
        getattr(ts, name).copy_(torch.from_numpy(x))
    return js, ts


@pytest.mark.parametrize("seed", range(4))
def test_swap_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    js, ts = _seeded_states(rng)
    S, ps, P = STATE["max_seqs"], STATE["page_size"], \
        STATE["max_pages_per_seq"]
    table = tk.make_ring_table(S, STATE["ring_pages"])
    active, lens = set(), np.zeros(S, int)
    free = STATE["n_pages"] - 1
    n_swaps = 0
    for step in range(40):
        op = rng.choice(["admit", "release", "token", "token", "swap",
                         "swap"])
        if op == "admit" and len(active) < S:
            s = int(rng.choice([x for x in range(S) if x not in active]))
            js = jk.admit_slot(js, jnp.int32(s))
            tk.admit_slot(ts, s)
            active.add(s)
            lens[s] = 0
        elif op == "release" and active:
            s = int(rng.choice(sorted(active)))
            js = jk.release_slot(js, jnp.int32(s))
            tk.release_slot(ts, s)
            active.discard(s)
            free += -(-lens[s] // ps)
            lens[s] = 0
        elif op == "token" and active:
            mask = np.array([s in active and lens[s] < P * ps
                             and rng.random() < 0.7 for s in range(S)])
            pops = sum(1 for s in range(S) if mask[s] and lens[s] % ps == 0)
            if pops > free:
                continue
            free -= pops
            js, _ = jk.reserve_positions(js, jnp.asarray(mask))
            tk.reserve_positions(ts, torch.from_numpy(mask))
            lens += mask
            # the recurrent rows move on, so each aux image is another one
            x = rng.standard_normal(ts.rg_h.shape).astype(np.float32)
            js = dataclasses.replace(js, rg_h=jnp.asarray(x))
            ts.rg_h.copy_(torch.from_numpy(x))
        elif op == "swap" and active:
            s = int(rng.choice(sorted(active)))
            n = -(-lens[s] // ps)
            k, v = tk.snapshot_block(ts, s, n)
            aux = tk.snapshot_aux(ts, s, torch.from_numpy(table[s]))
            jkb, jvb = jk.snapshot_block(js, jnp.int32(s))
            jaux = jk.snapshot_aux(js, jnp.int32(s), jnp.asarray(table[s]))
            img = (k.numpy().copy(), v.numpy().copy(),
                   tuple(a.numpy().copy() for a in aux))
            np.testing.assert_array_equal(img[0], np.asarray(jkb)[:, :n])
            np.testing.assert_array_equal(img[1], np.asarray(jvb)[:, :n])
            for a, b in zip(img[2], jaux):
                np.testing.assert_array_equal(a, np.asarray(b))
            assert tk.kv_payload_checksum(*img) == jk.kv_payload_checksum(
                np.asarray(jkb)[:, :n], np.asarray(jvb)[:, :n],
                tuple(np.asarray(b) for b in jaux))
            js = jk.release_slot(js, jnp.int32(s))
            tk.release_slot(ts, s)
            active.discard(s)
            d = int(rng.choice([x for x in range(S) if x not in active]))
            kp, vp = tk.pad_block_image(img[0], img[1], n, P)
            np.testing.assert_array_equal(
                kp, jk.pad_block_image(img[0], img[1], n, P)[0])
            js = jk.restore_block(js, jnp.int32(d), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.int32(n),
                                  jnp.int32(lens[s]))
            js = jk.restore_aux(js, jnp.int32(d), jnp.asarray(table[d]),
                                *(jnp.asarray(a) for a in img[2]))
            # the port restores the image unpadded: only its n pages move
            tk.restore_block(ts, d, torch.from_numpy(img[0]),
                             torch.from_numpy(img[1]), n, int(lens[s]))
            tk.restore_aux(ts, d, torch.from_numpy(table[d]),
                           *(torch.from_numpy(a) for a in img[2]))
            lens[d], active = lens[s], active | {d}
            if d != s:
                lens[s] = 0
            n_swaps += 1
        _assert_same(js, ts, f"seed {seed} step {step} ({op})")
    assert n_swaps > 0
    with pytest.raises(ValueError, match="row width"):
        tk.pad_block_image(img[0], img[1], P + 1, P)


# --------------------------------------------------------------------------
# the allocator: conservation under random traces (the reference's sweep)
# --------------------------------------------------------------------------
def _mk(n_pages=33, page_size=2, max_seqs=4, rowP=8, swap=0, n_layers=1,
        ring=0, rg=0, placement=()):
    pool = PagePool(n_layers=n_layers, n_pages=n_pages, page_size=page_size,
                    n_kv=1, head_dim=2, max_seqs=max_seqs,
                    max_pages_per_seq=rowP, ring_layers=ring, ring_pages=2,
                    rg_layers=rg, rnn_width=4, placement=placement,
                    device="cpu")
    return pool, VBIAllocator(pool, host_swap_pages=swap)


def _advance(pool, blk):
    """One token of ``blk`` on the device: delayed page allocation."""
    mask = torch.zeros(pool.max_seqs, dtype=torch.bool)
    mask[blk.slot] = True
    tk.reserve_positions(pool.state, mask, has_full=pool.has_full)


def _feed(pool, al, blk, n=1):
    """Advance a block by ``n`` tokens as the engine's step does: reserve
    (host mirror), then device delayed allocation."""
    for _ in range(n):
        al.reserve(blk, blk.n_tokens + 1)
        _advance(pool, blk)
        al.commit(blk, blk.n_tokens + 1)


def _land(pool, al, blk, n0, k, rng):
    """A horizon's reconcile: j <= K tokens landed on device (a slot may
    stop early), committed, and the surplus reservation returned."""
    j = int(rng.integers(0, k + 1))
    for _ in range(j):
        _advance(pool, blk)
    al.commit(blk, n0 + j)
    al.unreserve(blk, n0 + j)


def _conservation(pool, al, blocks, ledger):
    """Refcounts, free stack and host mirror tell the same story."""
    st = pool.state
    refc = st.page_refcounts.numpy()
    free_top = int(st.free_top)
    assert free_top <= pool.n_pages - 1
    in_use = pool.n_pages - 1 - free_top
    assert int((refc > 0).sum()) == in_use
    stack = st.free_stack[:free_top].tolist()
    assert len(set(stack)) == free_top          # free pages are distinct
    assert (refc[stack] == 0).all()             # ... and unreferenced
    expected_refs, mapped = len(ledger), set(ledger)
    pt, lens = st.page_table.numpy(), st.seq_lens.numpy()
    for blk in blocks:
        if blk.status != "resident":
            continue
        n = (-(-int(lens[blk.slot]) // pool.page_size)
             if pool.has_full else 0)
        expected_refs += n
        mapped.update(pt[blk.slot, :n].tolist())
    assert int(refc.sum()) == expected_refs
    assert in_use == len(mapped)
    assert al.free_pages <= free_top            # the mirror is conservative


@pytest.mark.parametrize("flavor", ["uniform", "hetero", "ring-recurrent"])
def test_refcount_conservation_random_traces(flavor):
    """The reference's property sweep (``tests/test_vbi_blocks.py``) on the
    port's allocator: after every op of a random admit / feed / horizon /
    share / COW / cache release / swap / export / import / fault trace,
    conservation holds; the drained pool comes back whole, every injected
    fault is resolved, and the reference's ``check_trace`` replays the
    recorded events clean.  Odd seeds run on a pool placed on 2 devices."""
    ps, rowP, max_seqs = 2, 8, 4
    kinds = {"uniform": dict(), "hetero": dict(ring=2, rg=1),
             "ring-recurrent": dict(n_layers=0, ring=2, rg=1)}[flavor]
    shareable = flavor == "uniform"
    for seed in range(4 if flavor == "uniform" else 2):
        rng = np.random.default_rng(seed)
        placement = ("cpu:0", "cpu:1") if seed % 2 else ()
        pool, al = _mk(n_pages=33, page_size=ps, max_seqs=max_seqs,
                       rowP=rowP, swap=16, placement=placement, **kinds)
        rec = TraceRecorder(clock=lambda: 0.0)
        al.attach_tracer(rec)
        plan = FaultPlan({}, seed=seed)
        install_faults(al, plan)
        blocks, ledger, pinned_by, staged, images = [], [], {}, {}, []
        for _ in range(70):
            resident = [b for b in blocks if b.status == "resident"]
            quiet = [b for b in resident if b.bid not in staged]
            swapped = [b for b in blocks if b.status == "swapped"]
            free_slots = [s for s in range(max_seqs) if s not in al.blocks]
            op = rng.choice(["alloc", "feed", "horizon_feed", "cache_insert",
                             "map_shared", "cow", "release_cache",
                             "swap_out", "swap_in", "free", "double_free",
                             "stage_ahead", "arrive", "handoff_out",
                             "handoff_in", "fault_alloc", "fault_swap",
                             "fault_import"])
            if op == "alloc" and free_slots:
                blocks.append(al.alloc(int(rng.choice(free_slots))))
            elif op == "feed" and quiet:
                blk = quiet[rng.integers(len(quiet))]
                n = min(int(rng.integers(1, ps * 2 + 1)),
                        rowP * ps - blk.n_tokens)
                need = (al.pages_for(blk.n_tokens + n) - blk.shared_pages
                        - blk.reserved_pages)
                if n > 0 and need <= al.free_pages:
                    _feed(pool, al, blk, n)
            elif op in ("horizon_feed", "stage_ahead") and quiet:
                # span-reserve K tokens; a horizon advances j <= K tokens
                # at once, a staged one when it 'arrive's (overlap)
                blk = quiet[rng.integers(len(quiet))]
                k = min(int(rng.integers(1, ps * 2 + 1)),
                        rowP * ps - blk.n_tokens)
                need = (al.pages_for(blk.n_tokens + k) - blk.shared_pages
                        - blk.reserved_pages)
                if k > 0 and need <= al.free_pages:
                    al.reserve_span(blk, blk.n_tokens, k)
                    if op == "stage_ahead":
                        staged[blk.bid] = (blk, blk.n_tokens, k)
                    else:
                        _land(pool, al, blk, blk.n_tokens, k, rng)
            elif op == "cache_insert" and quiet and shareable:
                blk = quiet[rng.integers(len(quiet))]
                row = al.page_row(blk, blk.n_tokens // ps)
                new = [p for p in row[blk.shared_pages:] if p not in ledger]
                if new and blk.reserved_pages >= len(new):
                    al.retain(new, from_block=blk)
                    ledger.extend(new)
                    for p in new:
                        pinned_by.setdefault(p, set()).add(blk.bid)
            elif op == "map_shared" and ledger and free_slots:
                k = int(rng.integers(1, min(len(ledger), rowP - 1) + 1))
                pages = [int(p) for p in rng.choice(ledger, size=k,
                                                    replace=False)]
                blk = al.alloc(int(rng.choice(free_slots)))
                blocks.append(blk)
                al.map_shared(blk, pages, k * ps)
                for p in pages:
                    pinned_by.setdefault(p, set()).add(blk.bid)
            elif op == "cow" and ledger and free_slots \
                    and al.free_pages >= 1:
                src = int(rng.choice(ledger))
                blk = al.alloc(int(rng.choice(free_slots)))
                blocks.append(blk)
                al.reserve_pages(blk, 1)
                al.cow_break(blk, 0, src, int(rng.integers(1, ps)))
            elif op == "release_cache" and ledger:
                live = {p for p, bids in pinned_by.items()
                        if any(b.bid in bids and b.status == "resident"
                               for b in blocks)}
                frees = [p for p in ledger if p not in live]
                if frees:
                    page = int(rng.choice(frees))
                    al.release([page])
                    ledger.remove(page)
            elif op == "swap_out" and quiet:
                blk = quiet[rng.integers(len(quiet))]
                if al.swap_out(blk):
                    for bids in pinned_by.values():
                        bids.discard(blk.bid)
            elif op == "swap_in" and swapped and free_slots:
                blk = swapped[rng.integers(len(swapped))]
                if al.pages_for(blk.n_tokens) <= al.free_pages:
                    al.swap_in(blk, int(rng.choice(free_slots)))
            elif op == "handoff_out" and quiet:
                blk = quiet[rng.integers(len(quiet))]
                images.append(al.export_image(
                    blk, tokens=list(range(blk.n_tokens))))
                for bids in pinned_by.values():
                    bids.discard(blk.bid)
            elif op == "handoff_in" and images and free_slots:
                img = images[rng.integers(len(images))]
                if img.n_pages <= al.free_pages:
                    images.remove(img)
                    blocks.append(al.import_image(
                        img, int(rng.choice(free_slots))))
            elif op == "fault_alloc" and quiet:
                blk = quiet[rng.integers(len(quiet))]
                n = min(int(rng.integers(1, ps * 2 + 1)),
                        rowP * ps - blk.n_tokens)
                need = (al.pages_for(blk.n_tokens + n) - blk.shared_pages
                        - blk.reserved_pages)
                if n > 0 and 0 < need <= al.free_pages:
                    plan.force("alloc")
                    _, fired = retry_call(
                        lambda b=blk, t=blk.n_tokens + n: al.reserve(b, t))
                    plan.resolve(fired, "retry_ok", tracer=rec)
                    _feed(pool, al, blk, n)
            elif op == "fault_swap":
                if quiet and al.swap is not None:
                    blk = quiet[rng.integers(len(quiet))]
                    charge = al.pages_for(blk.n_tokens) + pool.aux_swap_pages
                    if (blk.swappable and not blk.pinned and blk.n_tokens > 0
                            and al.swap.can_hold(charge)):
                        plan.force("swap_out")
                        ok, fired = retry_call(lambda b=blk: al.swap_out(b))
                        plan.resolve(fired, "retry_ok", tracer=rec)
                        assert ok
                        for bids in pinned_by.values():
                            bids.discard(blk.bid)
                elif swapped and free_slots:
                    blk = swapped[rng.integers(len(swapped))]
                    if al.pages_for(blk.n_tokens) <= al.free_pages:
                        plan.force("swap_in")
                        _, fired = retry_call(
                            lambda b=blk, s=int(rng.choice(free_slots)):
                            al.swap_in(b, s))
                        plan.resolve(fired, "retry_ok", tracer=rec)
            elif op == "fault_import" and images and free_slots:
                img = images[rng.integers(len(images))]
                if img.n_pages <= al.free_pages:
                    images.remove(img)
                    slot = int(rng.choice(free_slots))
                    if rng.random() < 0.5:
                        plan.force("image_loss")
                        blk, fired = retry_call(
                            lambda i=img, s=slot: al.import_image(i, s))
                        plan.resolve(fired, "retry_ok", tracer=rec)
                        blocks.append(blk)
                    else:
                        plan.force("image_corrupt")
                        with pytest.raises(ImageIntegrityError) as ei:
                            al.import_image(img, slot)
                        al.drop_image(img)
                        plan.resolve([ei.value.fault_id], "fallback",
                                     tracer=rec, detail="dropped")
            elif op == "arrive" and staged:
                _land(pool, al, *staged.pop(int(rng.choice(list(staged)))),
                      rng)
            elif op in ("free", "double_free") and (quiet or swapped):
                pick = quiet + swapped
                blk = pick[rng.integers(len(pick))]
                al.free(blk)
                for bids in pinned_by.values():
                    bids.discard(blk.bid)
                if op == "double_free":
                    top = int(pool.state.free_top)
                    al.free(blk)                 # must stay a no-op
                    assert int(pool.state.free_top) == top
            _conservation(pool, al, blocks, ledger)
        for blk in blocks:
            al.free(blk)
        al.release(ledger)
        for img in images:
            blk = al.import_image(img, 0)
            blocks.append(blk)
            al.free(blk)
        assert al.pages_in_use == 0
        assert al.free_pages == int(pool.state.free_top) == pool.n_pages - 1
        assert plan.stats["unresolved"] == 0
        summary = check_trace(rec.events)
        assert summary["n_blocks"] == len(blocks)
        assert summary["live_blocks"] == 0 and summary["ledger_pages"] == 0
        assert summary["swap_pages_held"] == 0
        assert summary["images_in_flight"] == 0
        assert summary["faults_unresolved"] == 0
        assert summary["n_faults"] == sum(plan.fired.values())


# --------------------------------------------------------------------------
# swap and tier rules
# --------------------------------------------------------------------------
def test_swap_out_respects_declared_properties():
    pool, al = _mk(swap=2)
    pinned = al.alloc(0, props=VBProps.KV_CACHE | VBProps.SWAPPABLE
                      | VBProps.PINNED)
    _feed(pool, al, pinned, 3)
    assert not al.swap_out(pinned)               # PINNED: never demoted
    plain = al.alloc(1, props=VBProps.KV_CACHE)
    _feed(pool, al, plain, 3)
    assert not al.swap_out(plain)                # not declared SWAPPABLE
    ok = al.alloc(2)                             # default props: SWAPPABLE
    _feed(pool, al, ok, 3)
    assert al.swap_out(ok)                       # 2 pages fill the tier
    assert ok.status == "swapped" and ok.slot == -1 and 2 not in al.blocks
    late = al.alloc(3)
    _feed(pool, al, late, 3)
    assert not al.swap_out(late)                 # tier capacity enforced
    assert al.stats["swap_rejects"] == 1
    assert not _mk()[1].swap_out(late)           # no tier at all


def test_hetero_swap_image_carries_aux_and_charges_tier():
    """A RING/RECURRENT block's image holds its ring frames and recurrent
    rows and charges the tier for them (2 ring frames + 1 recurrent
    page-equivalent), bounded by the declared properties."""
    pool, al = _mk(swap=8, ring=2, rg=1)
    blk = al.alloc(0)
    assert blk.props & (VBProps.RING | VBProps.RECURRENT)
    _feed(pool, al, blk, 4)                     # 2 full pages at ps=2
    pool.state.rg_h[:, 0] = 7.0
    assert al.swap_out(blk)
    img = al.swap.images[blk.bid]
    assert img.aux is not None and img.charge == img.n_pages + 3 == 5
    assert (img.aux[2] == 7.0).all() and al.swap.used_pages == 5
    assert al.swap.bytes_held == al.stats["swap_bytes_out"]
    blk2 = al.alloc(1)
    _feed(pool, al, blk2, 4)
    assert not al.swap_out(blk2)                # 3 left < 5: tier enforced
    assert al.stats["swap_rejects"] == 1
    al.swap_in(blk, 2)                          # another slot
    assert (pool.state.rg_h[:, 2] == 7.0).all()
    assert al.swap.used_pages == 0 and blk.slot == 2
    al.free(blk)
    al.free(blk2)
    assert al.free_pages == int(pool.state.free_top) == pool.n_pages - 1


def test_swap_in_refuses_before_touching_anything():
    pool, al = _mk(swap=8)
    blk = al.alloc(0)
    _feed(pool, al, blk, 5)
    assert al.swap_out(blk)
    other = al.alloc(1)
    with pytest.raises(ValueError, match="busy"):
        al.swap_in(blk, 1)
    with pytest.raises(ValueError, match="cannot hold"):
        al.swap_in(blk, 2, reserve_pages=1)
    al.reserve_pages(other, al.free_pages - 1)
    with pytest.raises(RuntimeError, match="oversubscribed"):
        al.swap_in(blk, 2)
    assert blk.status == "swapped" and al.swap.used_pages == 3
    al.free(other)
    with pytest.raises(ValueError, match="not swapped"):
        al.swap_in(al.swap_in(blk, 2), 3)


# --------------------------------------------------------------------------
# the legacy oracle
# --------------------------------------------------------------------------
def test_legacy_manager_matches_reference_and_wraps_as_oracle():
    """The legacy ``PagedKVManager`` against the reference's (pages, table,
    lengths, gathers equal after appends, token-by-layer writes and
    releases), then behind ``LegacyKVAllocator`` against the allocator's
    reservation arithmetic, op for op."""
    rng = np.random.default_rng(5)
    geo = dict(n_layers=2, n_pages=9, page_size=2, n_kv=2, head_dim=3,
               max_seqs=2)
    jm = jk.PagedKVManager(dtype=jnp.float32, **geo)
    tm = tk.PagedKVManager(dtype=torch.float32, device="cpu", **geo)
    for s in range(2):
        jm.new_seq(s)
        tm.new_seq(s)
    for step in range(7):
        kv = rng.standard_normal((2, 2, 2, 3)).astype(np.float32)
        jm.append(0, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        tm.append(0, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]))
        assert tm.begin_token(1) == jm.begin_token(1)
        for layer in range(2):
            jm.write_layer(1, layer, jnp.asarray(kv[0, layer]),
                           jnp.asarray(kv[1, layer]))
            tm.write_layer(1, layer, torch.from_numpy(kv[0, layer]),
                           torch.from_numpy(kv[1, layer]))
        for f in ("k_pages", "v_pages", "page_table", "seq_lens"):
            np.testing.assert_array_equal(getattr(tm.state, f).numpy(),
                                          np.asarray(getattr(jm.state, f)))
        for s in range(2):
            for a, b in zip(tm.gather(s, 1), jm.gather(s, 1)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tm.stats == jm.stats and tm.free_pages == jm.free_pages
    tm.release_seq(0)
    jm.release_seq(0)
    tm.release_seq(0)                            # double release: no-op
    assert tm.pages_in_use == jm.pages_in_use and tm.stats == jm.stats
    with pytest.raises(RuntimeError, match="exhausted"):
        tm.ensure_capacity(1, 2 * 9)

    legacy = LegacyKVAllocator(tk.PagedKVManager(
        n_layers=1, n_pages=33, page_size=2, n_kv=1, head_dim=2,
        max_seqs=4, device="cpu"))
    pool, al = _mk()
    pairs = {}
    for _ in range(60):
        op = rng.choice(["alloc", "reserve", "free"])
        if op == "alloc":
            free = [s for s in range(4) if s not in pairs]
            if free:
                s = int(rng.choice(free))
                pairs[s] = (legacy.alloc(s), al.alloc(s))
        elif op == "reserve" and pairs:
            lb, vb = pairs[int(rng.choice(list(pairs)))]
            n = int(rng.integers(1, 13))
            if al.pages_for(n) - vb.reserved_pages <= al.free_pages:
                legacy.reserve(lb, n)
                al.reserve(vb, n)
                assert lb.reserved_pages == vb.reserved_pages
        elif op == "free" and pairs:
            lb, vb = pairs.pop(int(rng.choice(list(pairs))))
            for _ in range(2):                   # double free: no-ops
                legacy.free(lb)
                al.free(vb)
        assert legacy.pages_in_use == (pool.n_pages - 1) - al.free_pages
    with pytest.raises(NotImplementedError):
        legacy.swap_out(None)


# --------------------------------------------------------------------------
# the scheduler's swap resume
# --------------------------------------------------------------------------
#: 3 requests of 5 + 8 tokens on 9 pages of 2 tokens, 2 slots, horizon 4:
#: the younger running request is preempted once in every mode
SCHED = dict(n_pages=10, page_size=2, max_seqs=2, max_pages_per_seq=8)


def _prompts(arch="qwen3-0.6b", n=3, length=5, seed=3):
    cfg = bridged(arch)[0]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, length).tolist() for _ in range(n)]


def _serve(arch, prompts, max_new, *, swap, overlap=False, cache=False,
           K=4, prefill_chunk=4, **geo):
    cfg, _, tp = bridged(arch)
    eng = PagedEngine(cfg, tp, host_swap_pages=swap, device="cpu", **geo)
    sched = Scheduler(eng, prefill_chunk=prefill_chunk, decode_horizon=K,
                      overlap=overlap,
                      prefix_cache=PrefixCache(geo["page_size"])
                      if cache else None)
    for p in prompts:
        sched.add_request(p, max_new=max_new)
    fin = sched.run()
    assert sched._pending is None
    out = [r.out for r in sorted(fin, key=lambda r: r.rid)]
    # drained: the tier is empty and the mirror exact
    assert eng.free_pages == eng.alloc.free_pages
    if eng.alloc.swap is not None:
        assert eng.alloc.swap.used_pages == 0 and not eng.alloc.swap.images
    return out, eng, sched


@pytest.mark.parametrize("cache", [False, True])
def test_swap_resume_matches_reference_greedy(cache):
    """Discard, swap and swap + overlap on the same schedule: every
    request equals the reference model's greedy decode; the swap serves
    demote and restore (no re-prefill of the fed span), so they prefill
    fewer tokens than the discard serve."""
    cfg, jp, _ = bridged("qwen3-0.6b")
    prompts = _prompts()
    ref = [jax_greedy(cfg, jp, p, 8) for p in prompts]
    runs = {mode: _serve("qwen3-0.6b", prompts, 8, cache=cache, **kw,
                         **SCHED)
            for mode, kw in (("discard", dict(swap=0)),
                             ("swap", dict(swap=32)),
                             ("swap + overlap", dict(swap=32, overlap=True)))}
    d_stats = runs["discard"][2].stats
    assert d_stats["preemptions"] >= 1 and d_stats["swap_outs"] == 0
    for mode, (out, eng, sched) in runs.items():
        assert out == ref, mode
        if mode == "discard":
            continue
        st = sched.stats
        assert st["swap_outs"] == st["swap_ins"] >= 1, mode
        assert eng.alloc.stats["swap_outs"] == st["swap_outs"]
        assert eng.alloc.stats["swapped_in_pages"] >= 1
        assert st["prefill_tokens"] < d_stats["prefill_tokens"], mode
        assert (st["overlap_staged_ticks"] > 0) == ("overlap" in mode)
        if cache:
            eng.alloc.release(sched.prefix_cache.evict(
                sched.prefix_cache.n_pages))
        assert eng.pages_in_use == 0


def test_preempt_prefers_discard_when_swap_restore_cannot_fit():
    """A swap image re-admits with its full span budgeted, so a victim
    whose span outgrew the pool takes the discard path."""
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=8, page_size=2, max_seqs=1,
                      max_pages_per_seq=8, host_swap_pages=64, device="cpu")
    sched = Scheduler(eng, prefill_chunk=4)
    sched.add_request([1, 2], max_new=2)
    sched.step()                                 # admit + prefill
    st = next(iter(sched.slots.values()))
    st.req.out.extend([0] * 13)                  # budget 9 > 7 pages
    assert sched._preempt_one()
    assert sched.stats["swap_outs"] == 0 and st.req.block is None
    assert eng.alloc.swap.images == {}


# --------------------------------------------------------------------------
# the mixed stacks
# --------------------------------------------------------------------------
def test_ring_stack_swap_is_exact_and_saves_prefill():
    """gemma3 (5 ring : 1 full) under pressure on its full layer's pages:
    the swap image carries the ring frames and is charged for them; tokens
    equal the reference greedy decode, with fewer prefill tokens than
    discard."""
    cfg, jp, _ = bridged("gemma3-12b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, 4).tolist() for _ in range(2)]
    ref = [jax_greedy(cfg, jp, p, 12) for p in prompts]
    geo = dict(n_pages=8, page_size=4, max_seqs=2, max_pages_per_seq=8)
    discard, _, s_d = _serve("gemma3-12b", prompts, 12, swap=0, **geo)
    charges = []
    swap_out = VBIAllocator.swap_out

    def spy(al, blk):
        ok = swap_out(al, blk)
        if ok:
            img = al.swap.images[blk.bid]
            charges.append((img.charge - img.n_pages, img.aux[0].shape))
        return ok
    VBIAllocator.swap_out = spy
    try:
        swapped, eng, s_s = _serve("gemma3-12b", prompts, 12, swap=32,
                                   **geo)
    finally:
        VBIAllocator.swap_out = swap_out
    assert discard == swapped == ref
    assert s_d.stats["preemptions"] >= 1 and s_s.stats["swap_ins"] >= 1
    ring_pages = eng.geom.ring_pages
    assert charges and all(
        c == (ring_pages, (eng.geom.n_ring, ring_pages, 4, cfg.n_kv,
                           cfg.head_dim)) for c in charges)
    assert s_s.stats["prefill_tokens"] < s_d.stats["prefill_tokens"]
    assert eng.free_pages == eng.alloc.free_pages == 7


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_recurrent_state_swaps_across_slots(arch):
    """Recurrent rows (and recurrentgemma's ring frames) round-trip the
    host tier exactly when the block resumes on another slot, mid-decode:
    the tokens equal the uninterrupted decode and the reference's."""
    cfg, jp, tp = bridged(arch)
    prompt = torch.tensor([[3, 1, 4, 1], [0, 0, 0, 0]], dtype=torch.int32)

    def mk():
        eng = PagedEngine(cfg, tp, n_pages=17, page_size=8, max_seqs=2,
                          max_pages_per_seq=4, host_swap_pages=2 + 300,
                          device="cpu")
        blk = eng.alloc.alloc(0)
        first = eng.prefill_chunk(prompt, torch.tensor([4, 0],
                                                       dtype=torch.int32))
        eng.alloc.commit(blk, 4)
        return eng, blk, int(first[0])

    def steps(eng, slot, t, n):
        out = []
        for _ in range(n):
            toks = torch.zeros(2, dtype=torch.int32)
            toks[slot] = t
            mask = torch.arange(2) == slot
            t = int(eng.decode(toks, mask)[slot, 0].argmax())
            out.append(t)
        return out

    eng, _, t0 = mk()
    ref = [t0] + steps(eng, 0, t0, 6)
    eng, blk, t0 = mk()
    out = [t0] + steps(eng, 0, t0, 3)
    eng.alloc.commit(blk, 4 + 3)
    assert eng.alloc.swap_out(blk)
    img = eng.alloc.swap.images[blk.bid]
    assert img.charge == eng.aux_swap_pages + img.n_pages
    eng.alloc.swap_in(blk, 1)
    out += steps(eng, 1, out[-1], 3)
    assert out == ref == jax_greedy(cfg, jp, [3, 1, 4, 1], 7)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
#: 3 requests of 4 + 20 tokens, 2 slots, 5 pages of 8: one preemption
LAUNCH = ["--device", "cpu", "--requests", "3", "--prompt-len", "4",
          "--max-new", "20", "--batch-slots", "2", "--decode-horizon", "4",
          "--n-pages", "6", "--max-pages-per-seq", "4", "--no-prefix-cache"]


def test_launcher_host_swap_pages(capsys):
    """``--host-swap-pages`` reaches the allocator: the preempted request
    resumes from the host tier with the discard serve's tokens and fewer
    prefill tokens, and the launcher prints the swap traffic."""
    fin_d, eng_d, s_d = launch_serve.main(LAUNCH)
    fin_s, eng_s, s_s = launch_serve.main(LAUNCH + ["--host-swap-pages",
                                                    "16"])
    out = capsys.readouterr().out
    assert eng_d.alloc.swap is None and eng_s.alloc.swap.capacity_pages == 16
    assert eng_s.n_pages == 6 and eng_s.max_pages == 4
    assert {r.rid: r.out for r in fin_s} == {r.rid: r.out for r in fin_d}
    assert s_d.stats["preemptions"] == s_s.stats["swap_outs"] == 1
    assert s_s.stats["prefill_tokens"] < s_d.stats["prefill_tokens"]
    nbytes = eng_s.alloc.stats["swap_bytes_out"]
    assert nbytes == eng_s.alloc.stats["swap_bytes_in"] > 0
    assert (f"host swap tier: 16 pages; preemptions 1, swap-outs 1" in out
            and f"{nbytes} B" in out)
