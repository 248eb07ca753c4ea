"""Crash recovery on the port (``repro_torch/serve/recovery.py`` over the
port's checkpoint writer):

  * kill the engine mid-run, rebuild a FRESH one from the newest intact
    snapshot plus the telemetry journal (a request that arrived after the
    snapshot is replayed from its ``arrive`` event): the merged outputs
    equal the uninterrupted run and each request's ``jax_greedy`` — also
    when a snapshot leg is bit-flipped on disk (its checksum fails and
    that request re-prefills); the restarted run's trace replays clean;
  * the format: a port snapshot directory is read by the reference's
    ``latest_step``/``load_leaves``, and each live leg's image rebuilt by
    the reference passes the reference's ``BlockImage.verify``;
  * a snapshot skips a tick while a horizon is in flight (overlap)."""
import json

import numpy as np
import pytest

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro.checkpoint import checkpoint as jck
from repro.serve import recovery as jrec
from repro.serve import telemetry as jt
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.serve import telemetry as tt
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.recovery import ServeSnapshotter, recover_scheduler
from repro_torch.serve.scheduler import Scheduler


def _mk(telem=None, overlap=False):
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=33, page_size=8, max_seqs=3,
                      max_pages_per_seq=8, device="cpu")
    return eng, Scheduler(eng, prefill_chunk=8, decode_horizon=4,
                          telemetry=telem, overlap=overlap)


@pytest.fixture(scope="module")
def reqs():
    cfg, jp, _ = bridged("qwen3-0.6b")
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 10))).tolist(),
             int(rng.integers(8, 16))) for _ in range(5)]
    _, ref_s = _mk()
    for i, (p, m) in enumerate(reqs):
        ref_s.add_request(p, m, rid=i)
    ref = {r.rid: r.out for r in ref_s.run()}
    assert ref == {i: jax_greedy(cfg, jp, p, m)
                   for i, (p, m) in enumerate(reqs)}
    return reqs, ref


def _crash(reqs, directory):
    """Serve 4 requests for 6 ticks with a snapshot every 3, let a fifth
    arrive after the last snapshot, tick once more; return the journal."""
    telem = tt.Telemetry(trace=True)
    _, sched = _mk(telem)
    for i, (p, m) in enumerate(reqs[:4]):
        sched.add_request(p, m, rid=i)
    snap = ServeSnapshotter(sched, directory, every=3, keep=2)
    for _ in range(6):
        sched.step()
        snap.tick()
    assert snap.snapshots == 2
    sched.add_request(reqs[4][0], reqs[4][1], rid=4)
    sched.step()
    return list(telem.tracer.events)


@pytest.mark.parametrize("damage", [None, "bitflip"])
def test_crash_recovery_bit_exact(reqs, tmp_path, damage):
    reqs, ref = reqs
    journal = _crash(reqs, tmp_path)
    # -- crash: nothing below touches the first scheduler or its engine --
    step_dir = tmp_path / f"step_{latest_step(tmp_path)}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    kv = [e for e in manifest["leaves"] if "_k" in e["key"]]
    assert kv, "no live slot in the snapshot"
    if damage == "bitflip":
        path = step_dir / kv[0]["file"]
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0x01                          # payload, not the header
        path.write_bytes(bytes(raw))
    telem2 = tt.Telemetry(trace=True)
    eng2, s2 = _mk(telem2)
    finished = recover_scheduler(s2, tmp_path, journal=journal)
    queued = list(s2.queue)
    assert [r.rid for r in queued][-1] == 4      # replayed from the journal
    n_images = sum(r.image is not None for r in queued)
    assert n_images == len(kv) - (damage == "bitflip")
    out = dict(finished)
    out.update({r.rid: r.out for r in s2.run()})
    assert out == ref, "restart diverged from the uninterrupted run"
    assert s2.stats["image_imports"] == n_images
    assert eng2.pages_in_use == 0
    eng2.alloc.attach_tracer(None)
    summary = tt.check_trace(telem2.tracer.events)
    assert summary == jt.check_trace(telem2.tracer.events)
    assert summary["live_blocks"] == 0 and summary["images_in_flight"] == 0


def test_port_snapshots_read_by_the_reference(reqs, tmp_path):
    reqs, _ = reqs
    _crash(reqs, tmp_path)
    step = jck.latest_step(tmp_path)
    assert step == latest_step(tmp_path) == 6
    raw = jck.load_leaves(tmp_path, step)
    leaves = {jrec._leaf_name(k): v for k, v in raw.items()}
    meta = json.loads(bytes(leaves["snapmeta"].tobytes()).decode())
    live = [e for e in meta["requests"] if e["state"] == "slot"]
    assert live and meta["tick"] == 6
    for entry in live:
        img = jrec._rebuild_image(entry, leaves)
        assert img.verify(), entry["rid"]
        assert img.n_tokens <= len(img.tokens)
        assert img.k.shape[1] == img.n_pages


def test_snapshot_skips_an_in_flight_horizon(reqs, tmp_path):
    reqs, _ = reqs
    _, sched = _mk(overlap=True)
    for i, (p, m) in enumerate(reqs[:2]):
        sched.add_request(p, m, rid=i)
    snap = ServeSnapshotter(sched, tmp_path, every=1)
    sched.step()                                 # prefill
    sched.step()                                 # a horizon left in flight
    assert sched._pending is not None
    assert snap.tick() is False and snap.snapshots == 0
    sched.run()
    assert snap.tick() is True and latest_step(tmp_path) == 2
