#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. card   — name and power limit (nvidia-smi), TF32 off for matmuls and
              cuDNN so float32 stays float32;
  2. build  — compile the four sm_90a kernel libraries (paged attention,
              bit-plane transpose, SIMDRAM μProgram VM, bit-serial matmul)
              from the sources in this checkout, one nvcc each, all at once,
              and print ptxas' register/spill report;
  3. kernel — hold the paged-attention kernel against its plain twins on
              the test grid and at the main path's shape (lengths up to
              2,048), with the planned and forced page splits across
              blocks and 1, 3 or the planned warps per block; every launch
              twice, bit-equal; seq_len 0 gives zeros; ids outside the pool
              past seq_len never dereferenced.  Then time kernel, its
              simplest form, plain twin and a library yardstick with CUDA
              events beside the byte bound at seq_len 19, 256, 2,048 and
              mixed [19, 256, 2048, 0], with the split plan;
  4. serve  — full-width qwen3-0.6b (random weights from a seed) through
              ``repro_torch.launch.serve.main``: 6 requests, 4 slots, decode
              horizon 8, attention through the kernel.  Every request's
              tokens are held against the plain model's greedy decode on
              the card, the kernel's launch count against (full + ring
              layers) x token steps (28 x), and one decode horizon runs
              under ``torch.cuda.set_sync_debug_mode("error")``; then one
              horizon is timed on the host clock and its device-busy time
              read from the profiler's kernel events;
  5. transpose — the pack and unpack kernels bit-exact against their plain
              versions and numpy pack_np/unpack_np (n_bits 4/8/16/32 x
              1/31/256/1000/4133/2^20 elements, signed and unsigned, int32
              and int64 input, and int32 input 4 bytes off 16-byte
              alignment);
  6. vm     — the μProgram-VM kernel bit-exact against ``execute`` on the
              card (16 ops x n 8/16 x both styles, 2^16 elements) and the
              numpy ORACLES (16 ops at n=32 on 2^20 elements, each op's
              μOps, compiled MAJ instructions and row-file slots printed),
              across block sizes, and the quickstart's AOIG-defined op end
              to end;
  7. pipeline — bench_kernels' brightness kernel on 2^20 8-bit pixels:
              pack x3 -> add -> gt -> if_else -> unpack through the kernels,
              equal to np.minimum(img + 40, 127) & 0xFF, every launch
              bit-exact against its plain version on its own inputs; launch
              counts (pack 3, VM 3, unpack 1) and the ControlUnit's 16 Loop
              Counter trips per bbop checked; the device-busy time of one
              steady-state call, whose profiled launches must match the
              counts;
  8. timing — SIMDRAM kernels, plain versions and library yardsticks at
              2^20 and 2^26 elements beside their bounds (the VM's: the
              bytes of the planes it reads and writes, or one LOP3 per
              compiled MAJ per word); pack and unpack also beside one
              ``copy_`` of the bytes they move, with their tile and grid;
  9. bsmm   — the bit-serial matmul kernel (planes packed 1 bit per
              weight per plane) bit-exact against its plain version on the
              test grid, ragged and unaligned shapes, the decode batches
              M = 1 and 4, both main-path shapes and a split-K shape whose
              K is no multiple of S x 32; the card's dp4a rate measured
              by a probe kernel;
 10. qlm    — the bit-plane quantized LM at qwen2.5-3b's published widths
              (36 layers, random weights from seed 0) through
              ``repro_torch.examples.simdram_quantized_lm.main``: 108 FFN
              matrices as 8-bit planes, dense and bit-plane forwards on
              SyntheticLMData(4 x 32); 108 kernel launches per quantized
              forward, its logits equal to the same forward through the
              plain version, perplexities, drift (< 5%) and bytes (the
              packed planes as stored equal ``hbm_bytes`` less the scales);
              the device-busy time of each forward; kernel, plain version
              and ``torch._int_mm`` timed at both main-path shapes on six
              layers' matrices in turn (weights from device memory, as in
              the forward) beside the bound and the dp4a ceiling, with the
              split-K slices;
 11. hetero — the mixed stacks.  The kernel on ring-table rows at the ring
              pool's shapes (gemma3-12b: n_kv 8, g 2, d 256, 128-page
              rows; recurrentgemma-9b: n_kv 1, g 16, d 256, 256-page rows;
              mixtral-8x7b: n_kv 8, g 4, d 128, 512-page rows; empty,
              partly filled and full rings; 5 split plans, each twice and
              bit-equal) against both plain twins, then timed with every
              ring full.  gemma3-12b at its published config (48 layers:
              40 ring, window 1,024, 8 full) served as in phase 4 (launches
              48 x token steps, every request against the plain greedy
              decode, a sync-free horizon, one horizon timed and
              profiled); on the same weights one request of 1,016 + 16
              tokens whose decode crosses the window (its tokens against
              the plain decode, 128 ring frames per slot, the full
              layers' pages reaching 129); then recurrentgemma-9b and
              mamba2-1.3b at their published configs and mixtral-8x7b at
              full width cut to 2 layers, each served the same way
              against its plain greedy decode with a sync-free horizon.
              Each model is freed before the next loads.  The phase runs
              last, in a child process (``chip_smoke.py --hetero OUT``):
              before phase 7 it left the profiler losing launches of the
              brightness call;
 12. result — a JSON line per kernel, the card line, and the ok line last.

Needs one CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: fp32 kernel vs fp32 plain twin: same math, different summation order
#: (tiled online softmax vs one masked softmax), so agreement to a few ulps
#: of the O(1) outputs; 1e-5 absolute + 1e-5 relative holds that with room
ATOL = RTOL = 1e-5
#: reference top-two logit gap under which a greedy pick is a numerical tie
TIE_GAP = 1e-4
#: H100 SXM memory rate, float32 (non-tensor-core) and int8 tensor-core
#: peaks (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
#: dp4a per second assumed for the bit-serial kernel's dp4a ceiling: 64 per
#: SM per clock x 132 SMs x 1.98 GHz (the probe in ``[bsmm]`` measures it)
DP4A_PER_S = 64 * 132 * 1.98e9
#: the spin kernel that calls are timed behind: its least length and the
#: attempts, each with a quarter of the calls, before the timing gives up
SPIN_MIN_MS, SPIN_TRIES = 5.0, 8

SERVE_ARGV = ["--no-smoke", "--arch", "qwen3-0.6b", "--attn-impl", "kernel",
              "--requests", "6", "--max-new", "16", "--batch-slots", "4",
              "--prompt-len", "4", "--decode-horizon", "8",
              "--no-prefix-cache", "--device", "cuda"]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _time_ms(torch, fn, iters: int = 100, warmup: int = 10):
    """(device ms, call ms) of one ``fn()``, means over back-to-back calls
    after warm-up.  Call time: host clock around ``iters`` calls ending in
    a synchronize — what a caller waits, host overhead included.  Device
    time: CUDA events around calls queued behind a spin kernel that
    outlasts their enqueue, so they run back to back on the card and the
    host's share drops out.  The spin must still be running when the last
    call is queued (a full launch queue would block the host and let gaps
    in); otherwise the count is cut and the measurement repeated, up to
    ``SPIN_TRIES`` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event()
    n = iters
    for _ in range(SPIN_TRIES):
        # ~2 GHz SM clock: spin for twice the host time of n calls, and
        # at least SPIN_MIN_MS, so that a pause of the host while it
        # queues a few short calls does not outlast the spin
        spin_ms = min(max(2 * call_ms * n, SPIN_MIN_MS), 4000)
        torch.cuda._sleep(int(spin_ms * 2e6))
        spun.record()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        clean = not spun.query()
        stop.synchronize()
        if clean:
            return start.elapsed_time(stop) / n, call_ms
        n = max(1, n // 4)
    _fail("could not queue even one call behind the spin kernel")


def _kernel_busy(torch, fn):
    """(device-busy ms, [(kernel name, launches, ms)] by device time) of
    one ``fn()`` from the profiler's CUDA kernel events; (None, []) if it
    saw none.  A first ``fn()`` runs in the profiler's warm-up step and is
    not read: the tracer misses the first launches of the step it starts
    in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the step marker is an annotation on the device timeline, not a kernel
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None, []
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return busy_us / 1e3, [(e.key, e.count, e.self_device_time_total / 1e3)
                           for e in kernels]


def _pool(torch, gen, S, n_kv, g, d, ps, n_pages, width, seq_lens, dev):
    """Random paged-attention inputs: distinct non-null pages per row (and
    across rows where the pool holds them all, so that every row's K/V
    bytes are its own), a table wider than ``max_pages`` (so the row
    stride matters)."""
    q = torch.randn((S, n_kv, g, d), generator=gen, device=dev) / math.sqrt(d)
    k = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
    if S * width <= n_pages - 1:
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        pt = perm[:S * width].view(S, width).to(torch.int32)
    else:
        pt = torch.stack([
            torch.randperm(n_pages - 1, generator=gen, device=dev)[:width] + 1
            for _ in range(S)]).to(torch.int32)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, k, v, pt, lens


#: the serve's attention shape (4 slots, 8 kv heads, g 2, d 128, pages of
#: 8) with its 32-page rows, and with 256-page rows for 2,048 tokens:
#: (seq_lens, max_pages, pages in the pool)
PA_MAIN = [([0, 1, 7, 8], 32, 129), ([9, 255, 256, 17], 32, 129),
           ([19, 2048, 0, 700], 256, 4 * 258 + 1)]
#: timed: (label, seq_lens, max_pages, pool pages); 19 is the serve's
#: length after its last token, 2,048 a long context
PA_TIMED = [("19", [19] * 4, 32, 129), ("256", [256] * 4, 32, 129),
            ("2048", [2048] * 4, 256, 4 * 258 + 1),
            ("mixed", [19, 256, 2048, 0], 256, 4 * 258 + 1)]


def phase_kernel(torch, pa, ops, batched, dev):
    """Kernel vs plain twins on the test grid (warps per block and forced
    page splits crossed) and at the main path's shape up to 2,048 tokens;
    seq_len 0 gives zeros, two calls are bit-equal, the split counters end
    at 0, and pages past seq_len are never dereferenced."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    cases = []
    for n_kv, g in ((2, 3), (1, 4), (4, 1), (2, 2)):
        for d in (8, 16):
            for ps in (2, 4):
                cases.append((n_kv, g, d, ps, 12, 8, [0, 1, 5, 16, 31]))
    cases += [(8, 2, 128, 8, n_pages, max_pages, lens)
              for lens, max_pages, n_pages in PA_MAIN]
    n_checked = 0
    for n_kv, g, d, ps, n_pages, max_pages, lens in cases:
        width = min(max_pages + 2, n_pages - 1)
        q, k, v, pt, ln = _pool(torch, gen, len(lens), n_kv, g, d, ps,
                                n_pages, width, lens, dev)
        refs = (("ref_paged_attention", ops._plain(q, k, v, pt, ln,
                                                   max_pages)),
                ("batched_paged_attention", batched(q, k, v, pt, ln,
                                                    max_pages)))
        # the planned launch, one warp per block, an odd warp count, each
        # with the planned and with forced page splits (2 and 5 blocks
        # reach the merge; 1 is the simplest form of the kernel)
        for splits, blocks in itertools.product((None, 1, 3),
                                                (None, 1, 2, 5)):
            got = pa(q, k, v, pt, ln, max_pages, splits=splits,
                     blocks=blocks)
            again = pa(q, k, v, pt, ln, max_pages, splits=splits,
                       blocks=blocks)
            torch.cuda.synchronize()
            for name, ref in refs:
                err = (got - ref).abs().max().item()
                ok = torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                if not ok or not torch.isfinite(got).all():
                    _fail(f"kernel (splits={splits}, blocks={blocks}) vs "
                          f"{name} at n_kv={n_kv} g={g} d={d} ps={ps} "
                          f"max_pages={max_pages} seq_lens={lens}: max abs "
                          f"err {err:.3e}")
                worst = max(worst, err)
            if not torch.equal(got, again):
                _fail(f"two calls (splits={splits}, blocks={blocks}) at "
                      f"seq_lens={lens} differ")
            zero = got[[i for i, x in enumerate(lens) if x == 0]]
            if zero.numel() and zero.abs().max().item() != 0.0:
                _fail("seq_len 0 must give zeros")
            n_checked += 1
    if any(c.any().item() for _, c in ops._scratch.values()):
        _fail("a split launch left its ticket counters off 0")
    # junk past seq_len (null page included) must not change the output
    q, k, v, pt, ln = _pool(torch, gen, 1, 1, 2, 16, 2, 6, 4, [3], dev)
    pt2 = pt.clone()
    pt2[0, 2:] = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    if not torch.equal(pa(q, k, v, pt, ln, 4), pa(q, k, v, pt2, ln, 4)):
        _fail("kernel output depends on pages past seq_len")
    # ids outside the pool past seq_len must never be dereferenced
    lens, max_pages, n_pages = PA_MAIN[-1]
    q, k, v, pt, ln = _pool(torch, gen, 4, 8, 2, 128, 8, n_pages,
                            max_pages + 2, lens, dev)
    bad = pt.clone()
    for s, n in enumerate(lens):
        used = -(-n // 8)
        bad[s, used:] = torch.where(
            torch.arange(bad.shape[1] - used, device=dev) % 2 == 0, -1,
            n_pages + 1000).to(torch.int32)
    for blocks in (None, 1, 3):
        want = pa(q, k, v, pt, ln, max_pages, blocks=blocks)
        got = pa(q, k, v, bad, ln, max_pages, blocks=blocks)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"out-of-range page ids past seq_len changed the output "
                  f"(blocks={blocks})")
    print(f"[kernel] {len(cases)} grid/main-path cases x 12 (splits x "
          f"blocks) = {n_checked} launches, each twice and bit-equal; "
          f"kernel == plain twins within atol={ATOL} rtol={RTOL} (fp32, "
          f"different summation order); max abs err {worst:.3e}; "
          f"garbage and out-of-range pages past seq_len ignored; split "
          f"counters back at 0")
    return worst


def phase_timing(torch, F, pa, ops, batched, dev, label, lens, max_pages,
                 n_pages, shape=(8, 2, 128, 8), table=None):
    """Time kernel, its simplest form (one block, one warp), plain twin and
    the library yardstick at a decode shape (``shape`` = (n_kv, g, d, ps);
    by default the serve's: 4 slots, 8 kv heads, g=2, d=128, ps=8) at these
    lengths; print the plan.  ``table``: page rows to read (the ring pool's
    static table) in place of random distinct pages."""
    S = len(lens)
    n_kv, g, d, ps = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    q, k, v, pt, ln = _pool(torch, gen, S, n_kv, g, d, ps, n_pages,
                            max_pages, lens, dev)
    if table is not None:
        pt = table
    n_tok = [min(int(x), max_pages * ps) for x in lens]
    ms, call_ms = _time_ms(torch, lambda: pa(q, k, v, pt, ln, max_pages))
    one_ms, _ = _time_ms(torch, lambda: pa(q, k, v, pt, ln, max_pages,
                                           blocks=1, splits=1))
    plain_ms, plain_call = _time_ms(
        torch, lambda: batched(q, k, v, pt, ln, max_pages))

    def library():
        # yardstick only: gather the pages, then one SDPA call
        idx = pt[:, :max_pages].long()
        kk = k[idx].reshape(S, max_pages * ps, n_kv, d).transpose(1, 2)
        vv = v[idx].reshape(S, max_pages * ps, n_kv, d).transpose(1, 2)
        mask = (torch.arange(max_pages * ps, device=dev)[None]
                < ln[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                              scale=1.0)
    library_ms, library_call = _time_ms(torch, library)
    n_bytes = sum(2 * t * n_kv * d * 4 + 4 * -(-t // ps) for t in n_tok)
    n_bytes += 2 * q.numel() * 4 + S * 4               # q, out, seq_lens
    flops = sum(4 * t * n_kv * g * d for t in n_tok)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    n_sm = ops._sm_count(dev.index)
    cols = n_kv * ops.rows_per_block(g, d)[1]       # blocks share a kv head
    P = ops.split_plan(S, cols, max_pages, ps, n_sm)
    warps = ops.default_warps(max_pages, ps, d, P)
    used = [ops.blocks_used(t, P, max_pages, ps, d) for t in n_tok]
    # the kernel streams K/V past L1 once its working blocks fill the SMs
    loads = "streaming" if cols * sum(used) >= n_sm else "L1-allocating"
    print(f"[kernel] {_shape_label(shape)} seq_len {label} {lens}, device ms "
          f"per call: kernel "
          f"{ms:.5f} (one block of one warp per (kv head, slot): "
          f"{one_ms:.5f}), plain twin {plain_ms:.5f}, gather+SDPA "
          f"{library_ms:.5f}; bound {bound_ms:.6f} ({bound_by}: {n_bytes} "
          f"B, {flops} flop); plan: P {P} blocks of {warps} warps per (kv "
          f"head and row group, slot), blocks with work per slot {used} "
          f"({cols * sum(used)} of {S * cols * P}; {loads} loads on {n_sm} "
          f"SMs); host clock per "
          f"call incl. launch overhead: "
          f"kernel {call_ms:.5f}, plain {plain_call:.5f}, gather+SDPA "
          f"{library_call:.5f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _shape_label(shape):
    n_kv, g, d, ps = shape
    return f"n_kv {n_kv} g {g} d {d} ps {ps}"


def _reference_tokens(torch, tm, cfg, params, req, dev):
    """Greedy decode of one request through the plain model on the card.
    Returns (tokens compared, tie gap or None)."""
    max_len = len(req.prompt) + req.max_new
    toks = torch.tensor([req.prompt], dtype=torch.long, device=dev)
    logits, caches = tm.prefill(cfg, params, {"tokens": toks}, max_len)
    pos = len(req.prompt)
    for i in range(req.max_new):
        top2 = torch.topk(logits[0, 0], 2)
        gap = (top2.values[0] - top2.values[1]).item()
        if gap < TIE_GAP:
            return i, gap
        if int(top2.indices[0]) != req.out[i]:
            _fail(f"request {req.rid} token {i}: served {req.out[i]}, "
                  f"reference {int(top2.indices[0])} (gap {gap:.3e})")
        if i + 1 < req.max_new:
            nxt = torch.tensor([[req.out[i]]], dtype=torch.long, device=dev)
            logits, caches = tm.decode_step(cfg, params, caches, nxt, pos)
            pos += 1
    return req.max_new, None


def phase_serve(torch, pa, card, run, tag="serve"):
    """One serve through a user's entry point: ``run()`` returns
    ``(finished, engine)``.  The kernel's count is set to 0 just before it
    and read just after; it must equal (full + ring layers) x token steps.
    Every request's tokens are held against the plain model's greedy
    decode on the card."""
    from repro_torch.models import model as tm

    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    finished, engine = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    peak = torch.cuda.max_memory_allocated()
    cfg, dev = engine.cfg, engine.device
    steps = engine.stats["token_steps"]
    n_attn = engine.geom.n_full + engine.geom.n_ring
    if launches != n_attn * steps or (n_attn and launches == 0):
        _fail(f"[{tag}] {cfg.name}: kernel launches {launches} != "
              f"{n_attn} full + ring layers x {steps} token steps")
    print(f"[{tag}] {cfg.name}: kernel launches {launches} = {n_attn} full "
          f"+ ring layers x {steps} token steps (engine stats "
          f"{engine.stats})")
    if len(finished) != 6 or any(len(r.out) != 16 for r in finished):
        _fail(f"[{tag}] expected 6 finished requests of 16 tokens")
    t1 = time.perf_counter()
    for r in sorted(finished, key=lambda r: r.rid):
        n, gap = _reference_tokens(torch, tm, cfg, engine.params, r, dev)
        tail = ("" if gap is None else
                f"; stopped at token {n}: reference top-two gap {gap:.3e} "
                f"< {TIE_GAP}")
        print(f"[{tag}] req {r.rid}: {n}/{len(r.out)} tokens equal to the "
              f"plain greedy reference{tail}")
    n_out = sum(len(r.out) for r in finished)
    print(f"[{tag}] {card}: {cfg.name}: {len(finished)} requests, {n_out} "
          f"tokens in {wall:.3f} s wall ({n_out / wall:.1f} tok/s, params "
          f"init and kernel load included); max_memory_allocated {peak} B; "
          f"plain reference decode {time.perf_counter() - t1:.1f} s")
    return launches, engine


def phase_sync_free(torch, engine, card):
    """One fused horizon dispatched with every host sync turned into an
    error: the decode path must enqueue work only.  Then one horizon timed
    on the host clock and its device-busy time read from the profiler.
    Frees the slots it took."""
    S, dev, k = engine.max_seqs, engine.device, 8
    name = engine.cfg.name
    for s in range(S):
        blk = engine.alloc.alloc(s)
        engine.alloc.reserve_span(blk, 4, k)
    prompt = torch.arange(1, 5, dtype=torch.int32, device=dev)
    engine.prefill_chunk(prompt.repeat(S, 1),
                         torch.full((S,), 4, dtype=torch.int32, device=dev))
    toks = torch.full((S,), 7, dtype=torch.int32, device=dev)
    mask = torch.ones((S,), dtype=torch.bool, device=dev)
    steps = torch.full((S,), k, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        block = engine.decode_many(toks, mask, steps, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    block = block.cpu()
    if block.shape != (k, S) or bool((block < 0).any()):
        _fail(f"{name}: sync-free horizon returned {block.tolist()}")
    print(f"[sync] {name}: decode_many(K={k}) over {S} slots under "
          f"set_sync_debug_mode('error'): no host sync; block "
          f"{tuple(block.shape)}")
    # steady-state cost of one horizon (4 more; the slots grow to 44
    # tokens, 6 pages each, well inside the pool): host clock, then the
    # device-busy share from the profiler's kernel events
    def horizon():
        return engine.decode_many(toks, mask, steps, k)

    horizon()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    horizon()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels = _kernel_busy(torch, horizon)
    geom = engine.geom
    print(f"[horizon] {card}: {name}: decode_many(K={k}) over {S} slots, "
          f"{len(geom.kinds)} layers ({geom.n_full} full, {geom.n_ring} "
          f"ring, {geom.n_rg} RG-LRU, {geom.n_ssm} SSM): {call_ms:.3f} ms "
          f"on the host clock ({call_ms / k:.3f} ms per token step)")
    if busy_ms is None:
        print("[horizon] device-busy time: not measured (the profiler saw "
              "no CUDA kernel events)")
    else:
        n_kernels = sum(c for _, c, _ in kernels)
        top = [(kname[:60], c, ms) for kname, c, ms in kernels[:5]]
        attn = [(c, ms) for kname, c, ms in kernels if "paged_attn" in kname]
        print(f"[horizon] {name}: profiled call: {n_kernels} kernels "
              f"({n_kernels / k:.0f} per token step), device busy "
              f"{busy_ms:.3f} ms, so the device idles "
              f"{1 - busy_ms / call_ms:.1%} of the unprofiled call; top "
              f"kernels by device time (name, count, ms): {top}; paged "
              f"attention (launches, ms): {attn}")
    for blk in list(engine.alloc.blocks.values()):
        engine.alloc.free(blk)


# -- the mixed stacks: ring pool, recurrent state, MoE -----------------------
#: the ring pool's kernel shapes at the launcher's page size of 8
#: (configs/*.py): (label, (n_kv, g, d, ps), ring pages = window / 8)
RING_SHAPES = [("gemma3-12b", (8, 2, 256, 8), 128),
               ("recurrentgemma-9b", (1, 16, 256, 8), 256),
               ("mixtral-8x7b", (8, 4, 128, 8), 512)]
#: the full-width serves of the phase (the qwen3 serve's settings)
HETERO_ARGV = ["--no-smoke", "--attn-impl", "kernel", "--requests", "6",
               "--max-new", "16", "--batch-slots", "4", "--prompt-len", "4",
               "--decode-horizon", "8", "--no-prefix-cache", "--device",
               "cuda"]
#: the ring-wrap request: 1,016 prompt + 16 new tokens cross gemma3-12b's
#: window of 1,024 during decode
WRAP_PROMPT, WRAP_NEW = 1016, 16


def phase_ring_kernel(torch, F, pa, ops, batched, dev):
    """The kernel on ring-table rows (static, contiguous: slot s reads
    pages 1 + s * ring_pages ..) at the ring pool's three shapes, lengths
    0, 1, a partly filled ring and a full ring, planned and forced splits,
    each launch twice and bit-equal, against both plain twins; then timed
    at 4 slots with every ring full."""
    from repro_torch.core.vbi.kvcache import make_ring_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst, rows = 0.0, {}
    for label, shape, rp in RING_SHAPES:
        n_kv, g, d, ps = shape
        W, S = rp * ps, 4
        n_pages = 1 + S * rp
        table = torch.from_numpy(make_ring_table(S, rp)).to(dev)
        lens = [0, 1, W // 2 + 3, W]
        q, k, v, _, ln = _pool(torch, gen, S, n_kv, g, d, ps, n_pages, rp,
                               lens, dev)
        refs = (("ref_paged_attention", ops._plain(q, k, v, table, ln, rp)),
                ("batched_paged_attention", batched(q, k, v, table, ln, rp)))
        for splits, blocks in ((None, None), (1, 1), (None, 3), (5, 8),
                               (16, None)):
            got = pa(q, k, v, table, ln, rp, splits=splits, blocks=blocks)
            again = pa(q, k, v, table, ln, rp, splits=splits, blocks=blocks)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                _fail(f"ring {label}: two calls (splits={splits}, blocks="
                      f"{blocks}) differ")
            for name, ref in refs:
                err = (got - ref).abs().max().item()
                if (not torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                        or not torch.isfinite(got).all()):
                    _fail(f"ring {label} {_shape_label(shape)}, {rp}-page "
                          f"rows, seq_lens {lens} (splits={splits}, blocks="
                          f"{blocks}) vs {name}: max abs err {err:.3e}")
                worst = max(worst, err)
            if got[0].abs().max().item() != 0.0:
                _fail(f"ring {label}: seq_len 0 must give zeros")
        print(f"[hetero] ring kernel {label}: {_shape_label(shape)}, "
              f"{rp}-page rows (window {W}), seq_lens {lens}, 5 split "
              f"plans, each twice and bit-equal; == both plain twins "
              f"within atol={ATOL} rtol={RTOL}")
        rows[label] = phase_timing(torch, F, pa, ops, batched, dev,
                                   f"ring full ({label})", [W] * S, rp,
                                   n_pages, shape=shape, table=table)
        rows[label].update(shape=shape, ring_pages=rp)
        del q, k, v, table, refs
    print(f"[hetero] ring kernel: max abs err {worst:.3e}")
    return worst, rows


def phase_ring_wrap(torch, pa, card, cfg, params):
    """One request of 1,016 prompt + 16 new tokens through PagedEngine +
    Scheduler on a pool sized for it: its decode crosses the 1,024-token
    window.  Tokens against the plain greedy decode; the ring keeps its
    128 frames per slot while the full layers' pages grow to 129."""
    import numpy as np

    from repro_torch.models import model as tm
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.scheduler import Scheduler

    dev, ps = params["embed"].device, 8
    lifetime = WRAP_PROMPT + WRAP_NEW
    pages = -(-lifetime // ps) + 1
    eng = PagedEngine(cfg, params, n_pages=1 + pages, page_size=ps,
                      max_seqs=1, max_pages_per_seq=pages, device=dev)
    sched = Scheduler(eng, prefill_chunk=64, decode_horizon=8)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, WRAP_PROMPT).tolist()
    sched.add_request(prompt, max_new=WRAP_NEW)
    seen = []
    decode_many = eng.decode_many

    def probed(*args):
        # after each horizon: the pool pages in use (one device read)
        block = decode_many(*args)
        seen.append(eng.pages_in_use)
        return block

    eng.decode_many = probed
    pa.launches = 0
    t0 = time.perf_counter()
    finished = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = pa.launches, eng.stats["token_steps"]
    geom = eng.geom
    n_attn = geom.n_full + geom.n_ring
    if launches != n_attn * steps:
        _fail(f"ring wrap: launches {launches} != {n_attn} x {steps}")
    want_pages = -(-(lifetime - 1) // ps)      # the last token is not fed
    if max(seen) != want_pages:
        _fail(f"ring wrap: full layers' pages peaked at {max(seen)}, "
              f"want {want_pages}")
    if not WRAP_PROMPT < geom.window < lifetime - 1:
        _fail(f"ring wrap: the decode does not cross the window "
              f"{geom.window}")
    if (geom.ring_pages != geom.window // ps
            or eng.state.k_ring.shape[1] != 1 + geom.ring_pages):
        _fail(f"ring wrap: ring of {geom.ring_pages} frames, pool "
              f"{tuple(eng.state.k_ring.shape)}")
    (req,) = finished
    t1 = time.perf_counter()
    n, gap = _reference_tokens(torch, tm, cfg, params, req, dev)
    tail = ("" if gap is None else f" (stopped at a tie, gap {gap:.3e})")
    print(f"[hetero] {card}: ring wrap {cfg.name}: {WRAP_PROMPT} prompt + "
          f"{WRAP_NEW} new tokens (positions {WRAP_PROMPT}..{lifetime - 2} "
          f"decoded across the window of {geom.window}), {steps} token "
          f"steps in {wall:.3f} s wall ({wall / steps * 1e3:.2f} ms per "
          f"step); kernel launches {launches} = {n_attn} x {steps}; full "
          f"layers' pages per horizon {seen}; ring {geom.ring_pages} frames "
          f"per slot, k_ring {tuple(eng.state.k_ring.shape)}; {n}/"
          f"{len(req.out)} tokens equal to the plain greedy reference{tail} "
          f"({time.perf_counter() - t1:.1f} s)")
    return launches


def _free(torch):
    """Give a dropped model's device memory back before the next loads: an
    engine and its allocator refer to each other, so only the cycle
    collector frees them."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


#: phase 11's child process: its time limit, and where it leaves its
#: result for the parent (inside the checkout's ignored build directory)
HETERO_TIMEOUT_S = 900
HETERO_RESULT = Path(__file__).resolve().parent / "build" / "hetero.json"


def run_hetero():
    """Phase 11 in a process of its own, after every other phase: run
    before phase 7, in this process or in a child, it left the profiler
    of this process losing launches of the brightness call (the first 6
    of its 8 in one run, all of them in the next two), while the same
    phases without it, a fresh process and one idle for 200 s saw all 8.
    In a child, its tens of gigabytes and millions of launches end with
    the child.  The child's lines go to the same output; it is waited
    for, and killed at its time limit.  Returns (max abs err at the ring
    shapes, ring timing rows, kernel launches by path)."""
    HETERO_RESULT.parent.mkdir(exist_ok=True)
    HETERO_RESULT.unlink(missing_ok=True)
    sys.stdout.flush()
    try:
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--hetero", str(HETERO_RESULT)],
                            timeout=HETERO_TIMEOUT_S).returncode
    except subprocess.TimeoutExpired:
        _fail(f"[hetero] did not end within {HETERO_TIMEOUT_S} s")
    if rc != 0:
        _fail(f"[hetero] exited with code {rc}")
    res = json.loads(HETERO_RESULT.read_text())
    return res["ring_err"], res["ring_rows"], res["launches"]


def hetero_main(out: str) -> int:
    """The child of :func:`run_hetero` (``chip_smoke.py --hetero OUT``):
    phase 11 on the card, its result as JSON in ``OUT``."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serve.engine import batched_paged_attention

    dev, card = _setup_card(torch)
    ring_err, ring_rows, launches = phase_hetero(
        torch, F, ops.paged_attention, ops, batched_paged_attention, dev,
        card)
    Path(out).write_text(json.dumps({"ring_err": ring_err,
                                     "ring_rows": ring_rows,
                                     "launches": launches}))
    return 0


def _setup_card(torch):
    """The card this script runs on, with TF32 off for matmuls and cuDNN so
    float32 stays float32: (device, nvidia-smi's name and power limit)."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev, smi[0].strip()


def phase_hetero(torch, F, pa, ops, batched, dev, card):
    """The mixed stacks on the card: the kernel at the ring shapes;
    gemma3-12b at its published config served, sync-free and timed; the
    ring wrapping on a 1,032-token request; recurrentgemma-9b and
    mamba2-1.3b at their published configs and mixtral-8x7b at full width
    cut to 2 layers, each against its plain greedy decode."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import model as tm

    t0 = time.perf_counter()
    ring_err, ring_rows = phase_ring_kernel(torch, F, pa, ops, batched, dev)
    print(f"[hetero] ring kernel part: {time.perf_counter() - t0:.1f} s")
    launches = {}

    for arch in ("gemma3-12b", "recurrentgemma-9b", "mamba2-1.3b",
                 "mixtral-8x7b"):
        t0 = time.perf_counter()
        if arch == "mixtral-8x7b":
            # full width; 2 of 32 layers (46.7 G params in float32 do not
            # fit one card); the launcher has no depth flag
            cfg = dataclasses.replace(serve.serve_config(arch, smoke=False),
                                      n_layers=2)
            params = tm.init_params(cfg, seed=0, device=dev)
            launches[arch], engine = phase_serve(
                torch, pa, card,
                lambda: serve.serve(cfg, params, device=dev), "hetero")
            del params
        else:
            launches[arch], engine = phase_serve(
                torch, pa, card,
                lambda: serve.main(HETERO_ARGV + ["--arch", arch]), "hetero")
        phase_sync_free(torch, engine, card)
        if arch == "gemma3-12b":
            cfg, params = engine.cfg, engine.params
            del engine
            _free(torch)
            launches["ring wrap"] = phase_ring_wrap(torch, pa, card, cfg,
                                                    params)
            del params
        else:
            del engine
        _free(torch)
        print(f"[hetero] {arch}: {time.perf_counter() - t0:.1f} s")
    return ring_err, ring_rows, launches


# -- SIMDRAM: transposition unit, μProgram VM, the brightness pipeline -------
#: int32 non-tensor-core peak: 64 INT32 lanes per SM against the 128 FP32
#: lanes (2 flops per FMA) behind the 67 TFLOP/s FP32 figure, i.e. a
#: quarter of it (NVIDIA Hopper architecture white paper, SM diagram)
INT32_OPS_PER_S = FP32_FLOP_PER_S / 4
BRIGHT_DELTA, BRIGHT_CLIP = 40, 127
#: elements: the repo's benchmark size (bench_throughput.py, bench_kernels.py;
#: 16 rows of 65,536 lanes), the size of the execute cross-check, and the
#: second timing size (1,024 rows, 256 MiB per 32-bit operand)
FULL, CHECK, LARGE = 1 << 20, 1 << 16, 1 << 26


def _p2(n):
    return f"2^{n.bit_length() - 1}"


def _exact(what, got, ref):
    """Bit-exact agreement of two integer tensors; returns the max abs
    difference of their values (0 or the phase fails)."""
    if got.shape != ref.shape:
        _fail(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = (got.long() - ref.long()).abs().max().item() if got.numel() else 0
    if err != 0:
        _fail(f"{what}: kernel disagrees with its reference (max abs "
              f"difference {err})")
    return float(err)


def _ints(np, n_bits, n, seed):
    rng = np.random.default_rng(seed)
    lo = -(1 << (n_bits - 1))
    return rng.integers(lo, -lo, n)


def phase_transpose(torch, np, tt, tbp, dev):
    """Pack and unpack kernels against the plain versions and numpy, on the
    reference test grid plus 2^20 elements, ragged tails included."""
    worst, cases = 0.0, 0
    for n_bits in (4, 8, 16, 32):
        for n_elems in (1, 31, 256, 1000, 4133, FULL):
            x = _ints(np, n_bits, n_elems, n_bits * 1000 + n_elems)
            for signed in (True, False):
                ref_np = tbp.pack_np(x, n_bits, signed, device="cpu")
                ref_back = tbp.unpack_np(ref_np)
                # unsigned, the round trip gives the low n_bits back
                want = x if signed or n_bits == 32 else x & ((1 << n_bits) - 1)
                for dtype in (torch.int32, torch.int64, "x[1:]"):
                    if dtype == "x[1:]":     # 4 bytes off 16-byte alignment
                        xc = torch.from_numpy(np.concatenate(
                            [[0], x]).astype(np.int32)).to(dev)[1:]
                    else:
                        xc = torch.from_numpy(x).to(dtype).to(dev)
                    bp = tt.to_bitplanes(xc, n_bits, signed)
                    what = (f"pack n_bits={n_bits} n_elems={n_elems} "
                            f"signed={signed} {dtype}")
                    worst = max(worst, _exact(what, bp.planes, tbp.pack(
                        xc, n_bits, signed).planes))
                    if not np.array_equal(bp.to_numpy(), ref_np.to_numpy()):
                        _fail(f"{what}: kernel != pack_np")
                    back = tt.from_bitplanes(bp)
                    what = "un" + what
                    worst = max(worst, _exact(what, back, tbp.unpack(bp)))
                    # as 32-bit patterns: int32 cannot hold an unsigned
                    # 32-bit value, which unpack_np gives as int64
                    if not np.array_equal(back.cpu().numpy().view(np.uint32),
                                          ref_back.astype(np.uint32)):
                        _fail(f"{what}: kernel != unpack_np")
                    _exact(f"round trip {what}", back.long(),
                           torch.from_numpy(want).to(dev))
                    cases += 1
    print(f"[transpose] {cases} cases (n_bits 4/8/16/32 x n_elems "
          f"1/31/256/1000/4133/{_p2(FULL)} x signed/unsigned x int32/int64/"
          f"int32 4 bytes off 16-byte alignment input): pack and unpack "
          f"kernels == plain versions == pack_np/unpack_np, round trip "
          f"exact")
    return worst


def _op_inputs(np, op, n, size, seed):
    from repro_torch.core import OPS
    spec = OPS[op]
    rng = np.random.default_rng(seed)
    if n == 32:                 # bench_throughput.py's operands
        a = rng.integers(-2**30, 2**30, size)
        b = rng.integers(1, 2**30, size)
        s = rng.integers(0, 2, size)
        return {1: [a], 2: [a, b], 3: [s, a, b]}[spec.n_inputs]
    ins = [_ints(np, n, size, seed + k) for k in range(spec.n_inputs)]
    if spec.n_inputs == 3:
        ins[0] = rng.integers(0, 2, size)
    return ins


def phase_vm(torch, np, tt, vm, tc, dev):
    """VM kernel against ``execute`` on the card (16 ops, n 8/16, both
    styles, 2^16 elements), against the numpy ORACLES at n=32 on 2^20
    elements, across block sizes, and the quickstart op."""
    worst, t0 = 0.0, time.perf_counter()
    for style in ("simdram", "ambit"):
        for n in (8, 16):
            for op in tc.PAPER_16:
                spec = tc.OPS[op]
                bps = [tc.pack_np(x, n, device=dev) for x in
                       _op_inputs(np, op, n, CHECK, n)]
                got = tc.apply_op(op, *bps, style=style)
                prog = tc.get_uprogram(op, n, style)
                ref = tc.execute(prog, dict(zip(
                    spec.input_names, [bp.planes for bp in bps])),
                    bps[0].n_words, out_bits=spec.out_bits(n))
                worst = max(worst, _exact(f"vm {op} n={n} {style}",
                                          got.planes, ref))
    print(f"[vm] 16 ops x n 8/16 x simdram/ambit on {_p2(CHECK)} elements: VM "
          f"kernel == execute on the card ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n, size = 32, FULL
    counts, compile_ms = [], {}
    for op in tc.PAPER_16:
        spec = tc.OPS[op]
        prog = tc.get_uprogram(op, n)
        t1 = time.perf_counter()     # first use: lower and compile
        cp, _ = vm.compiled(prog, spec.input_names, [n] * spec.n_inputs,
                            spec.out_bits(n))
        compile_ms[op] = (time.perf_counter() - t1) * 1e3
        counts.append(f"{op} {len(prog.flatten())}/{cp.n_maj}/{cp.n_slots}")
        ins = _op_inputs(np, op, n, size, 1)
        bps = [tt.to_bitplanes(torch.from_numpy(x).to(dev), n) for x in ins]
        out = tc.apply_op(op, *bps)
        bits = out.n_bits
        got = tt.from_bitplanes(tc.BitPlaneArray(out.planes, size, False))
        got = got.cpu().numpy().view(np.uint32).astype(np.uint64)
        ref = np.asarray(tc.ORACLES[op](*ins, n), np.uint64)
        ref &= np.uint64((1 << bits) - 1)
        if not np.array_equal(got, ref):
            bad = int(np.flatnonzero(got != ref)[0])
            _fail(f"vm {op} n=32 on {_p2(size)} elements: element {bad} is "
                  f"{got[bad]}, oracle {ref[bad]}")
    print(f"[vm] 16 ops at n=32 on {_p2(size)} elements (mul, div "
          f"included): VM "
          f"kernel == numpy ORACLES over every element "
          f"({time.perf_counter() - t0:.1f} s); μOps/compiled MAJ/slots: "
          f"{', '.join(counts)}; host compile (lower + compile_lowered): "
          f"div {compile_ms['div']:.1f} ms, mul {compile_ms['mul']:.1f} ms, "
          f"all 16 {sum(compile_ms.values()):.1f} ms")
    for op in ("add", "mul", "div"):
        bps = [tt.to_bitplanes(torch.from_numpy(x).to(dev), 32)
               for x in _op_inputs(np, op, 32, size, 2)]
        outs = [vm.simdram_op(op, *bps, block_words=bw).planes
                for bw in (32, 128, 1024)]
        for bw, o in zip((128, 1024), outs[1:]):
            _exact(f"vm {op} block_words {bw} vs 32", o, outs[0])
    print("[vm] add/mul/div at n=32: block_words 32, 128 and 1024 give the "
          "same planes")
    from repro_torch.examples import quickstart
    res = quickstart.main(device=dev)
    A, B, M = res["inputs"]
    if not np.array_equal(res["xor_mask"], (A ^ B) & M):
        _fail("quickstart xor_mask on the card")
    print(f"[vm] quickstart xor_mask (AOIG {res['naive_size']} -> MIG "
          f"{res['mig_size']} MAJ, depth {res['mig_depth']}, "
          f"{len(res['uops'])} uops per bit) through pack -> VM -> unpack "
          f"on the card == (A ^ B) & M")
    return worst


def phase_pipeline(torch, np, tt, vm, tc, tbp, dev, card):
    """bench_kernels' brightness kernel on 2^20 8-bit pixels through the
    kernels: pack -> add -> gt -> if_else -> unpack.  In 8-bit two's
    complement img + 40 passes 127 exactly when the sum reads negative
    (img < 216), so gt(0, sum) is the clip predicate; it is widened to 8
    planes with zero planes, since apply_op takes operands of one width.
    Returns the launches of one call and each kernel's max abs difference
    from its plain version on this call's own inputs."""
    from repro_torch.core.subarray import ROW_BITS
    n, size = 8, FULL
    img = np.random.default_rng(0).integers(0, 200, size)
    host = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in
            (img, np.full(size, BRIGHT_DELTA), np.full(size, BRIGHT_CLIP))]
    zero = tc.BitPlaneArray(torch.zeros((n, -(-size // 32)),
                                        dtype=torch.int32, device=dev),
                            size)

    def brightness():
        pix, delta, clip = packed = [tt.to_bitplanes(x, n) for x in host]
        s = tc.apply_op("add", pix, delta)
        over = tc.apply_op("gt", zero, s)
        sel = tc.BitPlaneArray(torch.cat([over.planes, zero.planes[1:]]),
                               size)
        out = tc.apply_op("if_else", sel, clip, s)
        unsigned = tc.BitPlaneArray(out.planes, size, False)
        res = tt.from_bitplanes(unsigned)
        return res, packed, unsigned, (("add", (pix, delta), s),
                                       ("gt", (zero, s), over),
                                       ("if_else", (sel, clip, s), out))

    torch.cuda.synchronize()
    tt.to_bitplanes.launches = tt.from_bitplanes.launches = 0
    vm.run_uprogram.launches = 0
    t0 = time.perf_counter()
    res, packed, unsigned, bbops = brightness()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"bitplane_pack": tt.to_bitplanes.launches,
                "simdram_vm": vm.run_uprogram.launches,
                "bitplane_unpack": tt.from_bitplanes.launches}
    want = {"bitplane_pack": 3, "simdram_vm": 3, "bitplane_unpack": 1}
    if launches != want:
        _fail(f"pipeline launches {launches}, expected {want}")
    ref = np.minimum(img + BRIGHT_DELTA, BRIGHT_CLIP) & 0xFF
    if not np.array_equal(res.cpu().numpy(), ref):
        _fail("brightness pipeline != np.minimum(img + 40, 127) & 0xFF")
    # every kernel launch of the call against its plain version on the
    # same inputs (the VM never writes its inputs back, so they still hold)
    errs = {"bitplane_pack": max(
        _exact(f"pipeline pack {k}", bp.planes, tbp.pack(x, n).planes)
        for k, (x, bp) in enumerate(zip(host, packed))),
        "bitplane_unpack": _exact("pipeline unpack (unsigned)", res,
                                  tbp.unpack(unsigned))}
    errs["simdram_vm"] = max(
        _exact(f"pipeline VM {op}", got.planes, tc.execute(
            tc.get_uprogram(op, n), dict(zip(
                tc.OPS[op].input_names, [x.planes for x in srcs])),
            zero.n_words, out_bits=tc.OPS[op].out_bits(n)))
        for op, srcs, got in bbops)
    cu = tc.ControlUnit()
    for op, srcs, _ in bbops:
        cu.register(tc.get_uprogram(op, n))
        cu.enqueue(tc.BbopRequest(op, srcs, n))
    recs = cu.drain()
    trips = -(-size // ROW_BITS)          # 16 Loop Counter trips at 2^20
    if [r["trips"] for r in recs] != [trips] * 3:
        _fail(f"ControlUnit trips {recs}, expected {trips} each")
    print(f"[pipeline] {card}: brightness on {_p2(size)} 8-bit pixels, "
          f"pack x3 -> add -> gt -> if_else -> unpack: == np.minimum(img + "
          f"40, 127) & 0xFF over every pixel; each launch == its plain "
          f"version on its own inputs (pack, execute, unpack); launches "
          f"{launches}; ControlUnit {recs} stats {cu.stats}; first call "
          f"{first_ms:.3f} ms on the host clock (lowering included)")
    # steady state: host clock per call, then device-busy time from the
    # profiler's kernel events, which must show every launch of the call
    call_ms = _calls_ms(torch, brightness, iters=20)
    busy_ms, kernels = _kernel_busy(torch, brightness)
    if busy_ms is None:
        _fail("the profiler saw no CUDA kernel events in the pipeline")
    seen = {name: sum(c for k, c, _ in kernels if f"::{fn}" in k)
            for name, fn in (("bitplane_pack", "pack_kernel"),
                             ("simdram_vm", "simdram_vm_kernel"),
                             ("bitplane_unpack", "unpack_kernel"))}
    if seen != launches:
        _fail(f"the profiler saw launches {seen}, the wrappers counted "
              f"{launches}")
    top = [(name[:60], c, ms) for name, c, ms in kernels]
    print(f"[pipeline] {card}: steady state {call_ms:.5f} ms per call on "
          f"the host clock; profiled call: "
          f"{sum(c for _, c, _ in kernels)} kernels ({seen} of the port's, "
          f"as counted), device busy {busy_ms:.5f} ms, so the device idles "
          f"{1 - busy_ms / call_ms:.1%} of an unprofiled call; kernels "
          f"(name, count, ms): {top}")
    return launches, errs


def _calls_ms(torch, fn, iters=3):
    """Host-clock ms per call, ending in a synchronize: for a plain
    version that issues thousands of small launches, which no launch
    queue holds, so device time cannot be isolated."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _kernel_ms(torch, fn):
    """Device ms of ``fn`` with ``_time_ms``, the count set so that the
    timed calls take about 0.3 s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    return _time_ms(torch, fn, iters=max(5, min(100, int(300 / once))),
                    warmup=2)[0]


def _copy_ms(torch, n_bytes, dev):
    """Device ms of one ``copy_`` between two buffers of ``n_bytes / 2``
    each: a stream that reads and writes the bytes a transpose must move,
    the yardstick beside pack and unpack (no PyTorch call transposes bit
    planes)."""
    src = torch.ones(n_bytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return _kernel_ms(torch, lambda: dst.copy_(src))


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_simdram_timing(torch, np, tt, vm, tc, tbp, dev, card):
    """Kernel, plain version and library yardstick at 2^20 and 2^26
    elements; returns the rows at the main path's shapes (2^20, 8 bits)."""
    rows = {}
    dev_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for size in (FULL, LARGE):
        nw = -(-size // 32)
        tag = _p2(size)
        rng = np.random.default_rng(3)
        a = torch.from_numpy(rng.integers(-2**30, 2**30, size,
                                          dtype=np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(1, 2**30, size,
                                          dtype=np.int32)).to(dev)
        cond = torch.from_numpy(rng.integers(0, 2, size, dtype=np.int32)
                                ).to(dev)
        for n_bits in (8, 32):
            bp = tt.to_bitplanes(a, n_bits)
            # the int32 input's 4 bytes an element and the planes once
            io = 4 * size + 4 * n_bits * nw
            copy_ms = _copy_ms(torch, io, dev)
            for name, fn, plain, tile in (
                    ("bitplane_pack", lambda: tt.to_bitplanes(a, n_bits),
                     lambda: tbp.pack(a, n_bits), tt.ops.PACK_TILE),
                    ("bitplane_unpack", lambda: tt.from_bitplanes(bp),
                     lambda: tbp.unpack(bp), tt.ops.unpack_tile(n_bits))):
                ms = _kernel_ms(torch, fn)
                plain_ms = _kernel_ms(torch, plain) if size == FULL \
                    else None
                bound_ms, by = _bound(io, 0)
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=by, library_ms=None, copy_ms=copy_ms)
                print(f"[timing] {card}: {name} n_bits={n_bits} {tag} "
                      f"(tile {tile} words, {-(-nw // tile)} blocks): "
                      f"kernel {ms:.5f} ms, plain "
                      f"{'-' if plain_ms is None else f'{plain_ms:.5f}'} "
                      f"ms, bound {bound_ms:.5f} ms ({by}: {io} B), "
                      f"copy_ of {io // 2} B {copy_ms:.5f} ms, library "
                      f"none")
                if size == FULL and n_bits == 8:
                    rows[name] = row
        # div's operands are non-negative, so torch's truncating int32
        # division is the VM's unsigned one
        a_pos = a & (2**30 - 1)
        library = {"add": lambda: torch.add(a, b),
                   "gt": lambda: torch.gt(a, b),
                   "relu": lambda: torch.relu(a),
                   "if_else": lambda: torch.where(mask, a, b),
                   "mul": lambda: torch.mul(a, b), "bitcount": None,
                   "div": lambda: torch.div(a_pos, b, rounding_mode="trunc")}
        mask = cond.bool()
        cases = [(op, 32, library[op]) for op in library]
        if size == FULL:                   # the main path's first bbop,
            a8, b8 = a.to(torch.int8), b.to(torch.int8)    # on 8-bit ints
            cases.insert(0, ("add", 8, lambda: torch.add(a8, b8)))
        for op, n, lib_fn in cases:
            spec = tc.OPS[op]
            srcs = {1: [a], 2: [a_pos if op == "div" else a, b],
                    3: [cond, a, b]}[spec.n_inputs]
            bps = [tt.to_bitplanes(x, n) for x in srcs]
            prog = tc.get_uprogram(op, n)
            cp, _ = vm.compiled(prog, spec.input_names,
                                [n] * spec.n_inputs, spec.out_bits(n))
            planes = [x.planes for x in bps]
            ms = _kernel_ms(torch, lambda: vm.simdram_op(op, *bps))
            plain_ms = None
            if size == FULL:
                plain_ms = _calls_ms(torch, lambda: tc.execute(
                    prog, dict(zip(spec.input_names, planes)), nw,
                    out_bits=spec.out_bits(n)))
            lib_ms = _kernel_ms(torch, lib_fn) if lib_fn else None
            n_uops = len(prog.flatten())
            # the least work: the input planes the function reads (if_else
            # reads one plane of its predicate) and the output planes once;
            # one LOP3 per compiled MAJ per 32-lane word
            io = 4 * nw * (cp.n_loads + spec.out_bits(n))
            bound_ms, by = _bound(io, cp.n_maj * nw)
            shape = vm.launch_shape(cp.n_slots, nw, 128, dev_sms)
            print(f"[timing] {card}: simdram_vm {op} n={n} {tag} "
                  f"({n_uops} uops, {cp.n_maj} MAJ, {cp.n_loads} planes "
                  f"read, {cp.n_slots} slots, "
                  f"(threads, words per thread) {shape}): kernel "
                  f"{ms:.5f} ms, plain (execute, host clock per call) "
                  f"{'-' if plain_ms is None else f'{plain_ms:.3f}'} ms, "
                  f"bound {bound_ms:.5f} ms ({by}: {io} B, {cp.n_maj * nw} "
                  f"LOP3), library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms on int{n}'}")
            if size == FULL and n == 8:
                rows["simdram_vm"] = dict(ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=by,
                                          library_ms=lib_ms)
    return rows


# -- the bit-serial matmul and the bit-plane quantized LM ----------------------
#: (M, K, N): the test grid, ragged shapes, the decode batches M = 1 and 4
#: and the main path's FFN shapes (w1/w3, then w2) at qwen2.5-3b's widths
BSMM_GRID = [(128, 128, 128), (256, 128, 384), (5, 70, 33), (70, 130, 40)]
BSMM_MAIN = [(128, 2048, 11008), (128, 11008, 2048)]
BSMM_DECODE = [(m, k, n) for m in (1, 4) for _, k, n in BSMM_MAIN]
#: a split-K shape: 1 x 4 output tiles, K = 4000 (125 packed words) cut into
#: slices of whole 4-word chunks, the last one ragged
BSMM_SPLIT = (64, 4000, 256)
#: FFN matrices the timing cycles through: 6 x 22.5 MB of packed planes
#: exceed the 50 MB L2, as one forward's 108 do
BSMM_ROTATE = 6


def _bsmm_operands(torch, gen, M, K, N, n_bits, dev):
    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(0, 2, (n_bits, K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    return x, w


def phase_bsmm(torch, bs, bs_ref, dev, card):
    """The kernel against its plain version on the card, bit for bit; then
    the card's dp4a rate.  Returns (max abs error, dp4a per second)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = [(s, nb) for s in BSMM_GRID[:3] for nb in (2, 4, 8)]
    cases += [(BSMM_GRID[3], nb) for nb in range(1, 9)]
    cases += [(s, 8) for s in BSMM_DECODE + BSMM_MAIN + [BSMM_SPLIT]]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for (M, K, N), nb in cases:
        x, w = _bsmm_operands(torch, gen, M, K, N, nb, dev)
        worst = max(worst, _exact(f"bsmm M={M} K={K} N={N} n_bits={nb}",
                                  bs.bsmm_raw(x, w),
                                  bs_ref.ref_bsmm_raw(x, w)))
    M, K, N = BSMM_SPLIT
    split = bs.split_k(M, N, K, sms)
    if split[0] < 2:
        _fail(f"bsmm {BSMM_SPLIT} does not split K on {sms} SMs")
    # rows off 4-byte boundaries are read byte by byte
    x, w = _bsmm_operands(torch, gen, 9, 72, 40, 8, dev)
    xv = x.reshape(-1)[3:3 + 8 * 72].reshape(8, 72)
    _exact("bsmm on a view at a 3-byte offset", bs.bsmm_raw(xv, w),
           bs_ref.ref_bsmm_raw(xv, w))
    print(f"[bsmm] {len(cases) + 1} cases (grid {BSMM_GRID[:2]} and ragged "
          f"(5, 70, 33) x n_bits 2/4/8, (70, 130, 40) x n_bits 1..8, M = 1/4 "
          f"and 128 at the main path's K x N, split-K {BSMM_SPLIT} in "
          f"(S, words per slice) {split}, an unaligned view): kernel == "
          f"plain version bit for bit")
    out = torch.empty(8 * sms * 256, dtype=torch.int32, device=dev)
    iters = 4096
    ms = _kernel_ms(torch, lambda: bs.dp4a_probe(out, iters))
    rate = out.numel() * 8 * iters / ms * 1e3
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[bsmm] {card}: dp4a probe ({out.numel()} threads x {8 * iters} "
          f"dp4a): {ms:.5f} ms, {rate:.4e} dp4a/s = "
          f"{rate / sms / 1.98e9:.2f} per SM per clock at 1.98 GHz "
          f"(assumed {DP4A_PER_S:.4e}); clocks.sm, clocks.max.sm: {clocks}")
    return worst, rate


def _bsmm_timing(torch, bs, bs_ref, qls, dev, card, dp4a_rate):
    """Kernel, plain version and ``torch._int_mm`` (the same product from
    the signed int8 weight) with M = 128 random int8 activation rows, each
    call on the next of ``qls``' real packed planes in turn, so the weights
    come from device memory as in the forward (``BSMM_ROTATE`` matrices
    exceed the 50 MB L2); the one-matrix (L2-warm) times are printed
    beside them."""
    wps = [ql.w_packed for ql in qls]
    K = qls[0].in_features
    n_bits, N, kw = wps[0].shape
    M = 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    signed = []
    for ql in qls:                            # unpacked outside the timing
        planes = ql.w_planes
        u = sum(planes[b].to(torch.int32) << b for b in range(n_bits))
        signed.append((u - (1 << (n_bits - 1))).to(torch.int8))
        del planes, u

    def rotating(fn, args):
        it = itertools.cycle(args)
        return _kernel_ms(torch, lambda: fn(x, next(it)))

    ms = rotating(bs.bsmm_packed, wps)
    plain_ms = rotating(bs_ref.ref_bsmm_packed, wps)
    library_ms = rotating(torch._int_mm, signed)
    warm_ms = _kernel_ms(torch, lambda: bs.bsmm_packed(x, wps[0]))
    warm_lib = _kernel_ms(torch, lambda: torch._int_mm(x, signed[0]))
    n_bytes = M * K + 4 * wps[0].numel() + 4 * M * N
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / INT8_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    n_dp4a = M * K * N // 4
    dp4a_ms = n_dp4a / DP4A_PER_S * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, words = bs.split_k(M, N, K, sms)
    print(f"[qlm] {card}: bsmm M={M} K={K} N={N} n_bits={n_bits} (split-K "
          f"S={splits}, {words} words per slice), {len(wps)} matrices in "
          f"turn: kernel {ms:.5f} ms ({n_bytes / ms / 1e6:.1f} GB/s, "
          f"{n_dp4a / ms * 1e3:.4e} dp4a/s), plain version {plain_ms:.5f} "
          f"ms, torch._int_mm on the signed int8 weight {library_ms:.5f} ms;"
          f" one matrix (L2-warm): kernel {warm_ms:.5f} ms, torch._int_mm "
          f"{warm_lib:.5f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{n_bytes} B packed; {2 * M * K * N} int8 ops take {t_ops:.5f} "
          f"ms on the tensor cores); dp4a ceiling {dp4a_ms:.5f} ms ({n_dp4a}"
          f" dp4a at the assumed {DP4A_PER_S:.4e}/s; "
          f"{n_dp4a / dp4a_rate * 1e3:.5f} ms at the probe's rate)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, dp4a_bound_ms=dp4a_ms)


def phase_qlm(torch, bs, bs_ref, dev, card, dp4a_rate):
    """The full-width example; returns (launches of its quantized forward,
    max abs difference from the plain-version forward, the timing rows at
    the main path's shapes)."""
    from repro_torch.examples import simdram_quantized_lm as ex
    from repro_torch.models.model import forward_train
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bs.bsmm_packed.launches = 0
    res = ex.main(device=dev, smoke=False)
    torch.cuda.synchronize()
    launches = bs.bsmm_packed.launches
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    cfg, params, qls, tokens = (res[k] for k in ("cfg", "params", "qls",
                                                 "tokens"))
    if launches != 3 * cfg.n_layers or cfg.n_layers != 36:
        _fail(f"bsmm launches {launches} in one quantized forward of "
              f"{cfg.n_layers} layers, expected {3 * 36}")
    q_logits = res["q_logits"]
    if (q_logits.shape != (4, 32, cfg.vocab)
            or not bool(torch.isfinite(q_logits).all())
            or not bool(torch.isfinite(res["ref_logits"]).all())):
        _fail(f"logits {tuple(q_logits.shape)} not finite or not "
              f"[4, 32, {cfg.vocab}]")
    scale_bytes = sum(4 * q[k].w_scale.numel() for q in qls for k in q)
    if res["stored_plane_bytes"] != res["plane_bytes"] - scale_bytes:
        _fail(f"packed planes as stored {res['stored_plane_bytes']} B, "
              f"hbm_bytes less the scales {res['plane_bytes'] - scale_bytes}"
              f" B")
    # the same forward with every product through the plain version (the
    # entry QuantizedLinear calls)
    kernel = bs.bsmm_packed
    bs.bsmm_packed = bs_ref.ref_bsmm_packed
    try:
        q_plain = ex.q_forward(cfg, params, qls, tokens)
    finally:
        bs.bsmm_packed = kernel
    err = (q_logits - q_plain).abs().max().item()
    if not torch.equal(q_logits, q_plain):
        _fail(f"quantized logits through the kernel differ from the plain "
              f"version's forward by up to {err:.3e}")
    print(f"[qlm] {card}: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, float32): "
          f"{launches} bsmm launches in one quantized forward; its logits "
          f"== the plain-version forward's, bit for bit; fp32 ppl "
          f"{res['ppl_ref']:.4f}, bit-plane ppl {res['ppl_q']:.4f}, drift "
          f"{res['drift']:.4f}% (< {ex.MAX_DRIFT}%); FFN bytes dense bf16 "
          f"{res['dense_bytes']} B, packed planes {res['plane_bytes']} B "
          f"(hbm_bytes), packed planes as stored and read "
          f"{res['stored_plane_bytes']} B (+ {scale_bytes} B of scales); "
          f"{wall:.1f} s wall for main (init, quantization, two forwards); "
          f"max_memory_allocated {peak} B")
    for name, fn in (("dense", lambda: forward_train(cfg, params,
                                                     {"tokens": tokens})),
                     ("bit-plane", lambda: ex.q_forward(cfg, params, qls,
                                                        tokens))):
        call_ms = _calls_ms(torch, fn, iters=3)
        busy_ms, kernels = _kernel_busy(torch, fn)
        if busy_ms is None:
            print(f"[qlm] {name} forward: {call_ms:.3f} ms on the host "
                  f"clock; device-busy time not measured (no CUDA kernel "
                  f"events)")
            continue
        top = [(k[:60], c, round(t, 5)) for k, c, t in kernels[:6]]
        print(f"[qlm] {card}: {name} forward: {call_ms:.3f} ms on the host "
              f"clock, {sum(c for _, c, _ in kernels)} kernels, device busy "
              f"{busy_ms:.3f} ms (idle {1 - busy_ms / call_ms:.1%}); top "
              f"(name, count, ms): {top}")
    rows = [_bsmm_timing(torch, bs, bs_ref, [q[k] for q in qls[:BSMM_ROTATE]],
                         dev, card, dp4a_rate) for k in ("w1", "w2")]
    del res, params, qls, q_logits, q_plain
    torch.cuda.empty_cache()
    return launches, err, rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    import numpy as np

    from repro_torch import core as tc
    from repro_torch.core import bitplane as tbp
    from repro_torch.kernels import bitplane_transpose as tt
    from repro_torch.kernels.bitserial_matmul import ops as bs
    from repro_torch.kernels.bitserial_matmul import ref as bs_ref
    from repro_torch.kernels.paged_attention import build_kernel, ops
    from repro_torch.kernels.simdram_vm import ops as vm
    from repro_torch.launch import serve
    from repro_torch.serve.engine import batched_paged_attention

    pa = ops.paged_attention
    dev, card = _setup_card(torch)
    print(f"[card] {card} | torch.cuda.get_device_name(0) = "
          f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:        # one nvcc per source at once
        builds = list(pool.map(lambda build: build(), (
            build_kernel, tt.build_kernel, vm.build_kernel,
            bs.build_kernel)))
    for lib, log in builds:
        print(f"[build] {lib}; nvcc -Xptxas -v:\n{log.strip()}")
    print(f"[build] 4 libraries in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    max_err = phase_kernel(torch, pa, ops, batched_paged_attention, dev)
    timings = {label: phase_timing(torch, F, pa, ops,
                                   batched_paged_attention, dev, label, *rest)
               for label, *rest in PA_TIMED}
    timing = timings["19"]
    print(f"[kernel] phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, engine = phase_serve(torch, pa, card,
                                   lambda: serve.main(SERVE_ARGV))
    phase_sync_free(torch, engine, card)
    del engine
    torch.cuda.empty_cache()
    print(f"[serve] phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs = {"bitplane_pack": phase_transpose(torch, np, tt, tbp, dev)}
    errs["bitplane_unpack"] = errs["bitplane_pack"]
    errs["simdram_vm"] = phase_vm(torch, np, tt, vm, tc, dev)
    simdram_launches, path_errs = phase_pipeline(torch, np, tt, vm, tc, tbp,
                                                 dev, card)
    errs = {k: max(v, path_errs[k]) for k, v in errs.items()}
    rows = phase_simdram_timing(torch, np, tt, vm, tc, tbp, dev, card)
    print(f"[simdram] phases took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bsmm_err, dp4a_rate = phase_bsmm(torch, bs, bs_ref, dev, card)
    bsmm_launches, qlm_err, bsmm_rows = phase_qlm(torch, bs, bs_ref, dev,
                                                  card, dp4a_rate)
    print(f"[qlm] phases took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    ring_err, ring_rows, hetero_launches = run_hetero()
    print(f"[hetero] phase took {time.perf_counter() - t0:.1f} s")

    csrc = "src/repro_torch/kernels/{}/csrc/{}.cu"
    simdram = [
        ("bitplane_pack", csrc.format("bitplane_transpose",
                                      "bitplane_transpose"),
         "src/repro/kernels/bitplane_transpose/kernel.py:22"),
        ("bitplane_unpack", csrc.format("bitplane_transpose",
                                        "bitplane_transpose"),
         "src/repro/kernels/bitplane_transpose/kernel.py:31"),
        ("simdram_vm", csrc.format("simdram_vm", "simdram_vm"),
         "src/repro/kernels/simdram_vm/kernel.py:26")]
    # launches: the qwen3 serve's and each mixed-stack path's, each read
    # with the count set to 0 just before it; times at the serve's shape
    # (seq_len 19), the ring shapes beside them
    by_path = {"qwen3-0.6b": launches, **hetero_launches}
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": csrc.format("paged_attention", "paged_attention"),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:27",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(max_err, ring_err), **timing,
        "ring_shapes": {label: {k: row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for label, row in ring_rows.items()}}] + [{
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": simdram_launches[name],
            "max_abs_err": errs[name], "bit_exact": errs[name] == 0.0,
            **rows[name]} for name, source, replaces in simdram] + [{
        # timed at the w1/w3 shape (72 of the 108 launches), M = 128
        "name": "bitserial_matmul", "route": "cuda",
        "source": csrc.format("bitserial_matmul", "bitserial_matmul"),
        "replaces": "src/repro/kernels/bitserial_matmul/kernel.py:27",
        "launches": bsmm_launches, "max_abs_err": max(bsmm_err, qlm_err),
        "bit_exact": max(bsmm_err, qlm_err) == 0.0, **bsmm_rows[0]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--hetero":
        sys.exit(hetero_main(sys.argv[2]))
    sys.exit(main())
