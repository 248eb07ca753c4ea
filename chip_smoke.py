#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. card   — name and power limit (nvidia-smi), TF32 off for matmuls and
              cuDNN so float32 stays float32;
  2. build  — compile the sm_90a paged-attention kernel from the sources in
              this checkout and print ptxas' register/spill report;
  3. kernel — hold the kernel against its plain twins on the test grid and
              at the main path's shape, then time kernel, plain twin and a
              library yardstick with CUDA events beside the byte bound;
  4. serve  — full-width qwen3-0.6b (random weights from a seed) through
              ``repro_torch.launch.serve.main``: 6 requests, 4 slots, decode
              horizon 8, attention through the kernel.  Every request's
              tokens are held against the plain model's greedy decode on
              the card, the kernel's launch count against 28 x token steps,
              and one decode horizon runs under
              ``torch.cuda.set_sync_debug_mode("error")``; then one horizon
              is timed on the host clock and its device-busy time read
              from the profiler's kernel events;
  5. result — a JSON line per kernel, the card line, and the ok line last.

Needs one CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

#: fp32 kernel vs fp32 plain twin: same math, different summation order
#: (tiled online softmax vs one masked softmax), so agreement to a few ulps
#: of the O(1) outputs; 1e-5 absolute + 1e-5 relative holds that with room
ATOL = RTOL = 1e-5
#: reference top-two logit gap under which a greedy pick is a numerical tie
TIE_GAP = 1e-4
#: H100 SXM memory rate and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
    in); otherwise the count is cut and the measurement repeated."""
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
    while n >= 1:
        # ~2 GHz SM clock: spin for twice the host time of n calls
        torch.cuda._sleep(int(min(2 * call_ms * n, 4000) * 2e6))
        spun.record()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        clean = not spun.query()
        stop.synchronize()
        if clean:
            return start.elapsed_time(stop) / n, call_ms
        n //= 4
    _fail("could not queue even one call behind the spin kernel")


def _kernel_busy(torch, fn):
    """(device-busy ms, kernels launched, top kernels) of one ``fn()`` from
    the profiler's CUDA kernel events; (None, 0, []) if it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None, 0, []
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (busy_us / 1e3, sum(e.count for e in kernels),
            [(e.key[:60], e.count, e.self_device_time_total / 1e3)
             for e in top])


def _pool(torch, gen, S, n_kv, g, d, ps, n_pages, width, seq_lens, dev):
    """Random paged-attention inputs: distinct non-null pages per row, a
    table wider than ``max_pages`` (so the row stride matters)."""
    q = torch.randn((S, n_kv, g, d), generator=gen, device=dev) / math.sqrt(d)
    k = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
    rows = [torch.randperm(n_pages - 1, generator=gen, device=dev)[:width] + 1
            for _ in range(S)]
    pt = torch.stack(rows).to(torch.int32)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, k, v, pt, lens


def phase_kernel(torch, pa, ops, batched, dev):
    """Kernel vs plain twins on the test grid and the main-path shape."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    cases = []
    for n_kv, g in ((2, 3), (1, 4), (4, 1), (2, 2)):
        for d in (8, 16):
            for ps in (2, 4):
                cases.append((n_kv, g, d, ps, 12, 8, [0, 1, 5, 16, 31]))
    cases.append((8, 2, 128, 8, 129, 32, [0, 1, 7, 8]))
    cases.append((8, 2, 128, 8, 129, 32, [9, 255, 256, 17]))
    for n_kv, g, d, ps, n_pages, max_pages, lens in cases:
        width = min(max_pages + 2, n_pages - 1)
        q, k, v, pt, ln = _pool(torch, gen, len(lens), n_kv, g, d, ps,
                                n_pages, width, lens, dev)
        out = pa(q, k, v, pt, ln, max_pages)
        torch.cuda.synchronize()
        refs = (("ref_paged_attention", ops._plain(q, k, v, pt, ln,
                                                   max_pages)),
                ("batched_paged_attention", batched(q, k, v, pt, ln,
                                                    max_pages)))
        # the default token split and two others (one warp per query row,
        # an odd count) must agree alike
        for splits in (None, 1, 3 if 3 * g <= ops.MAX_WARPS else 1):
            got = pa(q, k, v, pt, ln, max_pages, splits=splits)
            for name, ref in refs:
                err = (got - ref).abs().max().item()
                ok = torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                if not ok or not torch.isfinite(got).all():
                    _fail(f"kernel (splits={splits}) vs {name} at "
                          f"n_kv={n_kv} g={g} d={d} ps={ps} seq_lens={lens}: "
                          f"max abs err {err:.3e}")
                worst = max(worst, err)
        zero = out[[i for i, x in enumerate(lens) if x == 0]]
        if zero.numel() and zero.abs().max().item() != 0.0:
            _fail("seq_len 0 must give zeros")
    # junk past seq_len (null page included) must not change the output
    q, k, v, pt, ln = _pool(torch, gen, 1, 1, 2, 16, 2, 6, 4, [3], dev)
    pt2 = pt.clone()
    pt2[0, 2:] = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    if not torch.equal(pa(q, k, v, pt, ln, 4), pa(q, k, v, pt2, ln, 4)):
        _fail("kernel output depends on pages past seq_len")
    print(f"[kernel] {len(cases)} grid/main-path cases + garbage-page case: "
          f"kernel == plain twins within atol={ATOL} rtol={RTOL} (fp32, "
          f"different summation order); max abs err {worst:.3e}")
    return worst


def phase_timing(torch, F, pa, batched, dev, seq_len):
    """Time kernel, plain twin and the library yardstick at the main path's
    decode shape (4 slots, 8 kv heads, g=2, d=128, ps=8, 32-page rows)."""
    S, n_kv, g, d, ps, n_pages, max_pages = 4, 8, 2, 128, 8, 129, 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    q, k, v, pt, ln = _pool(torch, gen, S, n_kv, g, d, ps, n_pages,
                            max_pages, [seq_len] * S, dev)
    n_tok = [min(int(x), max_pages * ps) for x in ln.tolist()]
    ms, call_ms = _time_ms(torch, lambda: pa(q, k, v, pt, ln, max_pages))
    one_ms, _ = _time_ms(torch, lambda: pa(q, k, v, pt, ln, max_pages,
                                           splits=1))
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
    print(f"[kernel] seq_len {seq_len}, device ms per call: kernel "
          f"{ms:.5f} (one warp per query row: {one_ms:.5f}), plain twin "
          f"{plain_ms:.5f}, gather+SDPA {library_ms:.5f}; bound "
          f"{bound_ms:.6f} ({bound_by}: {n_bytes} B, {flops} flop); host "
          f"clock per call incl. launch overhead: kernel {call_ms:.5f}, "
          f"plain {plain_call:.5f}, gather+SDPA {library_call:.5f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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


def phase_serve(torch, pa, card):
    from repro_torch.launch import serve
    from repro_torch.models import model as tm

    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    finished, engine = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    peak = torch.cuda.max_memory_allocated()
    cfg, dev = engine.cfg, engine.device
    steps = engine.stats["token_steps"]
    n_layers = engine.geom.n_full
    if launches != n_layers * steps or launches == 0:
        _fail(f"kernel launches {launches} != {n_layers} layers x {steps} "
              f"token steps")
    print(f"[serve] kernel launches {launches} = {n_layers} layers x "
          f"{steps} token steps (engine stats {engine.stats})")
    if len(finished) != 6 or any(len(r.out) != 16 for r in finished):
        _fail("expected 6 finished requests of 16 tokens")
    for r in sorted(finished, key=lambda r: r.rid):
        n, gap = _reference_tokens(torch, tm, cfg, engine.params, r, dev)
        tail = ("" if gap is None else
                f"; stopped at token {n}: reference top-two gap {gap:.3e} "
                f"< {TIE_GAP}")
        print(f"[serve] req {r.rid}: {n}/{len(r.out)} tokens equal to the "
              f"plain greedy reference{tail}")
    n_out = sum(len(r.out) for r in finished)
    print(f"[serve] {card}: {len(finished)} requests, {n_out} tokens in "
          f"{wall:.3f} s wall ({n_out / wall:.1f} tok/s, params init and "
          f"kernel load included); max_memory_allocated "
          f"{peak} B")
    return launches, engine


def phase_sync_free(torch, engine, card):
    """One fused horizon dispatched with every host sync turned into an
    error: the decode path must enqueue work only."""
    S, dev, k = engine.max_seqs, engine.device, 8
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
        _fail(f"sync-free horizon returned {block.tolist()}")
    print(f"[sync] decode_many(K={k}) over {S} slots under "
          f"set_sync_debug_mode('error'): no host sync; block "
          f"{tuple(block.shape)}")
    # steady-state cost of one horizon (3 more; the slots grow to 36
    # tokens, 5 pages each, well inside the pool): host clock, then the
    # device-busy share from the profiler's kernel events
    def horizon():
        return engine.decode_many(toks, mask, steps, k)

    horizon()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    horizon()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels, top = _kernel_busy(torch, horizon)
    print(f"[horizon] {card}: decode_many(K={k}) over {S} slots, "
          f"{engine.geom.n_full} layers: {call_ms:.3f} ms on the host clock "
          f"({call_ms / k:.3f} ms per token step)")
    if busy_ms is None:
        print("[horizon] device-busy time: not measured (the profiler saw "
              "no CUDA kernel events)")
    else:
        print(f"[horizon] profiled call: {n_kernels} kernels "
              f"({n_kernels / k:.0f} per token step), device busy "
              f"{busy_ms:.3f} ms, so the device idles "
              f"{1 - busy_ms / call_ms:.1%} of the unprofiled call; top "
              f"kernels by device time (name, count, ms): {top}")
    for blk in list(engine.alloc.blocks.values()):
        engine.alloc.free(blk)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import build_kernel, ops
    from repro_torch.serve.engine import batched_paged_attention

    pa = ops.paged_attention
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {card} | torch.cuda.get_device_name(0) = "
          f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    lib, log = build_kernel()
    print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s; nvcc "
          f"-Xptxas -v:\n{log.strip()}")

    max_err = phase_kernel(torch, pa, ops, batched_paged_attention, dev)
    timing = phase_timing(torch, F, pa, batched_paged_attention, dev, 19)
    phase_timing(torch, F, pa, batched_paged_attention, dev, 256)

    launches, engine = phase_serve(torch, pa, card)
    phase_sync_free(torch, engine, card)

    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:27",
        "launches": launches, "max_abs_err": max_err, **timing}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
