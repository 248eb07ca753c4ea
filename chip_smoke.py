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
              mixed [19, 256, 2048, 0], with the split plan.  Also on
              page tables whose rows share pages as the prefix cache
              leaves them (two rows on the same pages, one on a COW copy
              of the last) at seq_len 19 and 256: bit-equal to the same
              launch on private copies of each row's pages;
  4. serve  — full-width qwen3-0.6b (random weights from a seed) through
              ``repro_torch.launch.serve.main``: 6 requests, 4 slots, decode
              horizon 8, attention through the kernel.  Every request's
              tokens are held against the plain model's greedy decode on
              the card, the kernel's launch count against (full + ring
              layers) x token steps (28 x), and one decode horizon runs
              under ``torch.cuda.set_sync_debug_mode("error")``; then one
              horizon is timed on the host clock and its device-busy time
              read from the profiler's kernel events;
 4c. prefix — the same serve with a 252-token system prompt in front of
              every prompt (``--shared-prefix 252``: 31 full pages and 4
              tokens), three times on the same weights: cache off, cache
              on, cache on with ``--overlap``.  Every request against the
              plain greedy decode of its 256-token prompt, launches 28 x
              token steps, the three serves' tokens identical, cache-on
              token steps below cache-off, hits >= 1 with 252 tokens
              reused and one COW clone per hit, the host page mirror
              exact and the pool drained to 0; then a horizon over two
              slots mapping the same cached pages and one on a COW clone,
              and the overlap's staged half (cache eviction, admission
              with a hit, prefill staging) while a horizon's event is
              pending, both under ``set_sync_debug_mode("error")``; then
              the host ms of 16 decode ticks per mode, overlap off and
              on in turns, and one tick's device-busy ms per mode.  It runs after phase 10: run before phase
              7, its profiled ticks left the profiler losing the
              brightness call's launches;
 4d. swap   — the host swap tier: the qwen3 serve with 6 requests of 60
              own tokens + 40 new on 33 pages of 8 with 16-page rows
              (prefill chunks of 8), three times on the same weights:
              discard, swap (``--host-swap-pages 64``), swap + overlap.
              Launches 28 x token steps; the discard serve against the
              plain greedy decode and the other two serves' tokens equal
              to it; swap-outs = swap-ins >= 1 with fewer prefill tokens
              than discard; tier and pool drained, mirror exact.  The host
              ms of each swap-out and swap-in and the image bytes beside a
              ``copy_`` of the largest image's bytes to pinned host memory
              and back; then a ``swap_in`` under
              ``set_sync_debug_mode("error")`` while a horizon's event is
              pending, its pages equal to the image; then the device ms
              of ``restore_block`` and ``snapshot_block`` on a 10-page
              image beside a ``copy_`` of its bytes.  It runs after 4i,
              beside phase 11's child, and 4e and 4f follow it there;
 4e. traffic — open-loop traffic and telemetry on the qwen3 serve's
              weights (4 slots, pages of 8, 129 pages, horizon 8, prefill
              chunks of 8, the prefix cache on): ``make_trace`` of 16
              requests at 2/s, seed 0, poisson and bursty.  Each trace
              replayed open-loop on the virtual clock equals its closed-
              loop run and the plain greedy decode, launches 28 x token
              steps, pool drained; then the launcher's wall-clock path
              (``--traffic P --trace OUT --metrics --overlap``): its trace
              passes the checker, 16 arrive and finish, all six tick
              spans, tokens as before; TTFT and TPOT p50/p99, throughput,
              goodput at TTFT <= 1 s and TPOT <= 100 ms, the trace's
              events and bytes.  A decode tick's host ms traced and
              untraced in turns; an arrival, a gauge sample and the
              overlap's staged half traced under
              ``set_sync_debug_mode("error")`` with a horizon pending;
              phase 4d's schedule traced with swap and with discard: the
              checker passes, tokens equal phase 4d's, and each preempted
              request's TTFT and time from preemption to its next token;
 4f. chaos  — the fault plane, exact recovery and disaggregation on the
              qwen3 serve's weights: phase 4d's schedule through the
              launcher with ``--faults --fault-rate 0.1 --fault-seed 7``
              and 3 forced decode-tick faults, traced (tokens equal phase
              4d's, faults fired per class, none unresolved, the checker
              passes, pool and tier drained); the launcher's ``--disagg
              --overlap --trace OUT --metrics`` on phase 4's 6 requests
              (prefill 6 slots / 49 pages, decode 3 / 97), clean and with
              ``--faults``: tokens equal phase 4's, 6 handoffs, a two-pool
              trace (``n_pools == 2``), the host ms of each
              ``export_image`` and the device ms of each import scatter
              beside a ``copy_`` of its bytes; crash recovery of 5 of
              phase 4's requests (3 slots, horizon 4, a snapshot every 3
              ticks, the crash after 6 with a late arrival) on a fresh
              engine, clean and with a bit-flipped snapshot leg: merged
              tokens equal phase 4's, snapshot bytes and host ms per save;
              the decode scheduler's ``_admit_image`` and a faulted
              ``_call_vbi`` reserve under ``set_sync_debug_mode("error")``
              with a horizon's event pending.  Launches 28 x token steps
              in every run (both engines' under ``--disagg``);
 4g. train  — training, the encoder-decoder and vision inputs (no
              paged-attention launch: training attends through the plain
              ``layers.attention``, as the reference).  qwen3-0.6b at its
              published config through ``repro_torch.launch.train.main``
              (``--no-smoke --steps 20 --batch 8 --seq 128 --ckpt-every
              10``; float32 params, bfloat16 compute, remat): every loss
              finite and the last below the first; a second run resumed
              by the launcher from the step-10 checkpoint alone gives the
              same losses and params within the stated tolerance (and
              says whether bit-equal); one more launcher step under
              ``set_sync_debug_mode("error")``; host ms per step, tokens
              per second, one profiled step's device-busy ms, idle share
              and top kernels, peak memory, checkpoint bytes.  Three
              train steps of the qwen3 smoke config at float32 on the card
              and on the CPU from the same params and batches agree.
              whisper-small at its published config (12 + 12 layers,
              1,500 audio frames) and internvl2-26b at full width cut to 2
              of 48 layers (256 vision tokens): prefill of 13 tokens and
              one decode step equal ``forward_train`` at the same
              positions in float32; then train steps at their bfloat16
              compute (whisper 3 on one batch, the loss falling;
              internvl2 one of 4 microbatches, its loss the mean of
              ``lm_loss`` over them, through the vision slice), the
              params moving.  Each model is freed before the next; the
              checkpoints live under ``build/train``; 4j removes them;
 4j. train-mesh — training on a 1x1 device mesh: qwen3-0.6b at its
              published config through ``launch.train.main`` with
              ``--mesh host`` (state specs, ``shard_state``, the SPMD
              step under ``logical_axes``), 5 steps of 8 x 128: losses,
              grad norms, params, m, v and step bit-equal to 5 unmeshed
              ``make_train_step`` steps from the same seed and batches;
              ``mesh.collectives`` all zero; one mesh step under
              ``set_sync_debug_mode("error")``; both routes' host ms a
              step in turns; 4g's step-10 checkpoint restored through the
              mesh's shardings equal to the plain restore; one step with
              the EF compressor finite and sync-free; no paged-attention
              launch.  It runs after 4g, before 4k;
 4k. train-stacks — every remaining stack on a 1x1 training mesh, at
              full width, through ``launch.train --mesh host``'s route
              (``make_host_mesh(1, 1)``, ``shard_state``, the SPMD step
              under ``logical_axes``): mixtral-8x7b cut to 1 layer (at
              float32 compute and ``capacity_factor`` E/K), mamba2-1.3b
              uncut, recurrentgemma-9b cut to one period (3 layers),
              whisper-small uncut and internvl2-26b cut to 2 layers, 2
              steps each against 2 unmeshed steps from the same seed and
              batches: bit-equal for the dense-MLP stacks, the MoE within
              ``TRAIN_STACKS_MOE_TOL``; every mesh step through the SPMD
              step, no collective, the second under
              ``set_sync_debug_mode("error")``, host ms a step, no
              paged-attention launch.  A stack whose two states and
              gradients would not fit on the card keeps the unmeshed
              state on the host.  It runs after 4j, before 4h;
 4h. mesh   — phase 4's requests on a 1x1 device mesh through the
              launcher (``--mesh-shape 1x1 --kv-layout shard``: the
              kernel engine on ``make_host_mesh(1, 1)``): tokens equal to
              phase 4's, launches 28 x token steps, no collective; one
              horizon under ``set_sync_debug_mode("error")``; a horizon's
              host ms beside phase 4's and in turns with an unmeshed
              engine's; one token step of each profiled, their kernel
              counts equal (the ``data``-axis code launches nothing at
              width 1); the launcher asked for ``--mesh-shape 2x1`` in
              one process (and with ``--attn-impl kernel``) exits 2
              naming what it needs; an engine built with ``kv_layout
              auto`` on a 1x1 mesh is ``shard`` with no collective.  It
              runs after 4k, before 4l;
 4l. dryrun — the dry run on the meta device (a 45 s budget, reported; a
              hang past 150 s fails): qwen3-0.6b's train_4k and
              decode_32k cells on the 16x16 and 2x16x16 production
              meshes, its decode_32k with int8 weights on 16x16 (fewer
              parameter bytes a device than dense) and gemma3-12b's
              long_500k on 16x16 (its caches' sequence cut over data x
              model), five ``python -m repro_torch.launch.dryrun``
              processes on the host: the roofline terms and bottleneck on
              the H100's constants, collective calls and bytes by kind,
              bytes per device, ``useful_flops_ratio``;
              ``kv_layout="auto"``'s choice and both layouts' collective
              bytes for qwen3-0.6b and recurrentgemma-9b at full width on
              counting 1x2 and 1x4 meshes; the step cost walker over a
              4g-style qwen3-0.6b train step (8 x 128) on the card against
              the same step on meta; qwen3-0.6b at its published 28
              layers on the card: ``make_prefill_step`` of 4 x 256 tokens
              and 8 greedy ``make_decode_step`` steps on a 1x1 mesh,
              logits and caches bit-equal to the unmeshed steps, no
              collective, and one decode step walked on the card against
              meta: FLOPs, bytes, ops and collectives equal, no launch
              counter moved.  It runs after 4h, before 4i;
 4i. legacy — phase 4's requests through the launcher's per-sequence path
              (``--legacy``: ``serve/paged.py::PagedServer``, attention
              through ``paged_decode_attention`` on the kernel): tokens
              equal to phase 4's, launches exactly 28 x decode calls;
              then the host ms per decode call over 4 slots (the path
              reads each sequence's length from the device per token, by
              design) and the call count.  It runs before 4d;
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
              The swap tier on the mixed stacks: gemma3-12b on phase
              4d's schedule with a host tier (each image carrying 40 ring
              layers x 128 frames, charged n_pages + 128; every request
              against the plain decode), and for recurrentgemma-9b and
              mamba2-1.3b a request swapped out of slot 0 mid-decode and
              into slot 1, its tokens against the uninterrupted decode.
              Mixtral's weights again on a 1x1 device mesh (the kernel
              engine on ``make_host_mesh(1, 1)``, its MoE through
              ``distributed/moe_ep.py``): tokens equal to the unmeshed
              serve's (held to the plain decode), moe_ep reached once per
              MoE layer per token step, no collective, launches 2 x token
              steps, a sync-free horizon, a decode step's logits beside
              the unmeshed engine's, and horizons of both in turns.
              Each model is freed before the next loads.  The phase runs
              in a child process (``chip_smoke.py --hetero OUT``) started
              after 4i, beside phases 4d-4f once it has timed the ring
              shapes (host-bound both, they share the card): before phase
              7 it left the profiler losing launches of the brightness
              call, so it starts after every phase here that reads it;
 12. result — a JSON line per kernel, the card line, and the ok line last.

Needs one CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import shutil
import statistics
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


def phase_kernel_shared(torch, pa, ops, batched, dev):
    """The kernel on page tables whose rows share physical pages, as the
    prefix cache leaves them: rows 0 and 1 name the same pages, row 2 the
    same pages but a COW copy of the last (its tail past the matched 4
    tokens the row's own K/V), row 3 pages of its own.  At the serve's
    shape, seq_len 19 and 256, planned and forced splits: each launch
    twice and bit-equal, bit-equal to the same launch on a table of
    private copies of each row's pages, and within tolerance of both plain
    twins."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    n_kv, g, d, ps, max_pages = 8, 2, 128, 8, 32
    worst, n_checked = 0.0, 0
    for seq_len in (19, 256):
        n_used = -(-seq_len // ps)
        n_pages = 2 + 2 * n_used
        q, k, v, _, ln = _pool(torch, gen, 4, n_kv, g, d, ps, n_pages,
                               max_pages, [seq_len] * 4, dev)
        q[1] = q[0]
        perm = torch.randperm(n_pages - 2, generator=gen, device=dev) + 1
        base, own = perm[:n_used], perm[n_used:2 * n_used]
        cow = n_pages - 1
        k[cow, :4], v[cow, :4] = k[base[-1], :4], v[base[-1], :4]
        pt = torch.zeros((4, max_pages), dtype=torch.int32, device=dev)
        pt[:3, :n_used] = base.to(torch.int32)
        pt[2, n_used - 1] = cow
        pt[3, :n_used] = own.to(torch.int32)
        # private copies: row r, column c at page 1 + r * n_used + c
        ppt = torch.zeros_like(pt)
        ppt[:, :n_used] = (1 + torch.arange(4 * n_used, device=dev)
                           .view(4, n_used)).to(torch.int32)
        src = pt[:, :n_used].reshape(-1).long()
        pk = torch.zeros((1 + 4 * n_used,) + tuple(k.shape[1:]),
                         device=dev)
        pv = torch.zeros_like(pk)
        pk[1:], pv[1:] = k[src], v[src]
        refs = (("ref_paged_attention", ops._plain(q, k, v, pt, ln,
                                                   max_pages)),
                ("batched_paged_attention", batched(q, k, v, pt, ln,
                                                    max_pages)))
        for splits, blocks in ((None, None), (1, 1), (None, 2), (3, 5)):
            got = pa(q, k, v, pt, ln, max_pages, splits=splits,
                     blocks=blocks)
            again = pa(q, k, v, pt, ln, max_pages, splits=splits,
                       blocks=blocks)
            priv = pa(q, pk, pv, ppt, ln, max_pages, splits=splits,
                      blocks=blocks)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(got, priv)
                    and torch.equal(got[0], got[1])):
                _fail(f"shared page table, seq_len {seq_len} (splits="
                      f"{splits}, blocks={blocks}): two calls, the private "
                      f"copies or the two rows sharing pages differ")
            for name, ref in refs:
                err = (got - ref).abs().max().item()
                if (not torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                        or not torch.isfinite(got).all()):
                    _fail(f"shared page table, seq_len {seq_len} (splits="
                          f"{splits}, blocks={blocks}) vs {name}: max abs "
                          f"err {err:.3e}")
                worst = max(worst, err)
            n_checked += 1
    print(f"[kernel] shared page tables (2 rows on the same pages, 1 on a "
          f"COW copy, 1 private), seq_len 19 and 256, {n_checked} plans: "
          f"each launch twice and bit-equal, bit-equal to a table of "
          f"private copies; == plain twins within atol={ATOL} rtol={RTOL}; "
          f"max abs err {worst:.3e}")
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


def phase_serve(torch, pa, card, run, tag="serve", n_new=16,
                reference=True):
    """One serve through a user's entry point: ``run()`` returns
    ``(finished, engine, ...)``.  The kernel's count is set to 0 just before it
    and read just after; it must equal (full + ring layers) x token steps.
    Every request's ``n_new`` tokens are held against the plain model's
    greedy decode on the card (unless ``reference`` is False: a caller
    that holds this serve's tokens equal to one that was)."""
    from repro_torch.models import model as tm

    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    finished, engine = run()[:2]
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
    if len(finished) != 6 or any(len(r.out) != n_new for r in finished):
        _fail(f"[{tag}] expected 6 finished requests of {n_new} tokens")
    t1 = time.perf_counter()
    for r in sorted(finished, key=lambda r: r.rid) if reference else ():
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
          f"plain reference decode {time.perf_counter() - t1:.1f} s"
          f"{'' if reference else ' (not run: held to another serve)'}")
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
    return call_ms


# -- serving on a device mesh: the 1x1 mesh on the card ------------------------
MESH_ARGV = SERVE_ARGV + ["--mesh-shape", "1x1", "--kv-layout", "shard"]


def _horizon_turns(torch, engines, turns=4, k=8):
    """Host ms of one decode horizon (K = ``k``, every slot) per engine,
    the engines in turns (a, b, b, a) ``turns`` times after one warm
    horizon each; ``{name: [ms]}``.  Frees the slots it took."""
    args = {}
    for name, eng in engines.items():
        S, dev = eng.max_seqs, eng.device
        for s in range(S):
            eng.alloc.reserve_span(eng.alloc.alloc(s), 4, k * (2 * turns + 1))
        eng.prefill_chunk(
            torch.arange(1, 5, dtype=torch.int32, device=dev).repeat(S, 1),
            torch.full((S,), 4, dtype=torch.int32, device=dev))
        args[name] = (torch.full((S,), 7, dtype=torch.int32, device=dev),
                      torch.ones((S,), dtype=torch.bool, device=dev),
                      torch.full((S,), k, dtype=torch.int32, device=dev), k)
        eng.decode_many(*args[name])
    torch.cuda.synchronize()
    a, b = list(engines)
    ms = {a: [], b: []}
    for name in [a, b, b, a] * turns:
        t0 = time.perf_counter()
        engines[name].decode_many(*args[name])
        torch.cuda.synchronize()
        ms[name].append(round((time.perf_counter() - t0) * 1e3, 3))
    for eng in engines.values():
        for blk in list(eng.alloc.blocks.values()):
            eng.alloc.free(blk)
    return ms


def phase_mesh(torch, pa, card, serve_outs, serve_horizon_ms):
    """Phase 4's requests on a 1x1 device mesh through the launcher
    (``--mesh-shape 1x1 --kv-layout shard``: ``PagedEngine(mesh=
    make_host_mesh(1, 1), attn_impl="kernel")``): the same tokens as phase
    4, (full layers) x token steps kernel launches, no collective; one
    horizon under ``set_sync_debug_mode("error")`` and its host ms beside
    phase 4's; then horizons of an unmeshed engine on the same params and
    of the mesh engine in turns; one token step of each profiled twice in
    turns, their kernel counts equal; the launcher's refusals of a 2x1
    mesh in one process.  Returns the launches."""
    from repro_torch.serve.engine import PagedEngine
    box = {}

    def run():
        from repro_torch.launch import serve
        box["out"] = serve.main(MESH_ARGV)
        return box["out"]
    launches, engine = phase_serve(torch, pa, card, run, tag="mesh",
                                   reference=False)
    outs = {r.rid: r.out for r in box.pop("out")[0]}
    if outs != serve_outs:
        _fail(f"[mesh] 1x1 mesh tokens {outs} differ from phase 4's "
              f"{serve_outs}")
    mesh = engine.mesh
    if (mesh is None or mesh.shape != {"data": 1, "model": 1}
            or engine.kv_layout != "shard" or engine.attn_impl != "kernel"
            or len(engine.placement) != 1):
        _fail(f"[mesh] the launcher's engine is not the kernel engine on a "
              f"1x1 mesh: {mesh}, {engine.kv_layout}, {engine.attn_impl}, "
              f"{engine.placement}")
    served = {k: dict(v) for k, v in mesh.collectives.items()}
    horizon_ms = phase_sync_free(torch, engine, card)
    plain = PagedEngine(engine.cfg, engine.params,
                        page_size=engine.page_size, max_seqs=engine.max_seqs,
                        n_pages=engine.n_pages, attn_impl="kernel",
                        device=engine.device)
    turns = _horizon_turns(torch, {"plain": plain, "mesh": engine})
    if any(c["calls"] or c["bytes"] for c in mesh.collectives.values()):
        _fail(f"[mesh] a 1x1 mesh made collectives: {mesh.collectives}")
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[mesh] {card}: qwen3-0.6b on a 1x1 mesh (kv_layout "
          f"{engine.kv_layout}, placement {engine.placement}, attn_impl "
          f"{engine.attn_impl}): tokens of all 6 requests equal phase 4's; "
          f"{launches} kernel launches; collectives after the serve "
          f"{served} and after the horizons {mesh.collectives}; "
          f"decode_many(K=8) host clock {horizon_ms:.3f} ms on the mesh "
          f"engine against {serve_horizon_ms:.3f} ms in phase 4")
    print(f"[mesh] {card}: decode_many(K=8) host ms in turns (plain, mesh, "
          f"mesh, plain) x 4 on the same params: plain {turns['plain']}, "
          f"mesh {turns['mesh']}; medians {med['plain']:.3f} and "
          f"{med['mesh']:.3f}, mesh / plain {med['mesh'] / med['plain']:.4f}")
    # the profiler can miss launches at the start of the step it reads
    # (one reading here lost 110 of 2,675), never add one: each engine's
    # largest of two readings, taken in turns, is its count
    t0 = time.perf_counter()
    engines = {"plain": plain, "mesh": engine}
    readings = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        readings[name].append(_step_kernels(torch, engines[name]))
    counts = {name: max(r) for name, r in readings.items()}
    if counts["mesh"] != counts["plain"]:
        _fail(f"[mesh] a token step of the 1x1 mesh engine launched "
              f"{counts['mesh']} kernels, the unmeshed engine's "
              f"{counts['plain']} (readings {readings})")
    print(f"[mesh] {card}: one token step (decode over "
          f"{engine.max_seqs} slots) profiled in turns (plain, mesh, mesh, "
          f"plain): readings {readings}; {counts['mesh']} kernels on the "
          f"1x1 mesh engine, {counts['plain']} on the unmeshed engine "
          f"(mesh / plain {counts['mesh'] / counts['plain']:.4f})")
    _mesh_refusals()
    _auto_on_one_device(engine)
    print(f"[mesh] the token-step profiles, the refusals and the auto "
          f"construction took {time.perf_counter() - t0:.1f} s")
    return launches


def _auto_on_one_device(engine):
    """``kv_layout="auto"`` on a 1x1 mesh (the kernel engine on the
    launcher's weights): it resolves to ``shard`` without a trace, and the
    mesh makes no collective."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import PagedEngine
    mesh = make_host_mesh(1, 1, device="cuda")
    auto = PagedEngine(engine.cfg, engine.params, page_size=engine.page_size,
                       max_seqs=engine.max_seqs, n_pages=engine.n_pages,
                       attn_impl="kernel", device=engine.device, mesh=mesh,
                       kv_layout="auto")
    if (auto.kv_layout != "shard" or auto.layout_report is not None
            or any(c["calls"] or c["bytes"]
                   for c in mesh.collectives.values())):
        _fail(f"[mesh] kv_layout auto on a 1x1 mesh: {auto.kv_layout}, "
              f"report {auto.layout_report}, {mesh.collectives}")
    print(f"[mesh] kv_layout auto on a 1x1 mesh: {auto.kv_layout}, no "
          f"trace, collectives {mesh.collectives}")


def _step_kernels(torch, eng):
    """The CUDA kernels of one token step (``decode`` over every slot,
    after a 4-token prefill) from the profiler's kernel events.  Frees the
    slots it took."""
    S, dev = eng.max_seqs, eng.device
    for s in range(S):
        eng.alloc.reserve_span(eng.alloc.alloc(s), 4, 2)
    eng.prefill_chunk(
        torch.arange(1, 5, dtype=torch.int32, device=dev).repeat(S, 1),
        torch.full((S,), 4, dtype=torch.int32, device=dev))
    toks = torch.full((S,), 7, dtype=torch.int32, device=dev)
    mask = torch.ones((S,), dtype=torch.bool, device=dev)
    _, kernels = _kernel_busy(torch, lambda: eng.decode(toks, mask))
    for blk in list(eng.alloc.blocks.values()):
        eng.alloc.free(blk)
    if not kernels:
        _fail("[mesh] the profiler saw no CUDA kernel of a token step")
    return sum(c for _, c, _ in kernels)


def _mesh_refusals():
    """The launcher asked for a 2x1 mesh in this one process: without
    ``torchrun``'s two processes it exits 2 naming them, and with
    ``--attn-impl kernel`` it exits 2 naming the kernel; neither leaves a
    process group behind."""
    import contextlib
    import io

    import torch.distributed as dist
    from repro_torch.launch import serve
    argv = ["--arch", "qwen3-0.6b", "--device", "cuda", "--mesh-shape", "2x1"]
    for extra, want in (([], "runs 2 processes"),
                        (["--attn-impl", "kernel"],
                         "--attn-impl kernel is not supported")):
        err, code = io.StringIO(), None
        try:
            with contextlib.redirect_stderr(err):
                serve.main(argv + extra)
        except SystemExit as e:
            code = e.code
        msg = err.getvalue().strip().splitlines()
        if code != 2 or want not in err.getvalue() or dist.is_initialized():
            _fail(f"[mesh] the launcher with {argv + extra} in one process "
                  f"exited {code} ({msg[-1:]}), not 2 naming {want!r}")
        print(f"[mesh] launcher {' '.join(argv[-2:] + extra)} in one "
              f"process: exit 2, {msg[-1]}")


# -- phase 4l: the dry run on the meta device -------------------------------
#: phase 4l's time budget (the whole script's limit is 1,200 s), which
#: its last line reports against; its traces are host-bound and the
#: host's speed moves 30-40% between calls, so only a hang (past
#: ``DRYRUN_HANG_S``) fails the phase
DRYRUN_LIMIT_S = 45.0
DRYRUN_HANG_S = 150.0
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun"
#: phase 4's pool at full width: 4 slots, pages of 8, 129 pages, 32-page
#: rows, as ``kv_layout="auto"`` would trace it
AUTO_POOL = dict(n_pages=129, page_size=8, max_seqs=4, max_pages=32)
#: phase 4l's ``launch.dryrun`` children, one process a command, all
#: started at once (each traces on the host's CPU only): name → (its
#: arguments, the artifacts it writes).  qwen3-0.6b's train_4k and
#: decode_32k cells on both production meshes, decode_32k with int8
#: weights, and gemma3-12b's long_500k (batch 1: its caches' sequence cut
#: over data x model); prefill cells stay out (about 90 s a trace)
DRYRUN_CELLS = {
    "train single": (["--arch", "qwen3-0.6b", "--shape", "train_4k",
                      "--mesh", "single"], ["qwen3-0.6b_train_4k_single"]),
    "train multi": (["--arch", "qwen3-0.6b", "--shape", "train_4k",
                     "--mesh", "multi"], ["qwen3-0.6b_train_4k_multi"]),
    "decode": (["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
                "both"], ["qwen3-0.6b_decode_32k_single",
                          "qwen3-0.6b_decode_32k_multi"]),
    "decode q8": (["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                   "--mesh", "single", "--quantized"],
                  ["qwen3-0.6b_decode_32k_single_q8"]),
    "long": (["--arch", "gemma3-12b", "--shape", "long_500k", "--mesh",
              "single"], ["gemma3-12b_long_500k_single"]),
}
#: phase 4l's serve steps on the card: qwen3-0.6b's published config,
#: ``batch`` prompts of ``prompt`` tokens, then ``steps`` greedy decodes
DRYRUN_SERVE = dict(batch=4, prompt=256, steps=8)


def _dryrun_children():
    """``python -m repro_torch.launch.dryrun`` of each ``DRYRUN_CELLS``
    command, started at once."""
    import os
    root = Path(__file__).resolve().parent
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="")
    return {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(DRYRUN_OUT)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (argv, _) in DRYRUN_CELLS.items()}


def _dryrun_cells(children, deadline):
    """Wait for the children and read their artifacts: {artifact:
    record}."""
    recs = {}
    for name, proc in children.items():
        try:
            text, _ = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            _fail(f"[dryrun] the {name} cells' trace outlasted "
                  f"{DRYRUN_HANG_S} s")
        for art in DRYRUN_CELLS[name][1]:
            path = DRYRUN_OUT / f"{art}.json"
            if proc.returncode != 0 or not path.exists():
                _fail(f"[dryrun] the {name} cells exited {proc.returncode}:"
                      f" {text.strip()[-2000:]}")
            recs[art] = json.loads(path.read_text())
            if not recs[art].get("ok") or recs[art].get("skipped"):
                _fail(f"[dryrun] the {art} cell: {recs[art]}")
    return recs


def _serve_steps_1x1(torch, dev, card):
    """``make_prefill_step`` on ``DRYRUN_SERVE``'s prompts and its greedy
    ``make_decode_step`` steps for qwen3-0.6b at its published config
    (random weights from seed 0) on the card, with no mesh and inside a
    1x1 mesh's ``logical_axes``: every step's logits and the caches
    bit-equal, no collective; then one decode step walked on the card and
    on meta: FLOPs, bytes, ops and collectives equal, and no kernel's
    launch counter moved in the phase (the dense steps attend by the
    plain path, in both packages)."""
    from contextlib import nullcontext

    from repro_torch.configs import get_config
    from repro_torch.distributed import hlo_cost
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import (abstract_cache, abstract_params,
                                          init_params)
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from repro_torch.tree import leaves
    cfg = get_config("qwen3-0.6b")
    B, S, n = (DRYRUN_SERVE[k] for k in ("batch", "prompt", "steps"))
    L = S + n
    before = hlo_cost._launch_counts()
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    mesh = make_host_mesh(1, 1, device="cuda")

    def run(scope):
        t0 = time.perf_counter()
        with scope:
            logits, caches = make_prefill_step(cfg, L)(params,
                                                       {"tokens": tokens})
            outs = [logits]
            step = make_decode_step(cfg)
            for i in range(n):
                logits, caches = step(params, caches, outs[-1].argmax(
                    -1).to(torch.int32), S + i)
                outs.append(logits)
        torch.cuda.synchronize()
        return outs, caches, time.perf_counter() - t0

    plain, p_caches, plain_s = run(nullcontext())
    meshed, m_caches, mesh_s = run(logical_axes(mesh))
    equal = all(torch.equal(a, b) for a, b in
                zip(leaves([plain, list(p_caches)]),
                    leaves([meshed, list(m_caches)]), strict=True))
    calls = sum(c["calls"] for c in mesh.collectives.values())
    finite = all(bool(torch.isfinite(x).all()) for x in meshed)
    toks = [x.argmax(-1)[:, 0].tolist() for x in meshed]
    if not equal or calls or not finite:
        _fail(f"[dryrun] the 1x1 serve steps: bit-equal {equal}, "
              f"collectives {mesh.collectives}, finite {finite}")
    print(f"[dryrun] {card}: qwen3-0.6b ({cfg.n_layers} layers) prefill of "
          f"{B} x {S} "
          f"tokens and {n} greedy decode steps, unmeshed ({plain_s:.2f} s) "
          f"and on a 1x1 mesh ({mesh_s:.2f} s): logits and caches "
          f"bit-equal, 0 collectives; greedy tokens by step {toks}")
    token = meshed[-1].argmax(-1).to(torch.int32)
    t0 = time.perf_counter()
    on_card = hlo_cost.trace_step(make_decode_step(cfg), params, p_caches,
                                  token, L)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del params, p_caches, m_caches, on_card.result
    _free(torch)
    t0 = time.perf_counter()
    on_meta = hlo_cost.trace_step(
        make_decode_step(cfg), abstract_params(cfg),
        abstract_cache(cfg, B, L),
        torch.empty((B, 1), dtype=torch.int32, device="meta"), L)
    meta_s = time.perf_counter() - t0
    after = hlo_cost._launch_counts()
    a, b = on_card.report(), on_meta.report()
    keys = ("flops", "bytes", "bytes_min", "collectives",
            "collective_counts")
    if any(a[k] != b[k] for k in keys) or on_card.n_ops != on_meta.n_ops:
        _fail(f"[dryrun] the walker's card and meta counts of a decode "
              f"step differ: card {a}, {on_card.n_ops} ops; meta {b}, "
              f"{on_meta.n_ops} ops")
    if after != before:
        _fail(f"[dryrun] launch counters {before} -> {after} in the serve "
              f"steps")
    print(f"[dryrun] {card}: qwen3-0.6b decode step ({B} sequences, caches "
          f"of {L}) walked on the card ({card_s:.2f} s) and on meta "
          f"({meta_s:.2f} s): equal, {on_card.n_ops} ops, "
          f"{a['flops']:.6e} FLOPs, {a['bytes']:.6e} bytes, bytes_min "
          f"{a['bytes_min']:.6e}, collectives {a['collectives']['total']}; "
          f"launch counters unchanged {after}")
    return a


def _walker_card_vs_meta(torch, dev, card):
    """One 4g-style qwen3-0.6b train step (the published config, the
    unmeshed ``make_train_step``, a batch of 8 x 128) walked on the card
    and the same step walked on meta: FLOPs, bytes, ops and collectives
    equal, no kernel launch counter moved."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed import hlo_cost
    from repro_torch.launch.specs import batch_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (abstract_train_state,
                                        init_train_state, make_train_step)
    cfg, opt = get_config("qwen3-0.6b"), AdamWConfig()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in SyntheticLMData(cfg, 8, 128, 0).batch_at(0).items()}
    state = init_train_state(cfg, opt, seed=0, device=dev)
    before = hlo_cost._launch_counts()
    t0 = time.perf_counter()
    on_card = hlo_cost.trace_step(make_train_step(cfg, opt), state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    loss = float(on_card.result[1]["loss"])
    del state, batch, on_card.result
    _free(torch)
    t0 = time.perf_counter()
    on_meta = hlo_cost.trace_step(make_train_step(cfg, opt),
                                  abstract_train_state(cfg, opt),
                                  batch_specs(cfg, 8, 128))
    meta_s = time.perf_counter() - t0
    after = hlo_cost._launch_counts()
    a, b = on_card.report(), on_meta.report()
    keys = ("flops", "bytes", "bytes_min", "collectives",
            "collective_counts")
    if any(a[k] != b[k] for k in keys) or on_card.n_ops != on_meta.n_ops:
        _fail(f"[dryrun] the walker's card and meta counts of a train step "
              f"differ: card {a}, {on_card.n_ops} ops; meta {b}, "
              f"{on_meta.n_ops} ops")
    if after != before or not math.isfinite(loss):
        _fail(f"[dryrun] launch counters {before} -> {after}, loss {loss}")
    print(f"[dryrun] {card}: qwen3-0.6b train step of 8 x 128 walked on "
          f"the card ({card_s:.2f} s, loss {loss:.4f}) and on meta "
          f"({meta_s:.2f} s): equal, {on_card.n_ops} ops, "
          f"{a['flops']:.6e} FLOPs, {a['bytes']:.6e} bytes, bytes_min "
          f"{a['bytes_min']:.6e}, collectives {a['collectives']['total']}; "
          f"peak live bytes card {on_card.peak_bytes} meta "
          f"{on_meta.peak_bytes}; launch counters unchanged {after}")
    return a


def _auto_layouts():
    """``pick_layout`` (``kv_layout="auto"``'s trace) for qwen3-0.6b and
    recurrentgemma-9b at full width on counting 1x2 and 1x4 meshes, phase
    4's pool: {(arch, model width): report}."""
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.models.model import params_shape
    from repro_torch.serve.engine import (build_stack_geom, pick_layout,
                                          pool_geometry)
    out = {}
    for arch in ("qwen3-0.6b", "recurrentgemma-9b"):
        cfg = serve.serve_config(arch, smoke=False)
        geom = build_stack_geom(cfg, AUTO_POOL["page_size"])
        pool = pool_geometry(cfg, geom, AUTO_POOL["n_pages"],
                             AUTO_POOL["page_size"], AUTO_POOL["max_seqs"],
                             AUTO_POOL["max_pages"])
        for m in (2, 4):
            axes = {"data": 1, "model": m}
            blocks = shard_params(cfg, params_shape(cfg),
                                  CountingMesh(axes), "meta")
            t0 = time.perf_counter()
            chosen, rep = pick_layout(cfg, geom, axes, blocks, pool,
                                      AUTO_POOL["max_pages"])
            cand = {k: v["collective_bytes"]
                    for k, v in rep["candidates"].items()}
            if chosen != min(("shard", "replicate"),
                             key=lambda k: (cand[k], k != "shard")):
                _fail(f"[dryrun] auto layout {chosen} is not the argmin of "
                      f"{cand}")
            out[(arch, m)] = rep
            print(f"[dryrun] kv_layout auto, {arch} at full width on a "
                  f"counting 1x{m} mesh: {chosen} (collective bytes: shard "
                  f"{cand['shard']:.0f}, replicate {cand['replicate']:.0f}; "
                  f"comms share shard "
                  f"{rep['candidates']['shard']['predicted_comms_share']:.3e}"
                  f", replicate "
                  f"{rep['candidates']['replicate']['predicted_comms_share']:.3e}"
                  f"), {time.perf_counter() - t0:.2f} s")
    return out


def phase_dryrun(torch, dev, card):
    """Phase 4l: the dry run on the host, beside steps on the card.  The
    ``DRYRUN_CELLS`` (``launch.dryrun`` processes, started first),
    ``kv_layout="auto"``'s choice at full width on counting 1x2 and 1x4
    meshes, the walker's card and meta counts of a 4g-style train step,
    and the 1x1 serve steps on the card (:func:`_serve_steps_1x1`),
    reported against ``DRYRUN_LIMIT_S``."""
    t0 = time.perf_counter()
    children = _dryrun_children()
    try:
        _auto_layouts()
        _walker_card_vs_meta(torch, dev, card)
        _free(torch)
        _serve_steps_1x1(torch, dev, card)
        recs = _dryrun_cells(children, t0 + DRYRUN_HANG_S)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    q8, dense = (recs[f"qwen3-0.6b_decode_32k_single{t}"]["memory"]
                 for t in ("_q8", ""))
    if (q8["argument_size_in_bytes"] - q8["alias_size_in_bytes"]
            >= dense["argument_size_in_bytes"]
            - dense["alias_size_in_bytes"]):
        _fail(f"[dryrun] the int8 decode cell holds no fewer parameter "
              f"bytes than the dense one: {q8} vs {dense}")
    for r in recs.values():
        rl, mem = r["roofline"], r["memory"]
        calls = {k: int(v) for k, v in r["collective_counts"].items() if v}
        byts = {k: int(v) for k, v in r["collectives"].items()
                if v and k != "total"}
        label = (f"{r['arch']} {r['shape']} {r['mesh']}"
                 + (" int8" if r["quantized"] else ""))
        print(f"[dryrun] {label} ({r['n_devices']} "
              f"devices, traced in {r['lower_s']} s, {r['n_ops']} ops): "
              f"compute {rl['compute_s']:.6f} s, memory "
              f"{rl['memory_s']:.6f} s (max {rl['memory_s_max']:.6f}), "
              f"collective {rl['collective_s']:.6f} s, bottleneck "
              f"{rl['bottleneck']} (H100 constants: 989e12 FLOP/s, "
              f"3.35e12 B/s, 50e9 B/s); collective calls {calls}, bytes "
              f"{byts}; bytes per device {r['bytes_per_device_live']} "
              f"(argument {mem['argument_size_in_bytes']}, alias "
              f"{mem['alias_size_in_bytes']}, temp "
              f"{mem['temp_size_in_bytes']}); useful_flops_ratio "
              f"{r['useful_flops_ratio']:.6f}")
    took = time.perf_counter() - t0
    print(f"[dryrun] phase 4l took {took:.1f} s: "
          f"{'within' if took <= DRYRUN_LIMIT_S else 'OVER'} its "
          f"{DRYRUN_LIMIT_S:.0f} s budget")
    return recs


# -- phase 4i: the legacy per-sequence path ---------------------------------
LEGACY_ARGV = SERVE_ARGV + ["--legacy"]


def phase_legacy(torch, pa, card, serve_outs):
    """Phase 4's requests through ``--legacy`` (``PagedServer``, attention
    through ``paged_decode_attention`` on the kernel): the same tokens as
    phase 4, exactly (layers) x (decode calls) kernel launches; then the
    host ms of decode calls over 4 slots on the same server.  Returns the
    launches."""
    from repro_torch.launch import serve
    pa.launches = 0
    t0 = time.perf_counter()
    finished, srv, _ = serve.main(LEGACY_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = pa.launches, srv.decode_calls
    n_layers = srv.cfg.n_layers
    if calls == 0 or launches != n_layers * calls:
        _fail(f"[legacy] kernel launches {launches} != {n_layers} layers x "
              f"{calls} decode calls")
    outs = {r.rid: r.out for r in finished}
    if outs != serve_outs:
        _fail(f"[legacy] tokens {outs} differ from phase 4's {serve_outs}")
    print(f"[legacy] {srv.cfg.name}: tokens of all {len(outs)} requests "
          f"equal phase 4's; kernel launches {launches} = {n_layers} layers "
          f"x {calls} decode calls; {wall:.3f} s wall (params init "
          f"included); VBI stats {srv.kv.stats}")
    # steady state: 4 sequences admitted, 4 prompt tokens each fed, then
    # 16 more calls timed one by one on the host clock
    slots = list(range(srv.kv.max_seqs))
    for s in slots:
        srv.admit(s)
    toks = torch.arange(1, len(slots) + 1, dtype=torch.int32)[:, None]
    for _ in range(4):
        srv.decode(toks, slots)
    ms = []
    for _ in range(16):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        srv.decode(toks, slots)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t1) * 1e3, 3))
    for s in slots:
        srv.evict(s)
    print(f"[legacy] {card}: {srv.cfg.name}: host ms per decode call over "
          f"{len(slots)} slots (16 calls at 5-20 tokens): median "
          f"{statistics.median(ms):.3f}, min {min(ms):.3f}, max "
          f"{max(ms):.3f}; the serve made {calls} decode calls")
    return launches


# -- prefix sharing: the prefix cache, shared and COW pages, overlap --------
#: phase 4c: the qwen3 serve's settings with a 252-token system prompt in
#: front of every prompt (31 full pages of 8 and 4 tokens: each 256-token
#: prompt fills 32 pages, its last holding 4 system tokens and 4 of its
#: own, so a later hit maps 31 pages read-only and COW-clones the 32nd)
SHARED_PREFIX = 252
PREFIX_ARGV = [a for a in SERVE_ARGV if a != "--no-prefix-cache"] + [
    "--shared-prefix", str(SHARED_PREFIX)]
PREFIX_MODES = (("cache off", ["--no-prefix-cache"]), ("cache on", []),
                ("cache on + overlap", ["--overlap"]))


def phase_prefix(torch, pa, card):
    """Phase 4c: full-width qwen3-0.6b served three times on the same
    weights (seed 0) with a shared 252-token system prompt — cache off,
    cache on, cache on with overlap — each request against the plain
    greedy decode of its whole prompt (taken once, in the first serve:
    the three serves' tokens are then held identical), launches 28 x
    token steps, the cache's hits, reuse and COW clones as the
    schedule makes them, the host mirror exact and the pool drained; then
    a horizon over shared and COW pages and the overlap's staged half
    under ``set_sync_debug_mode("error")``; then one decode tick timed,
    overlap off against on.  Returns kernel launches by serve."""
    from repro_torch.launch import serve

    launches, outs, steps = {}, {}, {}
    for mode, extra in PREFIX_MODES:
        box = {}

        def run():
            box["out"] = serve.main(PREFIX_ARGV + extra)
            return box["out"]
        t0 = time.perf_counter()
        launches[mode], engine = phase_serve(
            torch, pa, card, run, f"prefix {mode}",
            reference=mode == PREFIX_MODES[0][0])
        finished, sched = box["out"][0], box["out"][2]
        alloc, cache = engine.alloc, sched.prefix_cache
        outs[mode] = {r.rid: r.out for r in finished}
        steps[mode] = engine.stats["token_steps"]
        st = sched.stats
        if engine.free_pages != alloc.free_pages:
            _fail(f"[prefix] {mode}: device free pages {engine.free_pages} "
                  f"!= host mirror {alloc.free_pages}")
        if cache is not None:
            hits = st["prefix_hits"]
            if (hits < 1 or st["prefix_tokens_reused"] != SHARED_PREFIX * hits
                    or alloc.stats["cow_clones"] != hits):
                _fail(f"[prefix] {mode}: hits {hits}, tokens reused "
                      f"{st['prefix_tokens_reused']}, COW clones "
                      f"{alloc.stats['cow_clones']}; want hits >= 1, "
                      f"{SHARED_PREFIX} tokens and one clone per hit")
            print(f"[prefix] {mode}: hit rate {cache.hit_rate:.3f}, cache "
                  f"stats {cache.stats}; sched stats {dict(st)}; allocator "
                  f"stats {alloc.stats}; cached pages {cache.n_pages}")
            alloc.release(cache.evict(cache.n_pages))
        if alloc.pages_in_use != 0:
            _fail(f"[prefix] {mode}: {alloc.pages_in_use} pages in use "
                  f"after the drain")
        if "overlap" in mode and st["overlap_staged_ticks"] <= 0:
            _fail(f"[prefix] {mode}: no tick was staged under a horizon")
        print(f"[prefix] {mode}: {steps[mode]} token steps, "
              f"{st['steps']} ticks, overlap-staged ticks "
              f"{st['overlap_staged_ticks']}, sync reads ready/wait "
              f"{st['sync_device_ready']}/{st['sync_device_wait']}; pool "
              f"drained to 0 pages, mirror exact ({time.perf_counter() - t0:.1f} s)")
        if mode != PREFIX_MODES[-1][0]:
            del engine, finished, sched, alloc, cache, box
            _free(torch)
    if not outs["cache off"] == outs["cache on"] == outs[
            "cache on + overlap"]:
        _fail("[prefix] the three serves' tokens differ")
    if not steps["cache on"] < steps["cache off"]:
        _fail(f"[prefix] cache-on token steps {steps['cache on']} not below "
              f"cache-off {steps['cache off']}")
    print(f"[prefix] the three serves' tokens identical per request; token "
          f"steps cache off {steps['cache off']}, on {steps['cache on']}, "
          f"on + overlap {steps['cache on + overlap']}")
    _prefix_sync_free(torch, engine)
    _overlap_tick(torch, engine, card)
    return launches


def _prefix_sync_free(torch, engine):
    """On the card, with every host sync an error: (1) one decode horizon
    over slots 1 and 2 mapping the same cached pages and slot 3 holding a
    COW clone; (2) the overlap's staged half — ``_evict_cache``, then
    ``_admit`` with a cache hit (``map_shared`` + ``cow_break``) and
    ``_prefill_stage`` — while a decode horizon is in flight."""
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.scheduler import Scheduler

    alloc, dev, k = engine.alloc, engine.device, 8
    S = engine.max_seqs
    prompt = torch.arange(1, 21, dtype=torch.int32, device=dev)   # 20
    toks = torch.zeros((S, 20), dtype=torch.int32, device=dev)
    toks[0] = prompt
    n = torch.tensor([20, 0, 0, 0], dtype=torch.int32, device=dev)
    blocks = [alloc.alloc(0)]
    alloc.reserve_span(blocks[0], 20, k)
    engine.prefill_chunk(toks, n)
    pages = alloc.page_row(blocks[0], 2)
    alloc.retain(pages, from_block=blocks[0])          # cache custody
    for s in (1, 2):
        blocks.append(alloc.alloc(s))
        alloc.reserve_span(blocks[s], 16, k)
        alloc.map_shared(blocks[s], pages, 16)
    blocks.append(alloc.alloc(3))
    alloc.reserve_span(blocks[3], 12, k + 1)
    alloc.map_shared(blocks[3], pages[:1], 8)
    alloc.cow_break(blocks[3], 1, pages[1], 12)
    tok = torch.full((S,), 7, dtype=torch.int32, device=dev)
    mask = torch.ones((S,), dtype=torch.bool, device=dev)
    steps = torch.full((S,), k, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        block = engine.decode_many(tok, mask, steps, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    block = block.cpu()
    if block.shape != (k, S) or bool((block < 0).any()) or \
            not torch.equal(block[:, 1], block[:, 2]):
        _fail(f"[prefix] horizon over shared pages returned {block.tolist()}")
    for blk in blocks:
        alloc.free(blk)
    alloc.release(pages)
    if alloc.pages_in_use != 0 or engine.free_pages != alloc.free_pages:
        _fail("[prefix] shared-page horizon left pages behind")
    print(f"[sync] prefix: decode_many(K={k}) over 2 slots mapping the same "
          f"2 cached pages, 1 on a COW clone and 1 on its own pages under "
          f"set_sync_debug_mode('error'): no host sync; the two sharing "
          f"slots emitted the same tokens; pages back to 0")

    # (2) the staged half of an overlap tick, a horizon in flight.  A spin
    # kernel queued right behind the horizon, before the event its
    # dispatch records, keeps that event pending while the staged half
    # runs (the host enqueues a horizon slower than the card runs it)
    sched = Scheduler(engine, prefill_chunk=8, decode_horizon=k,
                      overlap=True, prefix_cache=PrefixCache(8))
    rng = torch.Generator().manual_seed(4)
    system = torch.randint(0, engine.cfg.vocab, (20,), generator=rng).tolist()
    sched.add_request(torch.randint(0, engine.cfg.vocab, (16,),
                                    generator=rng).tolist(), max_new=2)
    sched.run()                          # its 2 pages stay cached, unpinned
    sched.add_request(system + [5, 6], max_new=40)
    while not sched.prefix_cache.n_pages > 2 or sched._pending is None:
        sched.step()                     # system prompt cached, decoding
    decode_many = engine.decode_many

    def spun(*args):
        block = decode_many(*args)
        torch.cuda._sleep(int(400e6))    # about 0.2 s at 2 GHz
        return block
    engine.decode_many = spun
    sched.step()                         # a horizon behind the spin
    engine.decode_many = decode_many
    sched.add_request(system[:12] + [9, 9, 9], max_new=4)
    reconcile = sched._decode_reconcile

    def reconcile_after_staging():
        torch.cuda.set_sync_debug_mode("default")
        in_flight.append(not sched._pending[1].query())
        return reconcile()
    sched._decode_reconcile = reconcile_after_staging
    in_flight = []
    before = (sched.stats["prefix_hits"], engine.alloc.stats["cow_clones"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        evicted = sched._evict_cache(2)
        sched.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sched._decode_reconcile = reconcile
    after = (sched.stats["prefix_hits"], engine.alloc.stats["cow_clones"])
    if evicted != 2 or after != (before[0] + 1, before[1] + 1) or \
            in_flight != [True]:
        _fail(f"[prefix] staged half: evicted {evicted} (want 2), hits and "
              f"COW clones {before} -> {after} (want +1 each), horizon in "
              f"flight at the deferred read {in_flight}")
    done = sched.run()
    cache = sched.prefix_cache
    alloc.release(cache.evict(cache.n_pages))
    if alloc.pages_in_use != 0 or engine.free_pages != alloc.free_pages or \
            sorted(len(r.out) for r in done) != [2, 4, 40]:
        _fail("[prefix] the staged-half run did not drain cleanly")
    print(f"[sync] prefix: the overlap's staged half (_evict_cache of 2 "
          f"cold pages, _admit with a hit mapping 1 page and COW-cloning "
          f"the 2nd, _prefill_stage) under set_sync_debug_mode('error') "
          f"while the horizon's event was pending: no host sync")


def _overlap_tick(torch, engine, card):
    """Steady decode ticks (4 slots, K 8), overlap off against on, in
    turns (off, on, on, off, twice): each tick's host ms (the host clock
    around one ``step()``; 4 ticks a run, a synchronize before and after
    them), the median per mode over its 16 ticks, and the device-busy ms
    of one profiled tick in the first run of each mode."""
    import statistics

    from repro_torch.serve.scheduler import Scheduler

    ticks = {False: [], True: []}
    for i, overlap in enumerate((False, True, True, False) * 2):
        sched = Scheduler(engine, prefill_chunk=8, decode_horizon=8,
                          overlap=overlap)
        for r in range(4):
            sched.add_request([1 + r, 2, 3, 4], max_new=96)
        for _ in range(3):                     # prefill, first horizons
            sched.step()
        torch.cuda.synchronize()
        run = []
        for _ in range(4):
            t0 = time.perf_counter()
            sched.step()
            run.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ticks[overlap] += run
        busy = ""
        if i < 2:
            busy_ms, _ = _kernel_busy(torch, sched.step)
            busy = (", device busy not measured (the profiler saw no CUDA "
                    "kernel events)" if busy_ms is None else
                    f", device busy {busy_ms:.3f} ms in one profiled tick")
        sched.run()
        print(f"[overlap] {card}: {engine.cfg.name} decode ticks (4 slots, "
              f"K 8), overlap {'on' if overlap else 'off'}: host ms "
              f"{[round(t, 3) for t in run]}{busy}; reads found the "
              f"horizon done/waited {sched.stats['sync_device_ready']}/"
              f"{sched.stats['sync_device_wait']}")
    med = {k: statistics.median(v) for k, v in ticks.items()}
    print(f"[overlap] {card}: median host ms per decode tick over 16 "
          f"ticks each: overlap off {med[False]:.3f} (range "
          f"{min(ticks[False]):.3f}-{max(ticks[False]):.3f}), on "
          f"{med[True]:.3f} ({min(ticks[True]):.3f}-{max(ticks[True]):.3f});"
          f" on / off {med[True] / med[False]:.3f}")
    if engine.alloc.pages_in_use != 0:
        _fail("[overlap] the timing runs left pages behind")


# -- the host swap tier: preemption to host memory, resume by one scatter ---
#: phase 4d: 6 requests of 60 own tokens + 40 new on 4 slots, a pool of 33
#: pages of 8 (32 usable) with 16-page rows, horizon 8, prefill chunks of 8:
#: lifetimes of 13 pages on 4 slots outgrow the pool, so the youngest
#: running requests are preempted
SWAP_NEW, SWAP_TIER = 40, 64
SWAP_ARGV = ["--no-smoke", "--arch", "qwen3-0.6b", "--attn-impl", "kernel",
             "--requests", "6", "--max-new", str(SWAP_NEW), "--batch-slots",
             "4", "--prompt-len", "60", "--decode-horizon", "8",
             "--prefill-chunk", "8", "--n-pages", "33",
             "--max-pages-per-seq", "16", "--no-prefix-cache", "--device",
             "cuda"]
SWAP_MODES = (("discard", []),
              ("swap", ["--host-swap-pages", str(SWAP_TIER)]),
              ("swap + overlap", ["--host-swap-pages", str(SWAP_TIER),
                                  "--overlap"]))


class _SwapClock:
    """While entered, times every ``VBIAllocator.swap_out`` and
    ``swap_in`` on the host clock, with the image's bytes, pages and tier
    charge beside each swap-out."""

    def __init__(self):
        from repro_torch.core.vbi.blocks import VBIAllocator
        self.alloc_cls = VBIAllocator
        self.outs, self.ins = [], []

    def __enter__(self):
        al = self.alloc_cls
        self.saved = (al.swap_out, al.swap_in)
        swap_out, swap_in = self.saved

        def timed_out(alloc, blk):
            t0 = time.perf_counter()
            ok = swap_out(alloc, blk)
            if ok:
                img = alloc.swap.images[blk.bid]
                self.outs.append(((time.perf_counter() - t0) * 1e3,
                                  img.k.nbytes + img.v.nbytes + sum(
                                      a.nbytes for a in img.aux or ()),
                                  img.n_pages, img.charge))
            return ok

        def timed_in(alloc, blk, slot, reserve_pages=None):
            t0 = time.perf_counter()
            out = swap_in(alloc, blk, slot, reserve_pages)
            self.ins.append((time.perf_counter() - t0) * 1e3)
            return out

        al.swap_out, al.swap_in = timed_out, timed_in
        return self

    def __exit__(self, *exc):
        self.alloc_cls.swap_out, self.alloc_cls.swap_in = self.saved

    def line(self):
        return (f"swap-outs (host ms, image bytes, pages, charge) "
                f"{[(round(ms, 3), b, n, c) for ms, b, n, c in self.outs]}; "
                f"swap-ins host ms {[round(ms, 3) for ms in self.ins]}")


def phase_swap(torch, pa, card):
    """Phase 4d: full-width qwen3-0.6b (random weights from seed 0) served
    three times on the same schedule — discard, swap (a host tier of 64
    pages), swap + overlap — launches 28 x token steps, the discard
    serve's tokens against the plain greedy decode and the other two
    serves' identical to it, swap-outs = swap-ins >= 1 with fewer prefill
    tokens than discard, tier and pool drained and the mirror exact; the
    host ms of each swap-out and swap-in and the image bytes beside a
    ``copy_`` of the same bytes to pinned host memory and back; then a
    ``swap_in`` while a horizon's event is pending, under
    ``set_sync_debug_mode("error")``; then the device ms of the restore
    and the snapshot of a 10-page image.  Returns kernel launches by
    serve."""
    from repro_torch.launch import serve

    launches, outs, stats = {}, {}, {}
    for mode, extra in SWAP_MODES:
        box = {}

        def run():
            box["out"] = serve.main(SWAP_ARGV + extra)
            return box["out"]
        t0 = time.perf_counter()
        with _SwapClock() as clock:
            launches[mode], engine = phase_serve(
                torch, pa, card, run, f"swap {mode}", n_new=SWAP_NEW,
                reference=mode == "discard")
        finished, sched = box["out"][0], box["out"][2]
        alloc, st = engine.alloc, sched.stats
        outs[mode] = {r.rid: r.out for r in finished}
        stats[mode] = dict(st, token_steps=engine.stats["token_steps"])
        if engine.free_pages != alloc.free_pages or alloc.pages_in_use != 0:
            _fail(f"[swap] {mode}: pool not drained or mirror off: device "
                  f"free {engine.free_pages}, mirror {alloc.free_pages}")
        if mode == "discard":
            if st["preemptions"] < 1 or st["swap_outs"] != 0:
                _fail(f"[swap] discard: preemptions {st['preemptions']}, "
                      f"swap-outs {st['swap_outs']}")
        else:
            a = alloc.stats
            if not (st["swap_outs"] == st["swap_ins"] == a["swap_outs"]
                    == a["swap_ins"] >= 1) or alloc.swap.used_pages != 0:
                _fail(f"[swap] {mode}: swap-outs {st['swap_outs']}, "
                      f"swap-ins {st['swap_ins']}, tier pages held "
                      f"{alloc.swap.used_pages}")
            print(f"[swap] {card}: {mode}: {clock.line()}; bytes out/in "
                  f"{a['swap_bytes_out']}/{a['swap_bytes_in']}")
            stats[mode]["outs"] = clock.outs
        print(f"[swap] {mode}: {stats[mode]['token_steps']} token steps, "
              f"preemptions {st['preemptions']}, swap-outs "
              f"{st['swap_outs']}, swap-ins {st['swap_ins']}, prefill "
              f"tokens {st['prefill_tokens']}, overlap-staged ticks "
              f"{st['overlap_staged_ticks']}; tier and pool drained, mirror "
              f"exact ({time.perf_counter() - t0:.1f} s)")
        if mode != SWAP_MODES[-1][0]:
            del engine, finished, sched, alloc, box
            _free(torch)
    if not outs["discard"] == outs["swap"] == outs["swap + overlap"]:
        _fail("[swap] the three serves' tokens differ")
    for mode in ("swap", "swap + overlap"):
        if not stats[mode]["prefill_tokens"] < stats["discard"][
                "prefill_tokens"]:
            _fail(f"[swap] {mode} prefilled {stats[mode]['prefill_tokens']}"
                  f" tokens, discard {stats['discard']['prefill_tokens']}")
    if not stats["swap + overlap"]["overlap_staged_ticks"] > 0:
        _fail("[swap] no tick was staged under a horizon")
    print(f"[swap] the three serves' tokens identical per request; prefill "
          f"tokens discard {stats['discard']['prefill_tokens']}, swap "
          f"{stats['swap']['prefill_tokens']}, swap + overlap "
          f"{stats['swap + overlap']['prefill_tokens']}")
    # the yardstick: the largest image's bytes copied device -> pinned host
    # and back with one copy_ each
    n_bytes = max(b for _, b, _, _ in stats["swap"]["outs"])
    dev_buf = torch.ones(n_bytes, dtype=torch.uint8, device=engine.device)
    host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    d2h = _kernel_ms(torch, lambda: host.copy_(dev_buf, non_blocking=True))
    h2d = _kernel_ms(torch, lambda: dev_buf.copy_(host, non_blocking=True))
    print(f"[swap] {card}: yardstick for an image of {n_bytes} B: copy_ "
          f"device -> pinned host {d2h:.4f} ms, pinned host -> device "
          f"{h2d:.4f} ms")
    del dev_buf, host
    _swap_sync_free(torch, engine)
    _scatter_probe(torch, engine, card)
    return launches, outs["discard"]


def _scatter_probe(torch, engine, card):
    """Device ms of the restore and the snapshot of a 10-page image (the
    largest of phase 4d) on the drained pool, each queued behind a spin
    kernel so that the host's enqueue drops out: ``restore_block`` into
    slot 0 (``free_top`` put back after each call, so every call pops the
    same pages) and ``snapshot_block``'s gather, beside a contiguous
    ``copy_`` of the same bytes and the byte bound (the image read once
    and written once).  The pool's bookkeeping is put back afterwards."""
    from repro_torch.core.vbi.kvcache import restore_block, snapshot_block

    st, n = engine.state, 10
    k = torch.ones_like(st.k_pages[:, :n])
    v = torch.ones_like(k)
    flat = torch.empty((2,) + tuple(k.shape), device=k.device)
    both = torch.stack([k, v])
    saved = {f: getattr(st, f).clone() for f in (
        "page_table", "seq_lens", "slot_active", "free_top",
        "page_refcounts")}

    def restore():
        restore_block(st, 0, k, v, n, n * engine.page_size)
        st.free_top.add_(n)
    ms = {"restore_block": _kernel_ms(torch, restore),
          "snapshot_block": _kernel_ms(
              torch, lambda: snapshot_block(st, 0, n)),
          "copy_": _kernel_ms(torch, lambda: flat.copy_(both))}
    for f, t in saved.items():
        getattr(st, f).copy_(t)
    n_bytes = 2 * both.nelement() * both.element_size()
    print(f"[swap] {card}: a {n}-page image ({n_bytes // 2} B) on the "
          f"device: {', '.join(f'{k_} {v_:.4f} ms' for k_, v_ in ms.items())}"
          f" (copy_: a contiguous copy of the same bytes); byte bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return ms


def _swap_sync_free(torch, engine):
    """A block of 20 tokens swapped out of slot 0; a horizon over slot 1
    with a spin kernel queued behind it, before the event its dispatch
    would record; then ``swap_in`` into slot 2 with every host sync an
    error: it returns while the event is pending, and the restored pages
    equal the image bit for bit."""
    import numpy as np

    alloc, dev, k, S = engine.alloc, engine.device, 8, engine.max_seqs
    toks = torch.zeros((S, 20), dtype=torch.int32, device=dev)
    toks[0] = torch.arange(1, 21, dtype=torch.int32, device=dev)
    toks[1] = torch.arange(21, 41, dtype=torch.int32, device=dev)
    blocks = [alloc.alloc(s) for s in (0, 1)]
    for blk in blocks:
        alloc.reserve_span(blk, 20, k)
    engine.prefill_chunk(toks, torch.tensor([20, 20, 0, 0], dtype=torch.int32,
                                            device=dev))
    for blk in blocks:
        alloc.commit(blk, 20)
        alloc.unreserve(blk, 20)
    alloc.reserve_span(blocks[1], 20, k)
    if not alloc.swap_out(blocks[0]):
        _fail("[swap] sync-free check: swap_out refused")
    img = alloc.swap.images[blocks[0].bid]
    mask = torch.arange(S, device=dev) == 1
    steps = torch.full((S,), k, dtype=torch.int32, device=dev)
    tok = torch.full((S,), 7, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    block = engine.decode_many(tok, mask, steps, k)
    torch.cuda._sleep(int(400e6))        # about 0.2 s at 2 GHz
    event = engine.ready_event(block)
    torch.cuda.set_sync_debug_mode("error")
    try:
        alloc.swap_in(blocks[0], 2, reserve_pages=alloc.pages_for(20 + k))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending = not event.query()
    torch.cuda.synchronize()
    back = alloc.snapshot_image(blocks[0])
    if not (pending and np.array_equal(back.k, img.k)
            and np.array_equal(back.v, img.v)):
        _fail(f"[swap] swap_in under a pending horizon: event pending at "
              f"return {pending}, restored pages equal the image "
              f"{np.array_equal(back.k, img.k)}")
    for blk in blocks:
        alloc.free(blk)
    if alloc.pages_in_use != 0 or engine.free_pages != alloc.free_pages:
        _fail("[swap] the sync-free check left pages behind")
    print(f"[sync] swap: swap_in of a {img.n_pages}-page image "
          f"({img.k.nbytes + img.v.nbytes} B) into slot 2 under "
          f"set_sync_debug_mode('error') while a horizon's event was "
          f"pending: no host sync, the event still pending at return, the "
          f"restored pages equal the image bit for bit")


# -- open-loop traffic and telemetry ------------------------------------------
#: phase 4e: full-width qwen3-0.6b (params from seed 0, as phase 4's) on 4
#: slots, pages of 8, 129 pages, horizon 8, prefill chunks of 8, the prefix
#: cache on (the launcher's default); 16 requests of the seeded mixed
#: workload (chat, RAG with a 16-token shared system prompt, agent,
#: summarization), unclipped, at 2 requests/s
TRAFFIC_N, TRAFFIC_RATE = 16, 2.0
TRAFFIC_PROCESSES = ("poisson", "bursty")
#: the SLO goodput is stated at: a chat-like first token within 1 s and
#: 100 ms per output token after it
SLO_TTFT, SLO_TPOT = 1.0, 0.1
TRAFFIC_ARGV = ["--no-smoke", "--arch", "qwen3-0.6b", "--attn-impl", "kernel",
                "--requests", str(TRAFFIC_N), "--rate", str(TRAFFIC_RATE),
                "--batch-slots", "4", "--decode-horizon", "8",
                "--prefill-chunk", "8", "--slo-ttft", str(SLO_TTFT),
                "--slo-tpot", str(SLO_TPOT), "--metrics", "--overlap",
                "--device", "cuda"]
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traffic"
SPANS = {"tick.admit", "tick.prefill_stage", "tick.prefill_launch",
         "tick.prefill_finish", "tick.decode_dispatch",
         "tick.decode_reconcile"}


class _DriverSpy:
    """While entered, keeps every ``TrafficDriver`` whose ``run`` is
    called (the launcher's, to read its latency accountant)."""

    def __init__(self):
        from repro_torch.serve.traffic import TrafficDriver
        self.cls, self.drivers = TrafficDriver, []

    def __enter__(self):
        run = self.saved = self.cls.run
        drivers = self.drivers

        def spied(drv, *args, **kw):
            drivers.append(drv)
            return run(drv, *args, **kw)
        self.cls.run = spied
        return self

    def __exit__(self, *exc):
        self.cls.run = self.saved


def _traffic_engine(engine_cls, cfg, params, dev, **kw):
    return engine_cls(cfg, params, page_size=8, max_seqs=4, n_pages=129,
                      attn_impl="kernel", device=dev, **kw)


def _drained(torch, engine, sched, tag):
    """Drop the prefix cache's pages; the pool must then be empty and the
    host mirror equal to the device's free count."""
    cache = sched.prefix_cache
    if cache is not None:
        engine.alloc.release(cache.evict(cache.n_pages))
    if engine.alloc.pages_in_use != 0 or \
            engine.free_pages != engine.alloc.free_pages:
        _fail(f"[traffic] {tag}: pool not drained or mirror off")


def _check_launches(n, engine, tag):
    """The kernel's count over one serve must equal (full + ring layers,
    28) x the serve's token steps; returns the token steps."""
    steps = engine.stats["token_steps"]
    n_attn = engine.geom.n_full + engine.geom.n_ring
    if n != n_attn * steps or n == 0:
        _fail(f"[traffic] {tag}: kernel launches {n} != {n_attn} x {steps} "
              f"token steps")
    return steps


def _counted(pa, engine, tag, run):
    """``run()`` with the kernel's count set to 0 just before it and
    checked just after."""
    pa.launches = 0
    out = run()
    return out, pa.launches, _check_launches(pa.launches, engine, tag)


def phase_traffic(torch, pa, card, dev, swap_outs):
    """Phase 4e: open-loop traffic and telemetry on full-width qwen3-0.6b.
    (1) each trace (poisson, bursty) replayed open-loop on the virtual
    clock equals its closed-loop run and the plain greedy decode, with
    launches 28 x token steps and the pool drained; (2) the launcher's
    wall-clock path with ``--traffic P --trace OUT --metrics --overlap``:
    its trace passes the checker with every request arrived and finished
    and all six tick spans, its tokens equal (1)'s; TTFT and TPOT p50 and
    p99, throughput and goodput at the stated SLO, the trace's events and
    bytes; then a decode tick's host ms traced and untraced; (3) the
    overlap's staged half with tracing on under
    ``set_sync_debug_mode("error")``; (4) phase 4d's schedule traced, swap
    and discard: the checker passes, the tokens equal phase 4d's, and
    each preempted request's TTFT and time from preemption to its next
    token.  Returns kernel launches by serve."""
    from repro_torch.launch import serve
    from repro_torch.models import model as tm
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.telemetry import check_trace, read_jsonl
    from repro_torch.serve.traffic import (TrafficDriver, VirtualClock,
                                           make_trace)

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    cfg = serve.serve_config("qwen3-0.6b", smoke=False)
    params = init_params(cfg, seed=0, device=dev)
    launches = {}
    for proc in TRAFFIC_PROCESSES:
        t0 = time.perf_counter()
        trace = make_trace(cfg.vocab, TRAFFIC_N, rate=TRAFFIC_RATE, seed=0,
                           process=proc)
        outs, steps = {}, {}
        for mode in ("closed loop", "open loop, virtual clock"):
            engine = _traffic_engine(PagedEngine, cfg, params, dev)
            sched = Scheduler(engine, prefill_chunk=8, decode_horizon=8,
                              prefix_cache=PrefixCache(8),
                              overlap=mode != "closed loop")

            def run():
                if mode == "closed loop":
                    for tr in trace:
                        sched.add_request(tr.prompt, tr.max_new, rid=tr.rid)
                    return sched.run()
                return TrafficDriver(sched, trace, clock=VirtualClock()).run()
            fin, launches[f"{proc} {mode}"], steps[mode] = _counted(
                pa, engine, f"{proc} {mode}", run)
            outs[mode] = {r.rid: r.out for r in fin}
            if sorted(outs[mode]) != list(range(TRAFFIC_N)) or any(
                    len(outs[mode][tr.rid]) != tr.max_new for tr in trace):
                _fail(f"[traffic] {proc} {mode}: requests unfinished")
            _drained(torch, engine, sched, f"{proc} {mode}")
            if mode != "closed loop":
                continue
            for r in sorted(fin, key=lambda r: r.rid):
                n, gap = _reference_tokens(torch, tm, cfg, params, r, dev)
                if gap is not None:
                    print(f"[traffic] {proc} req {r.rid}: {n}/{len(r.out)} "
                          f"tokens equal to the plain greedy reference, "
                          f"stopped at a top-two gap {gap:.3e}")
        if outs["closed loop"] != outs["open loop, virtual clock"]:
            _fail(f"[traffic] {proc}: open loop != closed loop")
        mix = {}
        for tr in trace:
            mix[tr.profile] = mix.get(tr.profile, 0) + 1
        print(f"[traffic] {proc}: {TRAFFIC_N} requests, mix {mix}, "
              f"{sum(len(tr.prompt) for tr in trace)} prompt and "
              f"{sum(tr.max_new for tr in trace)} new tokens; the virtual-"
              f"clock open loop equals the closed loop and the plain greedy "
              f"decode per request; token steps closed {steps['closed loop']}"
              f", open {steps['open loop, virtual clock']} (launches 28 x "
              f"each); pools drained")
        del engine, sched
        _free(torch)

        path = TRACE_DIR / f"{proc}.jsonl"
        with _DriverSpy() as spy:
            t1 = time.perf_counter()
            pa.launches = 0
            fin, engine, sched = serve.main(TRAFFIC_ARGV + [
                "--traffic", proc, "--trace", str(path)])
            n = pa.launches
        wall = time.perf_counter() - t1
        steps_w = _check_launches(n, engine, f"{proc} launcher")
        launches[f"{proc} launcher"] = n
        events = read_jsonl(str(path))
        summary = check_trace(events)
        evs = [e["ev"] for e in events if e["type"] == "req"]
        spans = {e["name"] for e in events if e["type"] == "span"}
        if not (evs.count("arrive") == evs.count("finish") == TRAFFIC_N
                and spans == SPANS):
            _fail(f"[traffic] {proc} launcher: arrive {evs.count('arrive')}"
                  f", finish {evs.count('finish')}, spans {sorted(spans)}")
        if {r.rid: r.out for r in fin} != outs["closed loop"]:
            _fail(f"[traffic] {proc} launcher: tokens differ from check 1")
        _drained(torch, engine, sched, f"{proc} launcher")
        s = spy.drivers[-1].acct.summary(slo_ttft=SLO_TTFT,
                                        slo_tpot=SLO_TPOT)
        print(f"[traffic] {card}: {proc} launcher (wall clock, overlap, "
              f"traced): TTFT p50 {s['ttft_p50'] * 1e3:.3f} ms, p99 "
              f"{s['ttft_p99'] * 1e3:.3f} ms; TPOT p50 "
              f"{s['tpot_p50'] * 1e3:.3f} ms, p99 {s['tpot_p99'] * 1e3:.3f}"
              f" ms; throughput {s['throughput_req_s']:.4f} req/s "
              f"({s['throughput_tok_s']:.3f} tok/s); SLO TTFT <= "
              f"{SLO_TTFT} s, TPOT <= {SLO_TPOT} s: attainment "
              f"{s['slo_attainment']:.4f}, goodput "
              f"{s['goodput_req_s']:.4f} req/s; duration "
              f"{s['duration_s']:.3f} s, {steps_w} token steps, "
              f"{sched.stats['steps']} ticks, reads ready/wait "
              f"{sched.stats['sync_device_ready']}/"
              f"{sched.stats['sync_device_wait']}; trace {len(events)} "
              f"events, {path.stat().st_size} B; checker OK {summary}; "
              f"wall {wall:.3f} s with params init")
        print(f"[traffic] {proc}: phase part {time.perf_counter() - t0:.1f}"
              f" s")
        del fin, engine, sched, spy
        _free(torch)
    _traced_tick(torch, PagedEngine, Scheduler, cfg, params, dev, card)
    _traced_sync_free(torch, PagedEngine, Scheduler, cfg, params, dev)
    launches.update(_traced_swap(torch, pa, serve, cfg, params, dev, card,
                                 swap_outs))
    return launches


def _traced_tick(torch, engine_cls, sched_cls, cfg, params, dev, card):
    """Steady decode ticks (4 slots, K 8, overlap off), untraced against
    traced, in turns (off, on, on, off, twice; a fresh engine each run,
    dropped undrained): each tick's host ms, the median per mode over 16
    ticks, and the events one traced tick records."""
    import statistics

    from repro_torch.serve.telemetry import Telemetry

    ticks, n_events = {False: [], True: []}, []
    for traced in (False, True, True, False) * 2:
        engine = _traffic_engine(engine_cls, cfg, params, dev)
        telem = Telemetry(trace=True) if traced else None
        sched = sched_cls(engine, prefill_chunk=8, decode_horizon=8,
                          telemetry=telem)
        for r in range(4):
            sched.add_request([1 + r, 2, 3, 4], max_new=96)
        for _ in range(2):                     # prefill, first horizon
            sched.step()
        torch.cuda.synchronize()
        n0 = len(telem.tracer.events) if traced else 0
        for _ in range(4):
            t0 = time.perf_counter()
            sched.step()
            ticks[traced].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if traced:
            n_events.append((len(telem.tracer.events) - n0) / 4)
        del engine, sched
    med = {k: statistics.median(v) for k, v in ticks.items()}
    print(f"[traffic] {card}: median host ms per decode tick (4 slots, K 8)"
          f" over 16 ticks each: untraced {med[False]:.3f} (range "
          f"{min(ticks[False]):.3f}-{max(ticks[False]):.3f}), traced "
          f"{med[True]:.3f} ({min(ticks[True]):.3f}-{max(ticks[True]):.3f});"
          f" traced / untraced {med[True] / med[False]:.4f}; "
          f"{statistics.mean(n_events):.1f} events recorded per tick")
    _free(torch)


def _traced_sync_free(torch, engine_cls, sched_cls, cfg, params, dev):
    """With every host sync an error, while a decode horizon's event is
    pending (a spin kernel queued behind it): an arrival (``arrive``
    event), a gauge sample, and the overlap's staged half of a traced
    tick — ``_admit`` (its span, block events, an ``admit`` event) and
    ``_prefill_stage`` (its span)."""
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.telemetry import Telemetry, check_trace

    engine = _traffic_engine(engine_cls, cfg, params, dev)
    telem = Telemetry(trace=True)
    sched = sched_cls(engine, prefill_chunk=8, decode_horizon=8,
                      overlap=True, prefix_cache=PrefixCache(8),
                      telemetry=telem)
    sched.add_request(list(range(1, 21)), max_new=40)
    while sched._pending is None:
        sched.step()                         # decoding
    decode_many = engine.decode_many

    def spun(*args):
        block = decode_many(*args)
        torch.cuda._sleep(int(400e6))        # about 0.2 s at 2 GHz
        return block
    engine.decode_many = spun
    sched.step()                             # a horizon behind the spin
    engine.decode_many = decode_many
    reconcile, in_flight = sched._decode_reconcile, []

    def reconcile_after_staging():
        torch.cuda.set_sync_debug_mode("default")
        in_flight.append(not sched._pending[1].query())
        return reconcile()
    sched._decode_reconcile = reconcile_after_staging
    n0, hits = len(telem.tracer.events), sched.stats["prefix_hits"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched.add_request(list(range(1, 13)) + [9, 9, 9], max_new=4)
        sched._sample_gauges()
        sched.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sched._decode_reconcile = reconcile
    new = telem.tracer.events[n0:]
    kinds = {(e["type"], e.get("ev", e.get("name", e.get("op"))))
             for e in new}
    want = {("req", "arrive"), ("gauge", None), ("span", "tick.admit"),
            ("req", "admit"), ("block", "alloc"), ("block", "reserve"),
            ("span", "tick.prefill_stage")}
    if in_flight != [True] or not want <= kinds or \
            sched.stats["prefix_hits"] != hits + 1:
        _fail(f"[traffic] staged half traced: horizon in flight at the "
              f"deferred read {in_flight}; events {sorted(map(str, kinds))}"
              f"; prefix hits {hits} -> {sched.stats['prefix_hits']}")
    done = sched.run()
    check_trace(telem.tracer.events)
    _drained(torch, engine, sched, "staged half")
    if sorted(len(r.out) for r in done) != [4, 40]:
        _fail("[traffic] the traced staged-half run did not finish")
    print(f"[sync] traffic: an arrival, a gauge sample and the overlap's "
          f"staged half with tracing on ({len(new)} events in that tick, "
          f"a prefix hit among them) under set_sync_debug_mode('error') "
          f"while the horizon's event was pending: no host sync; the "
          f"trace passes the checker")
    del engine, sched
    _free(torch)


def _preempt_latencies(events):
    """Per preempted request: (TTFT ms, [ms from each preemption to the
    request's next token]) read off a trace's request events."""
    by_rid = {}
    for e in events:
        if e["type"] == "req":
            by_rid.setdefault(e["rid"], []).append(e)
    out = {}
    for rid, evs in sorted(by_rid.items()):
        if not any(e["ev"] == "preempt" for e in evs):
            continue
        arrive = next(e["ts"] for e in evs if e["ev"] == "arrive")
        first = next(e["ts"] for e in evs if e["ev"] == "first_token")
        gaps = []
        for i, e in enumerate(evs):
            if e["ev"] == "preempt":
                nxt = next(x["ts"] for x in evs[i + 1:]
                           if x["ev"] in ("first_token", "tokens"))
                gaps.append(round((nxt - e["ts"]) * 1e3, 3))
        out[rid] = (round((first - arrive) * 1e3, 3), gaps)
    return out


def _traced_swap(torch, pa, serve, cfg, params, dev, card, swap_outs):
    """Phase 4d's schedule (6 requests of 60 + 40 tokens, 33 pages, 16-page
    rows) traced, with the swap tier and with discard: the checker passes
    with ``swap_out`` and ``swap_in`` in the swap trace, tokens equal
    phase 4d's, and each preempted request's TTFT and time from
    preemption to its next token, on the trace's host clock."""
    from repro_torch.serve.telemetry import check_trace, read_jsonl

    launches, lat = {}, {}
    for mode, tier in (("swap", SWAP_TIER), ("discard", 0)):
        t0 = time.perf_counter()
        path = TRACE_DIR / f"swap_{mode}.jsonl"

        def run():
            return serve.serve(
                cfg, params, requests=6, max_new=SWAP_NEW, batch_slots=4,
                prefill_chunk=8, prompt_len=60, decode_horizon=8,
                prefix_cache=False, host_swap_pages=tier, n_pages=33,
                max_pages_per_seq=16, trace=str(path), device=dev)
        pa.launches = 0
        fin, engine, sched = run()
        n = launches[f"traced {mode}"] = pa.launches
        steps = _check_launches(n, engine, f"traced {mode}")
        events = read_jsonl(str(path))
        summary = check_trace(events)
        ops = {e["op"] for e in events if e["type"] == "block"}
        if {r.rid: r.out for r in fin} != swap_outs or (
                mode == "swap" and not {"swap_out", "swap_in"} <= ops):
            _fail(f"[traffic] traced {mode}: tokens differ from phase 4d "
                  f"or no swap in the trace ({sorted(ops)})")
        _drained(torch, engine, sched, f"traced {mode}")
        lat[mode] = _preempt_latencies(events)
        print(f"[traffic] traced phase 4d schedule, {mode}: checker OK "
              f"{summary}; {len(events)} events; tokens equal phase 4d's; "
              f"{steps} token steps ({time.perf_counter() - t0:.1f} s)")
        del fin, engine, sched
        _free(torch)
    print(f"[traffic] {card}: phase 4d schedule, per preempted request "
          f"(TTFT ms, [ms from each preemption to its next token]): swap "
          f"{lat['swap']}; discard {lat['discard']}")
    return launches


# -- the fault plane, exact recovery and disaggregation ----------------------
#: phase 4f: (1) phase 4d's schedule under FaultPlan(0.1, seed=7) with 3
#: forced decode-tick faults, traced; (2) the launcher's ``--disagg`` on
#: phase 4's 6 requests of 4 + 16 tokens (prefill 6 slots / 49 pages,
#: decode 3 slots / 97 pages), clean and with ``--faults --fault-rate
#: 0.1``; (3) crash recovery of 5 of phase 4's requests on 3 slots, horizon
#: 4, a snapshot every 3 ticks, the crash after 6 (+ one tick with a late
#: arrival); (4) the image admission and a faulted reserve, sync-free
CHAOS_RATE, CHAOS_SEED, CHAOS_TICKS = 0.1, 7, 3
CHAOS_DIR = Path(__file__).resolve().parent / "build" / "chaos"
FAULT_ARGV = ["--faults", "--fault-rate", str(CHAOS_RATE), "--fault-seed",
              str(CHAOS_SEED)]
DISAGG_ARGV = ["--no-smoke", "--disagg", "--overlap", "--metrics"]
DISAGG_MODES = (("clean", []), ("faults", FAULT_ARGV))
CRASH_SNAP_EVERY, CRASH_TICKS = 3, 6


class _ForcedTicks:
    """While entered, every fault plan the launcher builds gets ``n``
    forced ``decode_tick`` faults and is kept."""

    def __init__(self, serve, n: int):
        self.serve, self.n, self.plans = serve, n, []

    def __enter__(self):
        make = self.saved = self.serve.plan_from_args

        def forced(*args, **kw):
            plan = make(*args, **kw)
            plan.force("decode_tick", self.n)
            self.plans.append(plan)
            return plan
        self.serve.plan_from_args = forced
        return self

    def __exit__(self, *exc):
        self.serve.plan_from_args = self.saved


class _ExportClock:
    """While entered, times every ``VBIAllocator.export_image`` on the
    host clock and keeps each image."""

    def __init__(self):
        from repro_torch.core.vbi.blocks import VBIAllocator
        self.cls, self.images, self.ms = VBIAllocator, [], []

    def __enter__(self):
        export = self.saved = self.cls.export_image

        def timed(alloc, *args, **kw):
            t0 = time.perf_counter()
            img = export(alloc, *args, **kw)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.images.append(img)
            return img
        self.cls.export_image = timed
        return self

    def __exit__(self, *exc):
        self.cls.export_image = self.saved


def _chaos_launches(pa, engines, tag):
    """The kernel's count since it was set to 0 must equal (full + ring
    layers, 28) x the token steps of ``engines``; returns the steps."""
    steps = sum(e.stats["token_steps"] for e in engines)
    n_attn = engines[0].geom.n_full + engines[0].geom.n_ring
    if pa.launches != n_attn * steps or pa.launches == 0:
        _fail(f"[chaos] {tag}: kernel launches {pa.launches} != {n_attn} x "
              f"{steps} token steps")
    return steps


def _chaos_drained(engine, tag):
    al = engine.alloc
    if al.pages_in_use != 0 or engine.free_pages != al.free_pages or (
            al.swap is not None and al.swap.used_pages != 0):
        _fail(f"[chaos] {tag}: pool or tier not drained, or mirror off")


def _chaos_trace(path, plan, n_pools, tag):
    """The trace at ``path`` passes the checker with every fault the plan
    fired resolved; returns the checker's summary."""
    from repro_torch.serve.telemetry import check_trace, read_jsonl
    summary = check_trace(read_jsonl(str(path)))
    fired = sum(plan.fired.values()) if plan is not None else 0
    if summary["n_pools"] != n_pools or summary["n_faults"] != fired or \
            summary["faults_unresolved"] or summary["images_in_flight"] \
            or summary["live_blocks"]:
        _fail(f"[chaos] {tag}: checker summary {summary}, faults fired "
              f"{fired}")
    return summary


def phase_chaos(torch, pa, card, dev, serve_outs, swap_outs):
    """Phase 4f: the fault plane, exact recovery and disaggregation on
    full-width qwen3-0.6b (weights from seed 0).  (1) phase 4d's schedule
    through the launcher with ``--faults`` and 3 forced decode-tick
    faults, traced: tokens equal phase 4d's, faults fired per class, none
    unresolved, the checker passes, pool and tier drained; (2) the
    launcher's ``--disagg --overlap --trace --metrics``, clean and with
    ``--faults``: tokens equal phase 4's, 6 handoffs, a two-pool trace,
    the host ms of each export and the device ms of each import scatter
    beside a ``copy_`` of its bytes; (3) crash recovery on a fresh engine,
    clean and with a bit-flipped leg: merged tokens equal phase 4's; (4)
    ``_admit_image`` and a faulted reserve under a pending horizon with
    every host sync an error.  Launches 28 x token steps in every run.
    Returns kernel launches by run."""
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    if CHAOS_DIR.exists():
        shutil.rmtree(CHAOS_DIR)
    CHAOS_DIR.mkdir(parents=True)
    launches = {}

    # (1) unified chaos under pool pressure
    t0 = time.perf_counter()
    path = CHAOS_DIR / "unified.jsonl"
    with _ForcedTicks(serve, CHAOS_TICKS) as forced:
        pa.launches = 0
        fin, engine, sched = serve.main(
            SWAP_ARGV + ["--host-swap-pages", str(SWAP_TIER), "--trace",
                         str(path)] + FAULT_ARGV)
        steps = _chaos_launches(pa, [engine], "unified")
    launches["unified chaos"] = pa.launches
    plan = forced.plans[-1]
    st = sched.stats
    if {r.rid: r.out for r in fin} != swap_outs:
        _fail("[chaos] unified: tokens differ from phase 4d's")
    if not (sum(plan.fired.values()) > CHAOS_TICKS
            and plan.stats["unresolved"] == 0
            and st["decode_tick_retries"] >= CHAOS_TICKS):
        _fail(f"[chaos] unified: plan {plan.stats}, sched {dict(st)}")
    summary = _chaos_trace(path, plan, 1, "unified")
    _chaos_drained(engine, "unified")
    print(f"[chaos] unified, phase 4d's schedule, FaultPlan({CHAOS_RATE}, "
          f"seed={CHAOS_SEED}) + {CHAOS_TICKS} forced decode ticks: tokens "
          f"equal phase 4d's; faults fired by class {plan.fired} (total "
          f"{sum(plan.fired.values())}), resolved {plan.resolved}, "
          f"unresolved 0; retries {st['fault_retries']}, decode-tick "
          f"retries {st['decode_tick_retries']}, fallbacks "
          f"{st['fault_fallbacks']}, sheds {st['fault_sheds']}, horizon "
          f"shrinks {st['horizon_shrinks']}; preemptions "
          f"{st['preemptions']}, swap-outs {st['swap_outs']}; {steps} token "
          f"steps; checker OK {summary}; pool and tier drained "
          f"({time.perf_counter() - t0:.1f} s)")
    del fin, engine, sched
    _free(torch)

    # (2) disaggregation through the launcher, clean and with faults
    images = None
    for mode, extra in DISAGG_MODES:
        t0 = time.perf_counter()
        path = CHAOS_DIR / f"disagg_{mode}.jsonl"
        with _ExportClock() as clock:
            pa.launches = 0
            fin, engine, dsch = serve.main(DISAGG_ARGV + extra
                                           + ["--trace", str(path)])
            p_eng = dsch.prefill.engine
            steps = _chaos_launches(pa, [p_eng, engine], f"disagg {mode}")
        launches[f"disagg {mode}"] = pa.launches
        plan = dsch.faults
        exports = list(zip(clock.ms, clock.images))
        if {r.rid: r.out for r in fin} != serve_outs:
            _fail(f"[chaos] disagg {mode}: tokens differ from phase 4's")
        if dsch.stats["handoffs"] != 6 or p_eng.params is not engine.params:
            _fail(f"[chaos] disagg {mode}: stats {dict(dsch.stats)}")
        if plan is not None and not (sum(plan.fired.values()) > 0
                                     and plan.stats["unresolved"] == 0):
            _fail(f"[chaos] disagg {mode}: plan {plan.stats}")
        summary = _chaos_trace(path, plan, 2, f"disagg {mode}")
        for eng in (p_eng, engine):
            _chaos_drained(eng, f"disagg {mode}")
        print(f"[chaos] {card}: disagg {mode} (prefill {p_eng.max_seqs} "
              f"slots / {p_eng.n_pages} pages, decode {engine.max_seqs} / "
              f"{engine.n_pages}, overlap, traced): tokens equal phase 4's; "
              f"{dsch.stats['handoffs']} handoffs, "
              f"{dsch.stats['handoff_bytes']} B, stalled ticks "
              f"{dsch.stats['handoff_stalled_ticks']}; export_image host ms "
              f"(bytes) {[(round(ms, 3), im.nbytes) for ms, im in exports]}; "
              f"token steps prefill {p_eng.stats['token_steps']} + decode "
              f"{engine.stats['token_steps']} = {steps}; faults "
              f"{plan.stats if plan is not None else None}; checker OK "
              f"{summary} ({time.perf_counter() - t0:.1f} s)")
        if mode == "clean":
            prompts = {r.rid: r.prompt for r in fin}
            images = clock.images
            _import_probe(torch, engine, images, card)
        del fin, engine, dsch, p_eng
        _free(torch)

    # (3) crash recovery, and (4) the new paths sync-free
    cfg = serve.serve_config("qwen3-0.6b", smoke=False)
    params = init_params(cfg, seed=0, device=dev)
    for damage in (None, "bitflip"):
        launches[f"recovery {damage or 'clean'}"] = _crash_recovery(
            torch, pa, card, cfg, params, dev, prompts, serve_outs, damage)
    _chaos_sync_free(torch, cfg, params, dev, images[0])
    del params
    _free(torch)
    return launches


def _import_probe(torch, engine, images, card):
    """Device ms of each handed-off image's import scatter on the drained
    decode pool (``restore_block`` of its pages, already on the device,
    into slot 0, ``free_top`` put back after each call), queued behind a
    spin kernel as phase 4d's restore probe is, beside a ``copy_`` of the
    image's bytes device -> pinned host and back.  The pool's bookkeeping
    is put back afterwards."""
    from repro_torch.core.vbi.kvcache import restore_block

    st = engine.state
    saved = {f: getattr(st, f).clone() for f in (
        "page_table", "seq_lens", "slot_active", "free_top",
        "page_refcounts")}
    rows = []
    for img in images:
        k = torch.from_numpy(img.k).to(engine.device)
        v = torch.from_numpy(img.v).to(engine.device)

        def restore():
            restore_block(st, 0, k, v, img.n_pages, img.n_tokens)
            st.free_top.add_(img.n_pages)
        rows.append(_kernel_ms(torch, restore))
    for f, t in saved.items():
        getattr(st, f).copy_(t)
    n_bytes = images[0].nbytes
    dev_buf = torch.ones(n_bytes, dtype=torch.uint8, device=engine.device)
    host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    d2h = _kernel_ms(torch, lambda: host.copy_(dev_buf, non_blocking=True))
    h2d = _kernel_ms(torch, lambda: dev_buf.copy_(host, non_blocking=True))
    print(f"[chaos] {card}: import_image scatter device ms per handed-off "
          f"image ({images[0].n_pages} page, {n_bytes} B each): "
          f"{[round(ms, 4) for ms in rows]}; copy_ of {n_bytes} B device "
          f"-> pinned host {d2h:.4f} ms, pinned host -> device {h2d:.4f} "
          f"ms; byte bound of the scatter "
          f"{2 * n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")


def _crash_recovery(torch, pa, card, cfg, params, dev, prompts, serve_outs,
                    damage):
    """5 of phase 4's requests on 3 slots (horizon 4, 97 pages): a snapshot
    every 3 ticks, a crash after 6 with request 4 arriving after the last
    snapshot and one more tick; a fresh engine rebuilt from the newest
    intact snapshot and the journal.  With ``damage`` one snapshot leg is
    bit-flipped on disk first.  The merged tokens must equal phase 4's.
    Returns the kernel's launches over both runs."""
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.recovery import (ServeSnapshotter,
                                            recover_scheduler)
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.telemetry import Telemetry, check_trace

    t0 = time.perf_counter()
    tag = f"recovery {damage or 'clean'}"
    directory = CHAOS_DIR / f"snap_{damage or 'clean'}"

    def mk(telem):
        eng = PagedEngine(cfg, params, page_size=8, max_seqs=3, n_pages=97,
                          attn_impl="kernel", device=dev)
        return eng, Scheduler(eng, prefill_chunk=8, decode_horizon=4,
                              telemetry=telem)

    n_total = 0
    telem = Telemetry(trace=True)
    pa.launches = 0
    eng, sched = mk(telem)
    for rid in range(4):
        sched.add_request(prompts[rid], 16, rid=rid)
    snap = ServeSnapshotter(sched, directory, every=CRASH_SNAP_EVERY, keep=2)
    save_ms = []
    for _ in range(CRASH_TICKS):
        sched.step()
        t1 = time.perf_counter()
        if snap.tick():
            save_ms.append((time.perf_counter() - t1) * 1e3)
    sched.add_request(prompts[4], 16, rid=4)
    sched.step()
    torch.cuda.synchronize()
    _chaos_launches(pa, [eng], f"{tag} crashed run")
    n_total += pa.launches
    journal = list(telem.tracer.events)
    del eng, sched, snap
    _free(torch)
    # -- the crash: nothing below touches the first engine --
    step_dir = directory / f"step_{latest_step(directory)}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    legs = [e for e in manifest["leaves"] if "_k" in e["key"]]
    snap_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
    if not legs:
        _fail(f"[chaos] {tag}: no live slot in the snapshot")
    if damage == "bitflip":
        leaf = step_dir / legs[0]["file"]
        raw = bytearray(leaf.read_bytes())
        raw[-1] ^= 0x01
        leaf.write_bytes(bytes(raw))
    telem2 = Telemetry(trace=True)
    pa.launches = 0
    eng2, s2 = mk(telem2)
    finished = recover_scheduler(s2, directory, journal=journal)
    n_images = sum(r.image is not None for r in s2.queue)
    out = dict(finished)
    out.update({r.rid: r.out for r in s2.run()})
    _chaos_launches(pa, [eng2], f"{tag} restarted run")
    n_total += pa.launches
    want = {rid: serve_outs[rid] for rid in range(5)}
    if out != want or n_images != len(legs) - (damage == "bitflip") or \
            s2.stats["image_imports"] != n_images:
        _fail(f"[chaos] {tag}: merged tokens equal phase 4's "
              f"{out == want}; images {n_images} of {len(legs)} legs, "
              f"imported {s2.stats['image_imports']}")
    eng2.alloc.attach_tracer(None)
    summary = check_trace(telem2.tracer.events)
    _chaos_drained(eng2, tag)
    print(f"[chaos] {card}: {tag}: snapshot every {CRASH_SNAP_EVERY} ticks, "
          f"crash after {CRASH_TICKS} + 1; step {step_dir.name}: "
          f"{len(legs)} live leg(s), {snap_bytes} B on disk; host ms per "
          f"save {[round(ms, 3) for ms in save_ms]}; restarted from "
          f"{len(finished)} finished, {n_images} image(s), the rest "
          f"re-prefilled or replayed from the journal; merged tokens equal "
          f"phase 4's; checker OK {summary} ({time.perf_counter() - t0:.1f}"
          f" s)")
    del eng2, s2
    _free(torch)
    return n_total


def _chaos_sync_free(torch, cfg, params, dev, img):
    """With every host sync an error, while a decode horizon's event is
    pending (a spin kernel queued behind it): the decode scheduler's
    staged ``_admit_image`` of a handed-off image into a free slot, then a
    ``_call_vbi``-wrapped reserve that meets 2 forced faults and retries.
    The adopted pages equal the image bit for bit."""
    import numpy as np

    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.scheduler import Request, Scheduler

    engine = PagedEngine(cfg, params, page_size=8, max_seqs=3, n_pages=97,
                         attn_impl="kernel", device=dev)
    plan = FaultPlan({}, seed=0)
    sched = Scheduler(engine, prefill_chunk=8, decode_horizon=8,
                      overlap=True, faults=plan)
    sched.add_request(list(range(1, 21)), max_new=40)
    while sched._pending is None:
        sched.step()                         # decoding
    decode_many = engine.decode_many

    def spun(*args):
        block = decode_many(*args)
        torch.cuda._sleep(int(400e6))        # about 0.2 s at 2 GHz
        return block
    engine.decode_many = spun
    sched.step()                             # a horizon behind the spin
    engine.decode_many = decode_many
    event = sched._pending[1]
    req = Request(99, list(img.tokens[:img.n_tokens]),
                  max_new=16, out=list(img.tokens[img.n_tokens:]),
                  image=img)
    sched.queue.append(req)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched._admit()
        slot = next(s for s, st in sched.slots.items() if st.req is req)
        blk = sched.slots[slot].block
        plan.force("alloc", 2)
        sched._call_vbi(lambda: engine.alloc.reserve_pages(
            blk, blk.reserved_pages + 1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending = not event.query()
    torch.cuda.synchronize()
    back = engine.alloc.snapshot_image(blk)
    ok = (pending and np.array_equal(back.k, img.k)
          and np.array_equal(back.v, img.v)
          and sched.stats["image_imports"] == 1
          and sched.stats["fault_retries"] == 2
          and plan.stats["unresolved"] == 0)
    if not ok:
        _fail(f"[chaos] sync-free: event pending at return {pending}, "
              f"pages equal the image {np.array_equal(back.k, img.k)}, "
              f"sched {dict(sched.stats)}, plan {plan.stats}")
    done = sched.run()
    if sorted(len(r.out) for r in done) != [16, 40]:
        _fail("[chaos] the sync-free run did not finish")
    _chaos_drained(engine, "sync-free")
    print(f"[sync] chaos: the decode scheduler's _admit_image of a "
          f"{img.n_pages}-page image ({img.nbytes} B) and a _call_vbi "
          f"reserve through 2 forced alloc faults under "
          f"set_sync_debug_mode('error') while a horizon's event was "
          f"pending: no host sync, the event still pending at return, the "
          f"adopted pages equal the image bit for bit")
    del engine, sched
    _free(torch)


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


# -- phase 4g: training, the encoder-decoder and vision inputs ---------------
#: the launcher's run: qwen3-0.6b at its published config, bfloat16
#: compute; its checkpoints go to the checkout's ignored build directory
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train"
TRAIN_STEPS, TRAIN_EVERY, TRAIN_B, TRAIN_S = 20, 10, 8, 128
TRAIN_ARGV = ["--arch", "qwen3-0.6b", "--no-smoke",
              "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
              "--seq", str(TRAIN_S), "--ckpt-every", str(TRAIN_EVERY),
              "--device", "cuda"]
#: resume from step 10 against the uninterrupted run, deterministic
#: algorithms off: losses within 1e-5 (of a loss near 12), params within
#: 1e-6, each moment leaf (m, v) within 1e-5 of its norm, the step count
#: equal.  The runs have come out bit-equal on the card so far; a resume
#: that lost m, v or the step would send every element another way (m
#: and v off by their own size, the params by more than 1e-6 in 10 steps)
RESUME_LOSS_TOL, RESUME_PARAM_TOL, RESUME_MOMENT_TOL = 1e-5, 1e-6, 1e-5
#: the smoke step on the card against the CPU, float32: loss and grad norm
#: 1e-5 relative; params 1e-6 absolute (read 1.5e-8); each moment leaf
#: within 1e-5 of its norm.  Adam moves an element by about its learning
#: rate whatever its gradient, so the params alone would miss wrong
#: gradients: the grad norm and the moments (m = 0.1 x clipped g after
#: the first step) do not
CPU_LOSS_RTOL, CPU_PARAM_ATOL, CPU_MOMENT_RTOL = 1e-5, 1e-6, 1e-5
#: prefill + decode against teacher forcing in float32: the reference's
#: tolerance (tests/test_models.py::test_decode_matches_teacher_forcing)
TF_ATOL, TF_RTOL = 2e-3, 1e-3


def _tree_diff(a, b):
    """Max abs difference of two trees' leaves, on ``a``'s device."""
    from repro_torch.tree import leaves
    return max(float((x.float() - y.to(x.device).float()).abs().max())
               for x, y in zip(leaves(a), leaves(b), strict=True))


def _moment_err(a, b):
    """Max over the m and v leaves of two optimizer states of
    ||a - b|| / ||b||, on ``a``'s device."""
    from repro_torch.tree import leaves
    return max(float((x.float() - y.to(x.device).float()).norm()
                     / y.float().norm())
               for k in ("m", "v")
               for x, y in zip(leaves(a[k]), leaves(b[k]), strict=True))


def _train_run(torch, launch_train, ckpt_dir, log, n_steps):
    """The launcher as a user runs it; returns (state, losses, loop, wall
    s, the loop's dt per step)."""
    t0 = time.perf_counter()
    state, end, losses, loop = launch_train.main(
        TRAIN_ARGV + ["--ckpt-dir", str(ckpt_dir), "--log", str(log)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (end != TRAIN_STEPS or len(losses) != n_steps
            or not all(math.isfinite(x) for x in losses)):
        _fail(f"[train] run ended at step {end} with losses {losses}")
    dts = [json.loads(line)["dt_s"] for line in log.read_text().splitlines()]
    return state, losses, loop, wall, dts


def phase_train_launcher(torch, pa, card):
    """Phase 4g (1): ``repro_torch.launch.train.main`` on the published
    qwen3-0.6b for 20 steps, the loss falling; a second run resumed from
    the step-10 checkpoint against it; one more step under
    ``set_sync_debug_mode("error")``; one step profiled.  Returns the
    numbers of the ``[train]`` line."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import leaves

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats()
    state, losses, loop, wall, dts = _train_run(
        torch, launch_train, TRAIN_DIR / "run", TRAIN_DIR / "run.jsonl",
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        _fail(f"[train] loss did not fall: {losses[0]} -> {losses[-1]}")
    n_params = sum(t.numel() for t in leaves(state["params"]))
    ckpt = TRAIN_DIR / "run" / f"step_{TRAIN_EVERY}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
    steady = sorted(dts[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    tok_s = TRAIN_B * TRAIN_S / step_ms * 1e3
    print(f"[train] {card}: qwen3-0.6b ({n_params} params; float32 params,"
          f" bfloat16 compute, remat) through repro_torch.launch.train: "
          f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens in "
          f"{wall:.1f} s wall (init and checkpoints included); losses "
          f"{[round(float(x), 4) for x in losses]}; host ms per step (the "
          f"loop's dt, loss read included; median of steps 2-{TRAIN_STEPS}) "
          f"{step_ms:.3f}, min {steady[0] * 1e3:.3f}, max "
          f"{steady[-1] * 1e3:.3f}, step 1 {dts[0] * 1e3:.1f}; "
          f"{tok_s:.1f} tokens/s; max_memory_allocated {peak} B; a "
          f"checkpoint {ckpt_bytes} B on disk")

    # the step-10 checkpoint alone in a fresh directory: the launcher
    # resumes from it by itself
    resume_dir = TRAIN_DIR / "resume"
    resume_dir.mkdir()
    shutil.move(str(ckpt), str(resume_dir / ckpt.name))
    shutil.rmtree(TRAIN_DIR / "run")
    state2, losses2, loop2, wall2, _ = _train_run(
        torch, launch_train, resume_dir, TRAIN_DIR / "resume.jsonl",
        TRAIN_STEPS - TRAIN_EVERY)
    loss_err = max(abs(a - b) for a, b in zip(losses2, losses[TRAIN_EVERY:]))
    param_err = _tree_diff(state2["params"], state["params"])
    moment_err = _moment_err(state2["opt"], state["opt"])
    steps = (int(state2["opt"]["step"]), int(state["opt"]["step"]))
    bit_equal = (loss_err == param_err == 0 and steps[0] == steps[1]
                 and _tree_diff(state2["opt"], state["opt"]) == 0)
    if (loss_err > RESUME_LOSS_TOL or param_err > RESUME_PARAM_TOL
            or moment_err > RESUME_MOMENT_TOL or steps[0] != steps[1]):
        _fail(f"[train] the resumed run is off by {loss_err:.3e} in loss, "
              f"{param_err:.3e} in params, {moment_err:.3e} in m and v; "
              f"steps {steps}")
    print(f"[train] resumed from step {TRAIN_EVERY} ({wall2:.1f} s wall, "
          f"restore included): losses of steps {TRAIN_EVERY + 1}-"
          f"{TRAIN_STEPS} within {loss_err:.3e} of the uninterrupted run's "
          f"(tol {RESUME_LOSS_TOL}), params within {param_err:.3e} (tol "
          f"{RESUME_PARAM_TOL}), m and v within {moment_err:.3e} of their "
          f"norms (tol {RESUME_MOMENT_TOL}), step {steps[0]} in both; "
          f"bit-equal: {bit_equal} "
          f"(torch.use_deterministic_algorithms off)")
    del state
    _free(torch)

    # one more step of the launcher's (its batch staged through pinned
    # memory) under the sync check, then one profiled
    cfg = get_config("qwen3-0.6b")
    batch = SyntheticLMData(cfg, TRAIN_B, TRAIN_S, seed=0).batch_at(
        TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = loop2.train_step(state2, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not math.isfinite(float(m["loss"])):
        _fail("[train] the sync-checked step's loss is not finite")
    print("[sync] train: one launcher train step of qwen3-0.6b (batch "
          "staging, forward, backward with remat, AdamW in place) under "
          "set_sync_debug_mode('error'): no host sync")
    walls = []

    def timed_step():
        t0 = time.perf_counter()
        loop2.train_step(state2, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # the second call is the profiled one; idle is read from its own host
    # time (the profiler's cost included), not from another run's
    busy_ms, kernels = _kernel_busy(torch, timed_step)
    prof_ms = walls[-1] * 1e3
    idle = None
    if busy_ms is None:
        print("[train] profiled step: device-busy time not measured (no "
              "CUDA kernel events)")
    else:
        idle = 1 - busy_ms / prof_ms
        top = "; ".join(f"{k[:70]} x{n} {ms:.3f} ms"
                        for k, n, ms in kernels[:6])
        print(f"[train] {card}: one profiled step: "
              f"{sum(n for _, n, _ in kernels)} kernels, device-busy "
              f"{busy_ms:.3f} ms in {prof_ms:.3f} host ms of that step "
              f"(profiler on; the loop's median {step_ms:.3f}): idle "
              f"{idle * 100:.1f}%; top: {top}")
    del state2, loop2
    _free(torch)
    # the step-10 checkpoint stays under TRAIN_DIR / "resume" for phase
    # 4j's sharded restore, which removes TRAIN_DIR
    return {"step_ms": step_ms, "tokens_per_s": tok_s, "busy_ms": busy_ms,
            "profiled_step_ms": prof_ms, "idle": idle, "peak_bytes": peak,
            "loss_first": losses[0], "loss_last": losses[-1],
            "resume_loss_err": loss_err, "resume_param_err": param_err,
            "resume_moment_err": moment_err, "resume_bit_equal": bit_equal,
            "ckpt_bytes": ckpt_bytes, "wall_s": wall}


def phase_train_cpu_check(torch, dev):
    """Phase 4g (2): three train steps of the qwen3 smoke config at float32
    compute on the card and on the CPU, from the same params and
    batches."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.device import stage
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"),
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    step = make_train_step(cfg, AdamWConfig())
    base = init_train_state(cfg, AdamWConfig(), seed=0, device=cpu)
    states = {cpu: base, dev: tree_map(lambda t: t.to(dev), base)}
    data = SyntheticLMData(cfg, 8, 64, seed=0)
    errs = {"loss": 0.0, "grad_norm": 0.0}
    for i in range(3):
        out = {d: step(states[d], {k: stage(v, d) for k, v in
                                   data.batch_at(i).items()})
               for d in (cpu, dev)}
        states = {d: out[d][0] for d in out}
        for k in errs:
            want = float(out[cpu][1][k])
            errs[k] = max(errs[k], abs(float(out[dev][1][k]) - want)
                          / abs(want))
    param_err = _tree_diff(states[dev]["params"], states[cpu]["params"])
    moment_err = _moment_err(states[dev]["opt"], states[cpu]["opt"])
    if (max(errs.values()) > CPU_LOSS_RTOL or param_err > CPU_PARAM_ATOL
            or moment_err > CPU_MOMENT_RTOL):
        _fail(f"[train] smoke steps on the card vs the CPU: relative "
              f"{errs}, params {param_err:.3e}, m and v {moment_err:.3e}")
    n = sum(t.numel() for t in leaves(base["params"]))
    print(f"[train] qwen3-0.6b smoke ({n} params, float32) 3 train steps "
          f"on the card and on the CPU from the same params and batches: "
          f"loss and grad norm within {max(errs.values()):.3e} relative "
          f"(tol {CPU_LOSS_RTOL}), params within {param_err:.3e} (tol "
          f"{CPU_PARAM_ATOL}), m and v within {moment_err:.3e} of their "
          f"norms (tol {CPU_MOMENT_RTOL})")
    return {"params": param_err, "moments": moment_err,
            "loss_grad_norm_rel": max(errs.values())}


def _teacher_forcing(torch, cfg, params, dev, S, tag):
    """prefill of S tokens and one decode step against forward_train at
    the same positions (float32), on the card; returns the max abs
    error."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import model as tm

    data = SyntheticLMData(cfg, 2, cfg.n_vis_tokens + S + 1, 0).batch_at(0)
    full = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    pre = {k: (v[:, :S] if k in ("tokens", "labels") else v)
           for k, v in full.items()}
    off = cfg.n_vis_tokens
    with torch.no_grad():
        logits = tm.forward_train(cfg, params, full)
        lg_pre, caches = tm.prefill(cfg, params, pre, max_len=off + S + 4)
        lg_dec, _ = tm.decode_step(cfg, params, caches,
                                   full["tokens"][:, S:S + 1], off + S)
    err = 0.0
    for got, want in ((lg_pre[:, 0], logits[:, off + S - 1]),
                      (lg_dec[:, 0], logits[:, off + S])):
        if not torch.allclose(got, want, atol=TF_ATOL, rtol=TF_RTOL):
            _fail(f"[train] {tag}: prefill/decode logits differ from "
                  f"teacher forcing by {(got - want).abs().max():.3e}")
        err = max(err, float((got - want).abs().max()))
    print(f"[train] {tag}: prefill of {S} tokens"
          f"{f' after {off} vision tokens' if off else ''} and one decode "
          f"step equal forward_train at the same positions (float32): max "
          f"abs err {err:.3e} (tol {TF_ATOL} + {TF_RTOL} relative)")
    return err


def _train_steps(torch, cfg, params, dev, B, S_text, n, tag, opt):
    """``n`` train steps at ``cfg``'s own dtypes on one batch; returns the
    losses.  Fails unless they are finite and falling and the params
    moved."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.device import stage
    from repro_torch.models.model import lm_loss
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    batch = {k: stage(v, dev) for k, v in SyntheticLMData(
        cfg, B, cfg.n_vis_tokens + S_text, 0).batch_at(0).items()}
    # the step's loss is the mean of lm_loss over its microbatches
    mb = B // cfg.grad_accum
    with torch.no_grad():
        want = sum(float(lm_loss(cfg, params, {k: v[i * mb:(i + 1) * mb]
                                               for k, v in batch.items()}))
                   for i in range(cfg.grad_accum)) / cfg.grad_accum
    # the params that must move: the leaves under 16 M elements (copies of
    # the embedding and head would take 4.6 GB at internvl2's width)
    small = [t for t in leaves(params) if t.numel() < 1 << 24]
    before = [t.clone() for t in small]
    state = {"params": params, "opt": init_opt_state(params, opt)}
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(n)]
    wall = time.perf_counter() - t0
    moved = min(float((a - b).abs().max()) for a, b in zip(small, before))
    if (not all(math.isfinite(x) for x in losses) or moved == 0
            or (n > 1 and not losses[-1] < losses[0])
            or abs(losses[0] - want) > 1e-5 * abs(want)):
        _fail(f"[train] {tag}: losses {losses} (lm_loss over the "
              f"microbatches {want}), params moved {moved}")
    print(f"[train] {tag}: {n} train step(s) of {B} x "
          f"{cfg.n_vis_tokens + S_text} positions ({cfg.compute_dtype} "
          f"compute, grad_accum {cfg.grad_accum}) on one batch: losses "
          f"{[round(x, 4) for x in losses]} (the first = lm_loss averaged "
          f"over the microbatches, {want:.4f}), every params leaf under "
          f"16 M elements moved (the least by {moved:.3e}); "
          f"{wall * 1e3 / n:.1f} host ms per step; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    del state
    return losses


def phase_train_encdec_vision(torch, dev, card):
    """Phase 4g (3, 4): whisper-small at its published config and
    internvl2-26b at full width cut to 2 of 48 layers: teacher forcing on
    the card in float32, then train steps at their own compute dtype."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    errs = {}
    for arch, depth in (("whisper-small", None), ("internvl2-26b", 2)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if depth:
            # full width; 2 of 48 layers: 1.92 G params, 31 GB with
            # gradients and Adam state (all 48 would take 409 GB)
            cfg = dataclasses.replace(cfg, n_layers=depth)
        params = tm.init_params(cfg, seed=0, device=dev)
        n = sum(t.numel() for t in leaves(params))
        extra = (f"{cfg.n_enc_layers} encoder layers over "
                 f"{cfg.n_audio_frames} audio frames" if cfg.is_encdec
                 else f"{cfg.n_vis_tokens} vision tokens")
        tag = (f"{cfg.name} ({cfg.n_layers} decoder layers, {extra}, "
               f"d_model {cfg.d_model}, {n} params)")
        errs[arch] = _teacher_forcing(
            torch, dataclasses.replace(cfg, compute_dtype="float32"), params,
            dev, 13, tag)
        if cfg.is_encdec:
            _train_steps(torch, cfg, params, dev, 4, 64, 3, tag,
                         AdamWConfig(lr=1e-3, warmup_steps=1))
        else:
            _train_steps(torch, cfg, params, dev, 4, 32, 1, tag,
                         AdamWConfig())
        del params
        _free(torch)
        print(f"[train] {cfg.name}: {time.perf_counter() - t0:.1f} s")
    return errs


def phase_train(torch, pa, card, dev):
    """Phase 4g: training, the encoder-decoder and the vision inputs on
    the card.  The paged-attention kernel is not on this path (training
    attends through the plain ``layers.attention``, as the reference
    does): its count, set to 0 here, must still be 0 at the end."""
    pa.launches = 0
    res = phase_train_launcher(torch, pa, card)
    res["cpu_err"] = phase_train_cpu_check(torch, dev)
    res["teacher_forcing_err"] = phase_train_encdec_vision(torch, dev, card)
    if pa.launches != 0:
        _fail(f"[train] the paged-attention kernel ran {pa.launches} times "
              f"in training")
    res["paged_attention_launches"] = pa.launches
    print(f"[train] {json.dumps({'train': res})}")
    return res


# -- phase 4j: training on a 1x1 device mesh --------------------------------
TRAIN_MESH_DIR = Path(__file__).resolve().parent / "build" / "train_mesh"
TRAIN_MESH_STEPS, TRAIN_MESH_TURNS = 5, 6
TRAIN_MESH_ARGV = ["--arch", "qwen3-0.6b", "--no-smoke", "--mesh", "host",
                   "--steps", str(TRAIN_MESH_STEPS), "--batch", str(TRAIN_B),
                   "--seq", str(TRAIN_S), "--device", "cuda"]


def _bit_equal(torch, a, b):
    """Whether two trees' leaves are equal, shape, dtype and bits (``b``'s
    leaves compared on ``a``'s device)."""
    from repro_torch.tree import leaves
    return all(x.dtype == y.dtype and torch.equal(x, y.to(x.device))
               for x, y in zip(leaves(a), leaves(b), strict=True))


def phase_train_mesh(torch, pa, card, dev):
    """Phase 4j: ``launch.train.main(["--mesh", "host", ...])`` on the
    published qwen3-0.6b, 5 steps of 8 x 128: its losses, grad norms and
    params bit-equal to 5 unmeshed ``make_train_step`` steps from the same
    seed and batches, no collective, one mesh step under
    ``set_sync_debug_mode("error")``, both routes' host ms a step in
    turns, phase 4g's step-10 checkpoint restored through the 1x1 mesh's
    shardings equal to the plain restore, one step with the EF compressor
    finite and sync-free.  Every mesh step must enter the SPMD step (its
    ``spmd_train`` scope, counted here) and no plain step may.  The
    paged-attention kernel is not on this path: its count, set to 0 here,
    must still be 0.  Returns the numbers of the ``[train-mesh]`` line."""
    import dataclasses

    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.device import stage
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.compression import make_ef_compressor
    from repro_torch.distributed.sharding import (param_specs, shardings_of,
                                                  state_specs)
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves

    spmd, spmd_train = [0], step_mod.spmd_train

    def counted_spmd(m, **kw):
        spmd[0] += 1
        return spmd_train(m, **kw)
    step_mod.spmd_train = counted_spmd
    pa.launches = 0
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    log = TRAIN_MESH_DIR / "run.jsonl"
    t0 = time.perf_counter()
    state, end, losses, loop = launch_train.main(
        TRAIN_MESH_ARGV + ["--ckpt-dir", str(TRAIN_MESH_DIR / "ckpt"),
                           "--ckpt-every", str(TRAIN_MESH_STEPS),
                           "--log", str(log)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mesh = loop.mesh
    if end != TRAIN_MESH_STEPS or mesh is None or mesh.size != 1:
        _fail(f"[train-mesh] the launcher ended at step {end} on {mesh}")
    if spmd[0] != TRAIN_MESH_STEPS:
        _fail(f"[train-mesh] {spmd[0]} of the launcher's "
              f"{TRAIN_MESH_STEPS} steps went through the SPMD step")
    gnorms = [json.loads(line)["grad_norm"]
              for line in log.read_text().splitlines()]
    served = {k: dict(v) for k, v in mesh.collectives.items()}

    # the same steps unmeshed, as the launcher's config and optimizer
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), grad_accum=1)
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(TRAIN_MESH_STEPS // 10, 1))
    data = SyntheticLMData(cfg, TRAIN_B, TRAIN_S, seed=0)
    plain = init_train_state(cfg, opt, 0, dev)
    step = make_train_step(cfg, opt)
    p_losses, p_gnorms = [], []
    for i in range(TRAIN_MESH_STEPS):
        plain, m = step(plain, {k: stage(v, dev)
                                for k, v in data.batch_at(i).items()})
        p_losses.append(float(m["loss"]))
        p_gnorms.append(float(m["grad_norm"]))
    equal = {"losses": [float(x) for x in losses] == p_losses,
             "grad_norms": gnorms == p_gnorms,
             "params": _bit_equal(torch, state["params"], plain["params"]),
             "opt": _bit_equal(torch, state["opt"], plain["opt"])}
    if not all(equal.values()):
        _fail(f"[train-mesh] the 1x1 mesh run is not bit-equal to the "
              f"unmeshed steps: {equal}; losses {list(losses)} vs "
              f"{p_losses}; grad norms {gnorms} vs {p_gnorms}")

    batch = data.batch_at(TRAIN_MESH_STEPS)

    def mesh_step():
        with logical_axes(mesh, n_experts=cfg.n_experts):
            return loop.train_step(state, batch)

    def plain_step():
        return step(plain, {k: stage(v, dev) for k, v in batch.items()})

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = mesh_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not math.isfinite(float(m["loss"])):
        _fail("[train-mesh] the sync-checked step's loss is not finite")
    print("[sync] train-mesh: one launcher step of qwen3-0.6b on the 1x1 "
          "mesh under set_sync_debug_mode('error'): no host sync")
    # each step timed whole: from an idle card to the end of its AdamW
    # (a loss read alone would stop the clock with the backward queued)
    turns = {"plain": [], "mesh": []}
    for _ in range(TRAIN_MESH_TURNS):
        for name, fn in (("plain", plain_step), ("mesh", mesh_step),
                         ("mesh", mesh_step), ("plain", plain_step)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t1) * 1e3)
    med = {k: statistics.median(v) for k, v in turns.items()}
    if any(c["calls"] or c["bytes"] for c in mesh.collectives.values()):
        _fail(f"[train-mesh] a 1x1 mesh made collectives: "
              f"{mesh.collectives}")

    # phase 4g's step-10 checkpoint through the mesh's shardings
    del plain
    _free(torch)
    ckpt = TRAIN_DIR / "resume"
    if not (ckpt / f"step_{TRAIN_EVERY}").is_dir():
        _fail(f"[train-mesh] phase 4g left no step-{TRAIN_EVERY} "
              f"checkpoint under {ckpt}")
    st_sh = shardings_of(state_specs(cfg, state, mesh), mesh)
    t1 = time.perf_counter()
    sharded = restore_pytree(state, ckpt, TRAIN_EVERY, shardings=st_sh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    same = _bit_equal(torch, sharded,
                      restore_pytree(state, ckpt, TRAIN_EVERY))
    if not same or int(sharded["opt"]["step"]) != TRAIN_EVERY:
        _fail("[train-mesh] the sharded restore of phase 4g's checkpoint "
              "differs from the plain restore")
    del sharded
    _free(torch)

    # one step with the EF compressor on the mesh's shardings
    compress, init = make_ef_compressor(shardings=shardings_of(
        param_specs(cfg, state["params"], mesh), mesh))
    ef = init(state["params"])
    c_step = make_train_step(cfg, opt, compress=lambda g: compress(g, ef)[0])
    staged = {k: stage(v, dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with logical_axes(mesh, n_experts=cfg.n_experts):
            _, m = c_step(state, staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    c_loss = float(m["loss"])
    if not math.isfinite(c_loss) or pa.launches != 0:
        _fail(f"[train-mesh] the compressed step's loss {c_loss}; "
              f"paged-attention launches {pa.launches}")
    step_mod.spmd_train = spmd_train
    # the launcher's steps, the sync-checked one, the timed mesh steps and
    # the compressed one; the plain steps none
    want_spmd = TRAIN_MESH_STEPS + 2 * TRAIN_MESH_TURNS + 2
    if spmd[0] != want_spmd:
        _fail(f"[train-mesh] {spmd[0]} steps went through the SPMD step, "
              f"want {want_spmd}")
    print("[sync] train-mesh: one EF-compressed step on the 1x1 mesh under "
          "set_sync_debug_mode('error'): no host sync")
    n_params = sum(t.numel() for t in leaves(state["params"]))
    del state, loop, ef
    _free(torch)
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    res = {"steps": TRAIN_MESH_STEPS, "bit_equal": equal,
           "losses": p_losses, "grad_norms": p_gnorms,
           "collectives": served, "host_ms_turns": turns,
           "host_ms_median": med, "mesh_over_plain": med["mesh"]
           / med["plain"], "restore_s": restore_s,
           "restore_equal": same, "compressed_loss": c_loss,
           "paged_attention_launches": pa.launches, "launcher_wall_s": wall,
           "spmd_steps": spmd[0], "n_params": n_params}
    print(f"[train-mesh] {card}: qwen3-0.6b ({n_params} params) through "
          f"launch.train --mesh host, {TRAIN_MESH_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_S} in {wall:.1f} s wall (init and the final "
          f"checkpoint included): losses, grad norms, params, m, v and "
          f"step bit-equal to the unmeshed make_train_step; {spmd[0]} "
          f"mesh steps through the SPMD step, no plain one; collectives "
          f"{served}; host ms a step (idle card to synchronize) in turns "
          f"(plain, mesh, mesh, plain) x "
          f"{TRAIN_MESH_TURNS}: medians plain {med['plain']:.3f}, mesh "
          f"{med['mesh']:.3f}, mesh / plain "
          f"{med['mesh'] / med['plain']:.4f}; phase 4g's step-"
          f"{TRAIN_EVERY} checkpoint restored through the mesh's shardings "
          f"in {restore_s:.2f} s, equal to the plain restore; EF-compressed "
          f"step loss {c_loss:.4f}; paged-attention launches {pa.launches}")
    print(f"[train-mesh] {json.dumps({'train_mesh': res})}")
    return res


# -- phase 4k: every remaining stack on a 1x1 training mesh ----------------
#: (arch, layers kept (None: the published depth), batch, text positions):
#: full width.  One mixtral layer is 1.45 G params (E 8 x 3 x 4,096 x
#: 14,336 and attention) beside 0.26 G of embedding and head
TRAIN_STACKS = (("mixtral-8x7b", 1, 4, 128), ("mamba2-1.3b", None, 4, 128),
                ("recurrentgemma-9b", 3, 4, 128),
                ("whisper-small", None, 4, 64), ("internvl2-26b", 2, 2, 32))
TRAIN_STACKS_STEPS = 2
#: the MoE on the 1x1 mesh (one dispatch group through ``moe_ep``) against
#: the unmeshed step (the local path's groups), both at float32 compute
#: and ``capacity_factor`` E/K, where neither drops a token: the same
#: math in GEMMs of other row counts.  Loss and grad norm 1e-5 relative;
#: params 4e-5 absolute (Adam moves an element whose gradient is at
#: rounding level by up to its rate either way, and the two steps' rates,
#: 3e-6 and 6e-6, bound that at 2 x 1.8e-5); each m and v leaf within 1e-4
#: of its norm
TRAIN_STACKS_MOE_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "params": 4e-5,
                        "moments": 1e-4}
#: what the card keeps free beside two states and one set of gradients
TRAIN_STACKS_HEADROOM = 8e9


def _stack_cfg(arch, depth):
    """The phase's config of ``arch``: the launcher's (``grad_accum`` 1),
    cut to ``depth`` layers; the MoE at float32 compute and
    ``capacity_factor`` E/K."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), grad_accum=1)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def _stack_compare(torch, cfg, m_plain, m_mesh, plain, meshed):
    """The meshed run against the unmeshed one: bit-equal for a dense-MLP
    stack, the MoE within ``TRAIN_STACKS_MOE_TOL``; returns whether the
    two were bit-equal (metrics and state) and the readings."""
    same = (all(torch.equal(a[k], b[k].to(a[k].device))
                for a, b in zip(m_plain, m_mesh) for k in a)
            and _bit_equal(torch, meshed, plain))
    if not cfg.n_experts and not same:
        _fail(f"[train-stacks] {cfg.name}: the 1x1 mesh steps are not "
              f"bit-equal to the unmeshed steps (metrics {m_mesh} vs "
              f"{m_plain})")
    if same:
        return same, {"loss": 0.0, "grad_norm": 0.0, "params": 0.0,
                      "moments": 0.0}
    got = {k: max(abs(float(a[k]) - float(b[k])) / abs(float(a[k]))
                  for a, b in zip(m_plain, m_mesh))
           for k in ("loss", "grad_norm")}
    got["params"] = _tree_diff(meshed["params"], plain["params"])
    got["moments"] = _moment_err(meshed["opt"], plain["opt"])
    if any(got[k] > tol for k, tol in TRAIN_STACKS_MOE_TOL.items()):
        _fail(f"[train-stacks] {cfg.name}: the 1x1 mesh steps are off the "
              f"unmeshed steps by {got} (bounds {TRAIN_STACKS_MOE_TOL})")
    return same, got


def phase_train_stacks(torch, pa, card, dev):
    """Phase 4k: each of ``TRAIN_STACKS`` on a 1x1 mesh through the
    launcher's route against the unmeshed step (module doc).  Returns the
    numbers of the ``[train-stacks]`` line."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.device import stage
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import shard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import params_shape
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    spmd, spmd_train = [0], step_mod.spmd_train

    def counted_spmd(m, **kw):
        spmd[0] += 1
        return spmd_train(m, **kw)
    step_mod.spmd_train = counted_spmd
    pa.launches = 0
    total = torch.cuda.get_device_properties(dev).total_memory
    opt = AdamWConfig()
    out = {}
    try:
        for arch, depth, B, S in TRAIN_STACKS:
            t0 = time.perf_counter()
            cfg = _stack_cfg(arch, depth)
            n = sum(t.numel() for t in leaves(params_shape(cfg)))
            # float32 params, m and v a state; float32 gradients a step
            on_card = 28 * n + TRAIN_STACKS_HEADROOM < total
            data = SyntheticLMData(cfg, B, cfg.n_vis_tokens + S, seed=0)
            batches = [{k: stage(v, dev) for k, v in
                        data.batch_at(i).items()}
                       for i in range(TRAIN_STACKS_STEPS)]
            step = make_train_step(cfg, opt)
            mesh = make_host_mesh(1, 1, device="cuda")
            spmd[0] = 0
            plain, meshed = init_train_state(cfg, opt, 0, dev), None
            if on_card:
                meshed = shard_state(cfg, init_train_state(cfg, opt, 0, dev),
                                     mesh, dev)
            m_plain, m_mesh, host_ms = [], [], []

            def mesh_step(i, state):
                torch.cuda.synchronize()
                if i == TRAIN_STACKS_STEPS - 1:
                    torch.cuda.set_sync_debug_mode("error")
                t1 = time.perf_counter()
                try:
                    with logical_axes(mesh, n_experts=cfg.n_experts):
                        state, m = step(state, batches[i])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t1) * 1e3)
                m_mesh.append(m)
                return state

            for i in range(TRAIN_STACKS_STEPS):
                plain, m = step(plain, batches[i])
                m_plain.append(m)
                if on_card:
                    meshed = mesh_step(i, meshed)
            if not on_card:
                # the unmeshed state on the host, then the meshed run
                plain = tree_map(lambda t: t.to("cpu", copy=True), plain)
                _free(torch)
                meshed = shard_state(cfg, init_train_state(cfg, opt, 0, dev),
                                     mesh, dev)
                for i in range(TRAIN_STACKS_STEPS):
                    meshed = mesh_step(i, meshed)
            if not all(math.isfinite(float(m["loss"])) for m in m_mesh):
                _fail(f"[train-stacks] {arch}: losses {m_mesh}")
            same, errs = _stack_compare(torch, cfg, m_plain, m_mesh, plain,
                                        meshed)
            if spmd[0] != TRAIN_STACKS_STEPS:
                _fail(f"[train-stacks] {arch}: {spmd[0]} of "
                      f"{TRAIN_STACKS_STEPS} mesh steps went through the "
                      f"SPMD step")
            calls = {k: dict(v) for k, v in mesh.collectives.items()}
            if any(c["calls"] or c["bytes"] for c in calls.values()):
                _fail(f"[train-stacks] {arch}: a 1x1 mesh made collectives: "
                      f"{calls}")
            out[arch] = {
                "layers": cfg.n_layers, "params": n, "batch": B,
                "positions": cfg.n_vis_tokens + S,
                "compute_dtype": cfg.compute_dtype,
                "unmeshed_state_on": "card" if on_card else "host",
                "losses": [float(m["loss"]) for m in m_mesh],
                "grad_norms": [float(m["grad_norm"]) for m in m_mesh],
                "bit_equal": same, "errs": errs,
                "spmd_steps": spmd[0], "host_ms": host_ms,
                "seconds": time.perf_counter() - t0}
            print(f"[train-stacks] {card}: {cfg.name} ({cfg.n_layers} "
                  f"layers, {n} params, {cfg.compute_dtype} compute) on a "
                  f"1x1 mesh, {TRAIN_STACKS_STEPS} steps of {B} x "
                  f"{cfg.n_vis_tokens + S}: "
                  f"{'bit-equal to' if same else 'within bounds of'} "
                  f"the unmeshed steps ({errs}); losses "
                  f"{out[arch]['losses']}; host ms a mesh step "
                  f"{[round(x, 3) for x in host_ms]} (the last under "
                  f"set_sync_debug_mode('error')); unmeshed state on the "
                  f"{out[arch]['unmeshed_state_on']}; "
                  f"{out[arch]['seconds']:.1f} s")
            del plain, meshed, batches, m_plain, m_mesh
            _free(torch)
    finally:
        step_mod.spmd_train = spmd_train
    if pa.launches != 0:
        _fail(f"[train-stacks] the paged-attention kernel ran {pa.launches} "
              f"times in training")
    res = {"stacks": out, "paged_attention_launches": pa.launches}
    print(f"[train-stacks] {json.dumps({'train_stacks': res})}")
    return res


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
    print(f"[hetero] {card}: ring wrap {cfg.name} ({cfg.n_layers} layers: "
          f"{geom.n_ring} ring, {geom.n_full} full): {WRAP_PROMPT} prompt + "
          f"{WRAP_NEW} new tokens (positions {WRAP_PROMPT}..{lifetime - 2} "
          f"decoded across the window of {geom.window}), {steps} token "
          f"steps in {wall:.3f} s wall ({wall / steps * 1e3:.2f} ms per "
          f"step); kernel launches {launches} = {n_attn} x {steps}; full "
          f"layers' pages per horizon {seen}; ring {geom.ring_pages} frames "
          f"per slot, k_ring {tuple(eng.state.k_ring.shape)}; {n}/"
          f"{len(req.out)} tokens equal to the plain greedy reference{tail} "
          f"({time.perf_counter() - t1:.1f} s)")
    return launches


#: gemma3's swap serve: each image carries 40 ring layers x 128 frames
#: (671,088,640 B) and is charged n_pages + 128 tier pages; room for three
GEMMA_SWAP_TIER = 3 * (16 + 128)


def phase_ring_swap(torch, pa, card, cfg, params):
    """gemma3-12b at its published config on phase 4d's schedule (pool
    pressure from its 8 full layers' pages) with a host swap tier: every
    request against the plain greedy decode, launches 48 x token steps,
    each swap image carrying the ring frames and charged n_pages + 128,
    tier and pool drained.  Returns the kernel's launches."""
    from repro_torch.launch import serve

    box = {}

    def run():
        box["out"] = serve.serve(
            cfg, params, requests=6, max_new=SWAP_NEW, prompt_len=60,
            n_pages=33, max_pages_per_seq=16,
            host_swap_pages=GEMMA_SWAP_TIER, prefix_cache=False,
            device=params["embed"].device)
        return box["out"]
    with _SwapClock() as clock:
        launches, engine = phase_serve(torch, pa, card, run, "hetero swap",
                                       n_new=SWAP_NEW)
    sched, alloc = box["out"][2], engine.alloc
    ring = engine.geom.ring_pages
    if (sched.stats["swap_outs"] < 1
            or sched.stats["swap_outs"] != sched.stats["swap_ins"]
            or any(c != n + ring for _, _, n, c in clock.outs)
            or alloc.swap.used_pages != 0 or alloc.pages_in_use != 0
            or engine.free_pages != alloc.free_pages):
        _fail(f"[hetero] gemma3 swap: sched stats {dict(sched.stats)}, "
              f"swap-outs (ms, bytes, pages, charge) {clock.outs}, tier "
              f"held {alloc.swap.used_pages}")
    print(f"[hetero] {card}: gemma3-12b swap: preemptions "
          f"{sched.stats['preemptions']}, swap-outs "
          f"{sched.stats['swap_outs']}, charge = pages + {ring} ring "
          f"frames; {clock.line()}; prefill tokens "
          f"{sched.stats['prefill_tokens']}; tier and pool drained")
    return launches


def phase_swap_across_slots(torch, pa, card, cfg, params):
    """One request on slot 0 of a 2-slot engine: 4 prompt tokens, 3
    decode steps, ``swap_out``, ``swap_in`` on slot 1, 3 more steps; the
    tokens against the same engine's uninterrupted decode.  The kernel's
    count is read over the swapped run.  Returns it."""
    from repro_torch.serve.engine import PagedEngine

    dev = params["embed"].device
    prompt = torch.tensor([[3, 1, 4, 1], [0, 0, 0, 0]], dtype=torch.int32,
                          device=dev)

    def mk():
        eng = PagedEngine(cfg, params, n_pages=17, page_size=8, max_seqs=2,
                          max_pages_per_seq=4, host_swap_pages=400,
                          device=dev)
        blk = eng.alloc.alloc(0)
        first = eng.prefill_chunk(prompt, torch.tensor(
            [4, 0], dtype=torch.int32, device=dev))
        eng.alloc.commit(blk, 4)
        return eng, blk, int(first[0])

    def steps(eng, slot, t, n):
        out = []
        for _ in range(n):
            toks = torch.zeros(2, dtype=torch.int32, device=dev)
            toks[slot] = t
            mask = torch.arange(2, device=dev) == slot
            t = int(eng.decode(toks, mask)[slot, 0].argmax())
            out.append(t)
        return out

    eng, _, t0 = mk()
    ref = [t0] + steps(eng, 0, t0, 6)
    del eng
    pa.launches = 0
    eng, blk, t0 = mk()
    out = [t0] + steps(eng, 0, t0, 3)
    eng.alloc.commit(blk, 4 + 3)
    ms = time.perf_counter()
    if not eng.alloc.swap_out(blk):
        _fail(f"[hetero] {cfg.name}: swap_out refused")
    img = eng.alloc.swap.images[blk.bid]
    ms = (time.perf_counter() - ms) * 1e3
    eng.alloc.swap_in(blk, 1)
    out += steps(eng, 1, out[-1], 3)
    torch.cuda.synchronize()
    launches, n_steps = pa.launches, eng.stats["token_steps"]
    n_attn = eng.geom.n_full + eng.geom.n_ring
    if out != ref or launches != n_attn * n_steps:
        _fail(f"[hetero] {cfg.name} swap across slots: tokens {out}, "
              f"uninterrupted {ref}; launches {launches} != {n_attn} x "
              f"{n_steps}")
    nbytes = img.k.nbytes + img.v.nbytes + sum(a.nbytes for a in img.aux)
    print(f"[hetero] {card}: {cfg.name} swap across slots: swap_out of "
          f"slot 0 mid-decode ({nbytes} B: ring frames and recurrent rows, "
          f"charge {img.charge} pages, {ms:.3f} ms host), swap_in on slot "
          f"1; tokens {out} == the uninterrupted decode; kernel launches "
          f"{launches} = {n_attn} x {n_steps} token steps")
    return launches


#: a decode step's logits, 1x1 mesh vs unmeshed engine, over the largest
#: magnitude: the MoE's expert products take other shapes (one dispatch
#: group against one per token), so float32 sums round in another order
MOE_MESH_REL = 1e-4


def _decode_logits(torch, eng):
    """One 4-token prefill and one decode step on every slot of ``eng``:
    the step's logits [slots, vocab].  Frees the slots it took."""
    S, dev = eng.max_seqs, eng.device
    for s in range(S):
        eng.alloc.reserve_span(eng.alloc.alloc(s), 4, 1)
    prompt = (torch.arange(1, 5, dtype=torch.int32, device=dev)
              + torch.arange(S, dtype=torch.int32, device=dev)[:, None])
    first = eng.prefill_chunk(prompt, torch.full((S,), 4, dtype=torch.int32,
                                                 device=dev))
    logits = eng.decode(first, torch.ones(S, dtype=torch.bool,
                                          device=dev))[:, 0]
    for blk in list(eng.alloc.blocks.values()):
        eng.alloc.free(blk)
    return logits


def phase_moe_mesh(torch, pa, card, cfg, params, plain_outs):
    """Mixtral (full width, 2 layers) on a 1x1 device mesh: the kernel
    engine through ``serve.serve(mesh=make_host_mesh(1, 1))``, its MoE
    through ``moe_ep`` (counted by a wrapper around the module's
    function, which ``models/layers.py::moe`` looks up at each call).
    Tokens equal the unmeshed serve's, moe_ep calls = MoE layers x token
    steps, no collective, launches 2 x token steps (phase_serve), a
    sync-free horizon, one decode step's logits within ``MOE_MESH_REL`` of
    the unmeshed engine's, and horizons of both engines in turns.  Returns
    the serve's launches."""
    from repro_torch.distributed import moe_ep as ep_mod
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import PagedEngine

    dev = params["embed"].device
    mesh = make_host_mesh(1, 1, device="cuda")
    real, n_ep = ep_mod.moe_ep, [0]

    def counted(*args):
        n_ep[0] += 1
        return real(*args)
    box = {}

    def run():
        box["out"] = serve.serve(cfg, params, device=dev, mesh=mesh,
                                 kv_layout="shard")
        return box["out"]
    ep_mod.moe_ep = counted
    try:
        launches, engine = phase_serve(torch, pa, card, run, "hetero",
                                       reference=False)
    finally:
        ep_mod.moe_ep = real
    outs = {r.rid: r.out for r in box.pop("out")[0]}
    steps = engine.stats["token_steps"]
    if outs != plain_outs:
        _fail(f"[hetero] {cfg.name} 1x1 mesh tokens {outs} differ from the "
              f"unmeshed serve's {plain_outs}")
    if n_ep[0] != cfg.n_layers * steps:
        _fail(f"[hetero] {cfg.name} 1x1 mesh: moe_ep called {n_ep[0]} times"
              f", want {cfg.n_layers} MoE layers x {steps} token steps")
    bumped = engine.cfg.capacity_factor
    phase_sync_free(torch, engine, card)
    plain = PagedEngine(cfg, params, page_size=engine.page_size,
                        max_seqs=engine.max_seqs, n_pages=engine.n_pages,
                        attn_impl="kernel", device=dev)
    a, b = _decode_logits(torch, plain), _decode_logits(torch, engine)
    err = float((a - b).abs().max() / a.abs().max())
    if not err <= MOE_MESH_REL:
        _fail(f"[hetero] {cfg.name} 1x1 mesh: decode logits off the "
              f"unmeshed engine's by {err:.3e} of the largest")
    turns = _horizon_turns(torch, {"plain": plain, "mesh": engine})
    if any(c["calls"] or c["bytes"] for c in mesh.collectives.values()):
        _fail(f"[hetero] a 1x1 mesh made collectives: {mesh.collectives}")
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[hetero] {card}: {cfg.name} on a 1x1 mesh (capacity_factor "
          f"{cfg.capacity_factor} -> {bumped}): tokens of all 6 requests "
          f"equal the unmeshed serve's; moe_ep {n_ep[0]} calls = "
          f"{cfg.n_layers} x {steps} token steps; {launches} kernel "
          f"launches; no collective; decode logits off the unmeshed "
          f"engine's by {err:.3e} of the largest (bound {MOE_MESH_REL})")
    print(f"[hetero] {card}: {cfg.name} decode_many(K=8) host ms in turns "
          f"(plain, mesh, mesh, plain) x 4: plain {turns['plain']}, mesh "
          f"{turns['mesh']}; medians {med['plain']:.3f} and "
          f"{med['mesh']:.3f}, mesh / plain {med['mesh'] / med['plain']:.4f}")
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


#: how long the parent waits for the child to finish timing the kernel at
#: the ring shapes before it goes on with its own phases
HETERO_TIMED_WAIT_S = 300


def start_hetero(torch):
    """Start phase 11 in a process of its own and return it once the child
    has timed the kernel at the ring shapes (``HETERO_RESULT`` with the
    suffix ``.timed``), so that no launch of this process falls inside
    those timings.  The child then serves its stacks while this process
    runs phases 4d-4f: both are host-bound (the card idles about 90% of
    a qwen3 horizon), so sharing the card takes about 280 s off the
    script's time.  The child's output goes to files that
    :func:`join_hetero` prints.  Run before phase 7, in this process or in
    a child, phase 11 left the profiler of this process losing launches
    of the brightness call (the first 6 of its 8 in one run, all of them
    in the next two), while the same phases without it, a fresh process
    and one idle for 200 s saw all 8; so it starts after every phase of
    this process that reads the profiler (4c's tick, 4g's step, 4h's
    horizon), and its tens of gigabytes and millions of launches end with
    the child."""
    HETERO_RESULT.parent.mkdir(exist_ok=True)
    timed = HETERO_RESULT.with_suffix(".timed")
    for path in (HETERO_RESULT, timed):
        path.unlink(missing_ok=True)
    _free(torch)
    log = (open(HETERO_RESULT.with_suffix(".out"), "w"),
           open(HETERO_RESULT.with_suffix(".err"), "w"))
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              "--hetero", str(HETERO_RESULT)],
                             stdout=log[0], stderr=log[1])
    child.started, child.log = time.perf_counter(), log
    while not timed.exists():
        if child.poll() is not None or (time.perf_counter() - child.started
                                        > HETERO_TIMED_WAIT_S):
            stop_hetero(child)
            _fail(f"[hetero] the child did not time the ring shapes within "
                  f"{HETERO_TIMED_WAIT_S} s (exit code {child.returncode})")
        time.sleep(0.2)
    return child


def stop_hetero(child):
    """Kill the child if it still runs, and print its output."""
    if child.poll() is None:
        child.kill()
    child.wait()
    for f, stream in zip(child.log, (sys.stdout, sys.stderr)):
        f.close()
        stream.write(Path(f.name).read_text())
        stream.flush()


def join_hetero(child):
    """Wait for the child of :func:`start_hetero` (killed at
    ``HETERO_TIMEOUT_S`` from its start) and print its output.  Returns
    (max abs err at the ring shapes, ring timing rows, kernel launches by
    path)."""
    try:
        child.wait(max(1.0, HETERO_TIMEOUT_S
                       - (time.perf_counter() - child.started)))
    except subprocess.TimeoutExpired:
        stop_hetero(child)
        _fail(f"[hetero] did not end within {HETERO_TIMEOUT_S} s")
    stop_hetero(child)
    if child.returncode != 0:
        _fail(f"[hetero] exited with code {child.returncode}")
    res = json.loads(HETERO_RESULT.read_text())
    return res["ring_err"], res["ring_rows"], res["launches"]


def hetero_main(out: str) -> int:
    """The child of :func:`start_hetero` (``chip_smoke.py --hetero OUT``):
    phase 11 on the card, its result as JSON in ``OUT``."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serve.engine import batched_paged_attention

    dev, card = _setup_card(torch)
    ring_err, ring_rows, launches = phase_hetero(
        torch, F, ops.paged_attention, ops, batched_paged_attention, dev,
        card, Path(out).with_suffix(".timed").touch)
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


def phase_hetero(torch, F, pa, ops, batched, dev, card, timed=None):
    """The mixed stacks on the card: the kernel at the ring shapes (then
    ``timed()``, if given); gemma3-12b at its published config served,
    sync-free and timed; the ring wrapping on a 1,032-token request;
    recurrentgemma-9b and mamba2-1.3b at their published configs and
    mixtral-8x7b at full width cut to 2 layers, each against its plain
    greedy decode."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import model as tm

    t0 = time.perf_counter()
    ring_err, ring_rows = phase_ring_kernel(torch, F, pa, ops, batched, dev)
    print(f"[hetero] ring kernel part: {time.perf_counter() - t0:.1f} s")
    if timed is not None:
        timed()
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
            box = {}

            def run():
                box["out"] = serve.serve(cfg, params, device=dev)
                return box["out"]
            launches[arch], engine = phase_serve(torch, pa, card, run,
                                                 "hetero")
            moe_outs = {r.rid: r.out for r in box.pop("out")[0]}
            del params
        else:
            launches[arch], engine = phase_serve(
                torch, pa, card,
                lambda: serve.main(HETERO_ARGV + ["--arch", arch]), "hetero")
        phase_sync_free(torch, engine, card)
        cfg, params = engine.cfg, engine.params
        del engine
        _free(torch)
        if arch == "gemma3-12b":
            launches["ring wrap"] = phase_ring_wrap(torch, pa, card, cfg,
                                                    params)
            _free(torch)
            launches[f"{arch} swap"] = phase_ring_swap(torch, pa, card, cfg,
                                                       params)
        elif arch in ("recurrentgemma-9b", "mamba2-1.3b"):
            launches[f"{arch} swap across slots"] = phase_swap_across_slots(
                torch, pa, card, cfg, params)
        else:
            launches[f"{arch} mesh 1x1"] = phase_moe_mesh(
                torch, pa, card, cfg, params, moe_outs)
        del params
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
    max_err = max(max_err, phase_kernel_shared(torch, pa, ops,
                                               batched_paged_attention, dev))
    timings = {label: phase_timing(torch, F, pa, ops,
                                   batched_paged_attention, dev, label, *rest)
               for label, *rest in PA_TIMED}
    timing = timings["19"]
    print(f"[kernel] phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    box = {}

    def serve_run():
        box["out"] = serve.main(SERVE_ARGV)
        return box["out"]
    launches, engine = phase_serve(torch, pa, card, serve_run)
    serve_outs = {r.rid: r.out for r in box.pop("out")[0]}
    serve_horizon_ms = phase_sync_free(torch, engine, card)
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

    # phase 4c runs here, after phase 7: run before it, its profiled ticks
    # left the profiler losing the first 6 of the brightness call's 8
    # launches (as phase 11 did in the same place)
    _free(torch)
    t0 = time.perf_counter()
    prefix_launches = phase_prefix(torch, pa, card)
    print(f"[prefix] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    phase_train(torch, pa, card, dev)
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    phase_train_mesh(torch, pa, card, dev)
    print(f"[train-mesh] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    phase_train_stacks(torch, pa, card, dev)
    print(f"[train-stacks] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    mesh_launches = phase_mesh(torch, pa, card, serve_outs, serve_horizon_ms)
    print(f"[mesh] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    phase_dryrun(torch, dev, card)
    print(f"[dryrun] phase took {time.perf_counter() - t0:.1f} s")

    _free(torch)
    t0 = time.perf_counter()
    legacy_launches = phase_legacy(torch, pa, card, serve_outs)
    print(f"[legacy] phase took {time.perf_counter() - t0:.1f} s")

    # phase 11 in its child beside phases 4d-4f (start_hetero)
    t_hetero = time.perf_counter()
    child = start_hetero(torch)
    print(f"[hetero] child started; its ring timings took "
          f"{time.perf_counter() - t_hetero:.1f} s")
    try:
        _free(torch)
        t0 = time.perf_counter()
        swap_launches, swap_outs = phase_swap(torch, pa, card)
        print(f"[swap] phase took {time.perf_counter() - t0:.1f} s")

        _free(torch)
        t0 = time.perf_counter()
        traffic_launches = phase_traffic(torch, pa, card, dev, swap_outs)
        print(f"[traffic] phase took {time.perf_counter() - t0:.1f} s")

        _free(torch)
        t0 = time.perf_counter()
        chaos_launches = phase_chaos(torch, pa, card, dev, serve_outs,
                                     swap_outs)
        print(f"[chaos] phase took {time.perf_counter() - t0:.1f} s")
    except BaseException:
        stop_hetero(child)
        raise
    t0 = time.perf_counter()
    ring_err, ring_rows, hetero_launches = join_hetero(child)
    print(f"[hetero] phase took {time.perf_counter() - t_hetero:.1f} s "
          f"(waited {time.perf_counter() - t0:.1f} s for it after 4f)")

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
    by_path = {"qwen3-0.6b": launches,
               **{f"qwen3-0.6b prefix {mode}": n
                  for mode, n in prefix_launches.items()},
               **{f"qwen3-0.6b swap {mode}": n
                  for mode, n in swap_launches.items()},
               **{f"qwen3-0.6b traffic {mode}": n
                  for mode, n in traffic_launches.items()},
               **{f"qwen3-0.6b chaos {mode}": n
                  for mode, n in chaos_launches.items()},
               "qwen3-0.6b mesh 1x1": mesh_launches,
               "qwen3-0.6b legacy": legacy_launches,
               **hetero_launches}
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
