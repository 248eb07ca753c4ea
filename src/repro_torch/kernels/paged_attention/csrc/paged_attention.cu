// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::_paged_attn_kernel
// (driven per sequence by paged_attn_one_seq and vmapped over slots by
// serve/engine.py::_kernel_paged_attention).  One launch serves every slot.
//
// Contract (serve/engine.py::batched_paged_attention):
//   q          [S, n_kv, g, d]          f32, pre-scaled by 1/sqrt(d)
//   k/v pages  [n_pages, ps, n_kv, d]   f32 (one layer of the pool)
//   page_table [S, pt_stride]           i32, first max_pages columns read
//   seq_lens   [S]                      i32, clipped to [0, max_pages * ps]
//   out        [S, n_kv, g, d]          f32 = acc / max(l, 1e-30)
// Positions >= seq_len are never read and their page-table entries never
// dereferenced, so seq_len = 0 gives zeros and the pages past a slot's
// length (null page 0, or any id) cannot affect it.  d % 4 == 0 and q, k,
// v 16-byte aligned (the wrapper checks).
//
// What bounds it: bytes.  Per slot it must read K and V for seq_len tokens,
// 2 * seq_len * n_kv * d * 4 bytes, plus q and out; it does 4 flops per K/V
// element pair, far below the card's ratio of compute to memory rate.  At
// decode lengths (the serve's 19 tokens: 0.6 MB) the bytes take 0.2 us, so
// the time is the launch plus the chain of dependent memory round trips.
//
// What the design does about that:
//   * grid (n_kv x row groups, S, P).  One block per (kv head, slot, page
//     split); a block takes G query rows of the kv head's GQA group (G = 1,
//     2 or 4, <= 2 past d = 128; all g = 2 rows on the main path; a group
//     of 3 takes G = 4 with one row masked), so one warp reads each K/V
//     row once for all of them: lane l loads elements 4l..4l+3 as one
//     16-byte float4, 32 lanes cover d = 128 in one coalesced 512-byte
//     load, and the lane dots it with the rows it holds in registers,
//     keeping one online softmax (m, l, acc) per row;
//   * one round trip before K/V: seq_lens, the q rows and the page rows
//     of the warp's first kBatch tiles are loaded at block start, all at
//     once.  The page ids need only max_pages (a host int) and the warp's
//     tile numbers, which in block 0 do not depend on seq_len, so they are
//     loaded before the length arrives (and never dereferenced past it);
//     lane j turns the id of token j % T of the warp's tile j / T into its
//     pool row (page * ps + p % ps) once per batch, and the others read
//     the row by shuffle;
//   * K and V of a tile are issued together (both need only the row), and
//     the next tile's loads are issued before the current tile is reduced:
//     two tiles in flight per warp, in two register buffers (T = 4 tokens
//     at d <= 128, 2 at d <= 256; 16 float4 loads per lane in flight).
//     The next kBatch rows are fetched a batch ahead.  Streaming loads
//     (past L1) read a batch of long sequences faster but lower the rate
//     one SM can pull, on which a batch with one long sequence among
//     short ones runs; so every block counts, from all the lengths (read
//     in the same round trip), the blocks that work in the launch, and
//     streams only when they fill the SMs;
//   * few instructions per tile, since 16 warps per SM (the register
//     budget: two planned blocks of 8 warps) must keep the loads coming:
//     the T x G dot products of a tile are reduced across the warp
//     together by one transposed butterfly (lane L ends with score
//     L >> (5 - log2(T G)); 9 shuffles for T G = 8 instead of 40), each
//     lane takes the exponent of its own score only (base 2: q is scaled
//     by log2(e) once) and the probabilities reach every lane by shuffle;
//     masked tokens score -1e30, so no branch;
//   * tiles go to warps in pairs (warp w: tiles 2w, 2w + 1, 2w + 2W, ...),
//     since a warp has two in flight at no extra latency: at short
//     lengths half as many warps do the work and merge.  Warps without a
//     tile exit at once.  One warp with work writes out directly; more
//     merge their partial states through shared memory behind a named
//     barrier that counts only them, warp 0 merging in warp order;
//   * long contexts: P blocks per (kv head, slot), planned on the host from
//     host ints (ops.py::split_plan).  Each block reads seq_len and works
//     out how many blocks the sequence needs: floor(seq_len / chunk), at
//     most P, in spans of whole tiles (chunk tokens or more each; the last
//     may be up to nb - 1 tiles short).  chunk is 64 tokens as planned, one
//     tile when the caller forces P.  Blocks past that count exit at
//     once.  When one block suffices (every length below 2 chunks) it
//     writes out directly: no workspace, no merge.  Otherwise each block
//     writes its merged partial to a workspace, takes a ticket from a
//     per-(slot, column) counter, and the last block to arrive merges the
//     partials in block order (so two runs are bit-equal) and puts the
//     counter back to 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;          // 512 threads, up to 128 registers each
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* page_table;
  const int* seq_lens;
  float* out;
  float* ws;                           // [cols * S * P * G * (d + 2)] f32
  int* counters;                       // [S * cols] i32, 0 between launches
  int pt_stride, n_kv, g, d, ps, max_pages, n_rg;
  int chunk;                           // least tokens of a block in a split
  int n_sm;                            // SMs of the card
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// atomicAdd(p, 1) with acquire-release order at GPU scope
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void scale4(float4& a, float s) {
  a.x *= s; a.y *= s; a.z *= s; a.w *= s;
}

__device__ __forceinline__ void axpy4(float4& a, float s, float4 b) {
  a.x = fmaf(s, b.x, a.x); a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z); a.w = fmaf(s, b.w, a.w);
}

// The online softmax states (running max m, sum l, weighted V sum acc) of
// G query rows, in base 2; a lane holds its NV float4 of each acc row.
template <int NV, int G>
struct State {
  float m[G], l[G];
  float4 acc[G][NV];
};

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// NV float4 per lane per head row (d <= 128 * NV); G query rows per block,
// a power of two.
template <int NV, int G>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
paged_attn_kernel(const Args a) {
  constexpr int T = 4 / NV;            // tokens per tile
  constexpr int kBatch = kWarp / T;    // tiles per batch of page rows
  constexpr int N = T * G;             // scores of a tile (<= 16)
  constexpr int kLogN = log2i(N);
  constexpr int kLogT = log2i(T);
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ float4 smem[];     // [W][G][d/4] acc, then [W][G][2] m, l

  const int x = blockIdx.x, s = blockIdx.y, pb = blockIdx.z;
  const int P = gridDim.z;
  const int W = blockDim.x / kWarp;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int h = x / a.n_rg;
  const int r0 = (x % a.n_rg) * G;
  const int d4 = a.d / 4;
  const int ps = a.ps;
  const int max_tok = a.max_pages * ps;
  const int* pt = a.page_table + (int64_t)s * a.pt_stride;

  // the warp's i-th tile, counted from its block's first: tiles go to
  // warps in pairs, warp w taking 2w, 2w + 1, 2w + 2W, 2w + 2W + 1, ...
  auto tile_of = [&](int i) { return 2 * w + (i & 1) + (i >> 1) * 2 * W; };
  // pool rows of the warp's tiles i in batch b, from the block's first
  // tile t0: lane j holds token j % T of tile j / T of the batch (0 past
  // max_pages; rows past seq_len are never dereferenced)
  auto row_batch = [&](int t0, int b) -> unsigned {
    const int p = (t0 + tile_of(b * kBatch + lane / T)) * T + lane % T;
    if (p >= max_tok) return 0u;
    return (unsigned)__ldg(pt + p / ps) * (unsigned)ps + (unsigned)(p % ps);
  };

  // blocks that work on a sequence of this length (the partition below)
  auto blocks_for = [&](int len_j) {
    const int n = min(max(len_j, 0), max_tok);
    const int t = cdiv(n, T);
    return t ? cdiv(t, cdiv(t, min(P, max(1, n / a.chunk)))) : 1;
  };

  // --- one round trip: the lengths, block 0's first page rows, the q rows
  const int S = gridDim.y;
  const int len = __ldg(a.seq_lens + s);
  const int len_lane = lane < S ? __ldg(a.seq_lens + lane) : 0;
  const unsigned rows_spec = row_batch(0, 0);
  float4 qr[G][NV];
  const float4* q4 = reinterpret_cast<const float4*>(a.q) +
                     (((int64_t)s * a.n_kv + h) * a.g + r0) * d4;
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int e = c * kWarp + lane;
      qr[r][c] = (r0 + r < a.g && e < d4) ? __ldg(q4 + r * d4 + e) : zero4();
      scale4(qr[r][c], kLog2e);        // scores in base 2
    }
  }
  // The blocks that work in this launch (counted up to n_sm).  When they
  // fill the SMs, the card's bandwidth sets the pace and K/V loads stream
  // past L1; below that one SM's rate does, and loads that allocate in L1
  // let an SM pull more.
  int busy = lane < S ? blocks_for(len_lane) : 0;
  for (int j = lane + kWarp; j < S && busy < a.n_sm; j += kWarp) {
    busy += blocks_for(__ldg(a.seq_lens + j));
  }
  const bool stream = (int64_t)__reduce_add_sync(kFull, min(busy, a.n_sm)) *
                          gridDim.x >= a.n_sm;

  // --- the partition, decided here from seq_len
  const int n_tok = min(max(len, 0), max_tok);
  const int tiles = cdiv(n_tok, T);
  const int tpb = tiles ? cdiv(tiles, min(P, max(1, n_tok / a.chunk))) : 0;
  const int nb = blocks_for(len);
  if (pb >= nb) return;
  const int t_begin = pb * tpb;
  const int n_blk = min(tiles, t_begin + tpb) - t_begin;
  const int active = max(1, min(W, cdiv(n_blk, 2)));
  if (w >= active) return;
  // the warp's tile count: whole pairs of 2W tiles, then what is left
  const int rem = n_blk - 2 * w;
  const int n_i = rem <= 0 ? 0
                           : rem / (2 * W) * 2 + min(2, rem % (2 * W));
  unsigned row_cur = pb == 0 ? rows_spec : row_batch(t_begin, 0);
  unsigned row_nxt = n_i > kBatch ? row_batch(t_begin, 1) : 0u;

  State<NV, G> st;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) st.acc[r][c] = zero4();
  }

  const float4* k4 = reinterpret_cast<const float4*>(a.k);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  // issue the K and V loads of the warp's i-th tile
  auto load = [&](int i, float4 (&kr)[T][NV], float4 (&vr)[T][NV]) {
    const int slot = i % kBatch;
    if (slot == 0 && i > 0) {
      row_cur = row_nxt;
      row_nxt = i + kBatch < n_i ? row_batch(t_begin, i / kBatch + 1) : 0u;
    }
    const int p0 = (t_begin + tile_of(i)) * T;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const unsigned row = __shfl_sync(kFull, row_cur, slot * T + u);
      const int64_t base = ((int64_t)row * a.n_kv + h) * d4;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int e = c * kWarp + lane;
        const bool ok = p0 + u < n_tok && e < d4;
        if (!ok) {
          kr[u][c] = vr[u][c] = zero4();
        } else if (stream) {
          kr[u][c] = __ldcs(k4 + base + e);
          vr[u][c] = __ldcs(v4 + base + e);
        } else {
          kr[u][c] = __ldg(k4 + base + e);
          vr[u][c] = __ldg(v4 + base + e);
        }
      }
    }
  };
  // fold the warp's i-th tile into the G online softmax states
  auto fold = [&](int i, const float4 (&kr)[T][NV],
                  const float4 (&vr)[T][NV]) {
    const int p0 = (t_begin + tile_of(i)) * T;
    float v[N];
#pragma unroll
    for (int u = 0; u < T; ++u) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) acc = dot4(qr[r][c], kr[u][c], acc);
        v[u * G + r] = acc;
      }
    }
    // transposed butterfly: each step halves the values a lane keeps, so
    // lane L ends with the full score idx = L >> (5 - kLogN) = u * G + r
#pragma unroll
    for (int k = 0; k < kLogN; ++k) {
      const int o = 16 >> k;
      const int half = N >> (k + 1);
      const bool upper = lane & o;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = upper ? v[j] : v[j + half];
        const float keep = upper ? v[j + half] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
    float sc = v[0];
#pragma unroll
    for (int o = 16 >> kLogN; o > 0; o >>= 1) {
      sc += __shfl_xor_sync(kFull, sc, o);
    }
    const int idx = lane >> (5 - kLogN);
    const int my_r = idx % G;
    if (p0 + idx / G >= n_tok) sc = kNegInf;
    // the tile's max of each row: over the lanes of the row's T tokens
    float mx = sc;
#pragma unroll
    for (int k = 0; k < kLogT; ++k) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16 >> k));
    }
    float m_mine = 0.f;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float m_new = fmaxf(st.m[r], __shfl_sync(kFull, mx,
                                                     r << (5 - kLogN)));
      const float alpha = exp2f(st.m[r] - m_new);
      st.m[r] = m_new;
      st.l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < NV; ++c) scale4(st.acc[r][c], alpha);
      if (my_r == r) m_mine = m_new;
    }
    const float p = exp2f(sc - m_mine);
#pragma unroll
    for (int u = 0; u < T; ++u) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float pu = __shfl_sync(kFull, p, (u * G + r) << (5 - kLogN));
        st.l[r] += pu;
#pragma unroll
        for (int c = 0; c < NV; ++c) axpy4(st.acc[r][c], pu, vr[u][c]);
      }
    }
  };

  // --- the token loop: two tiles in flight (buffers a, b take turns)
  float4 ka[T][NV], va[T][NV], kb[T][NV], vb[T][NV];
  if (n_i > 0) load(0, ka, va);
  for (int i = 0; i < n_i; i += 2) {
    if (i + 1 < n_i) load(i + 1, kb, vb);
    fold(i, ka, va);
    if (i + 1 >= n_i) break;
    if (i + 2 < n_i) load(i + 2, ka, va);
    fold(i + 1, kb, vb);
  }

  float4* out4 = reinterpret_cast<float4*>(a.out) +
                 (((int64_t)s * a.n_kv + h) * a.g + r0) * d4;
  auto write_out = [&]() {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float denom = fmaxf(st.l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int e = c * kWarp + lane;
        if (r0 + r < a.g && e < d4) {
          const float4 o = st.acc[r][c];
          out4[r * d4 + e] = make_float4(o.x / denom, o.y / denom,
                                         o.z / denom, o.w / denom);
        }
      }
    }
  };
  // merge n partial states into st in the fixed order j = 0 .. n - 1: the
  // max of the m's first, then the weighted sums; partial j's m and l are
  // ml(j, r, 0) and ml(j, r, 1), its acc acc(j, r, e).  Empty partials
  // (m = -1e30, l = 0, acc = 0) add nothing
  auto merge = [&](int n, auto ml, auto acc) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float m_all = kNegInf;
      for (int j = 0; j < n; ++j) m_all = fmaxf(m_all, ml(j, r, 0));
      float l_all = 0.f;
      float4 o[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) o[c] = zero4();
      for (int j = 0; j < n; ++j) {
        const float wgt = exp2f(ml(j, r, 0) - m_all);
        l_all += ml(j, r, 1) * wgt;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int e = c * kWarp + lane;
          if (e < d4) axpy4(o[c], wgt, acc(j, r, e));
        }
      }
      st.m[r] = m_all;
      st.l[r] = l_all;
#pragma unroll
      for (int c = 0; c < NV; ++c) st.acc[r][c] = o[c];
    }
  };

  // --- the warps of this block
  if (active > 1) {
    float* sml = reinterpret_cast<float*>(smem + W * G * d4);
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int e = c * kWarp + lane;
        if (e < d4) smem[(w * G + r) * d4 + e] = st.acc[r][c];
      }
      if (lane == 0) {
        sml[(w * G + r) * 2] = st.m[r];
        sml[(w * G + r) * 2 + 1] = st.l[r];
      }
    }
    // only the active warps arrive; the others have exited
    asm volatile("bar.sync 1, %0;" ::"r"(active * kWarp) : "memory");
    if (w != 0) return;
    merge(active,
          [&](int j, int r, int f) { return sml[(j * G + r) * 2 + f]; },
          [&](int j, int r, int e) { return smem[(j * G + r) * d4 + e]; });
  }
  if (nb == 1) {
    write_out();
    return;
  }

  // --- this sequence is split over nb blocks: the last to arrive merges
  const int64_t col = (int64_t)s * gridDim.x + x;
  const int64_t n_parts = (int64_t)gridDim.x * gridDim.y * P * G;
  float4* ws_acc = reinterpret_cast<float4*>(a.ws) + col * P * G * d4;
  float* ws_ml = a.ws + n_parts * a.d + col * P * G * 2;
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int e = c * kWarp + lane;
      if (e < d4) ws_acc[(pb * G + r) * d4 + e] = st.acc[r][c];
    }
    if (lane == 0) {
      ws_ml[(pb * G + r) * 2] = st.m[r];
      ws_ml[(pb * G + r) * 2 + 1] = st.l[r];
    }
  }
  // the warp's writes, then one acquire-release ticket: the block that
  // draws the last one sees every other block's partial (the barrier and
  // the release carry the lanes' writes, as in a semaphore)
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = ticket_acq_rel(a.counters + col);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != nb - 1) return;
  __syncwarp();                        // every lane reads after the acquire
  merge(nb,
        [&](int j, int r, int f) {
          return __ldcg(ws_ml + (j * G + r) * 2 + f);
        },
        [&](int j, int r, int e) {
          return __ldcg(ws_acc + (j * G + r) * d4 + e);
        });
  if (lane == 0) atomicExch(a.counters + col, 0);
  write_out();
}

template <int NV, int G>
int launch(const Args& a, int S, int W, int P, cudaStream_t stream) {
  const dim3 grid(a.n_kv * a.n_rg, S, P);
  const size_t smem = W > 1 ? (size_t)W * G * (a.d + 2) * sizeof(float) : 0;
  paged_attn_kernel<NV, G><<<grid, W * kWarp, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NV>
int launch_rows(const Args& a, int S, int G, int W, int P,
                cudaStream_t stream) {
  if (G == 1) return launch<NV, 1>(a, S, W, P, stream);
  if (G == 2) return launch<NV, 2>(a, S, W, P, stream);
  if constexpr (NV == 1) {
    if (G == 4) return launch<NV, 4>(a, S, W, P, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  rows = query rows per block
// (G = 1, 2 or 4 at d <= 128, 1 or 2 at d <= 256; the g rows go to
// ceil(g / G) blocks, rows past g masked), warps = warps per block sharing
// its tiles (<= 16), blocks = P, blocks per (kv head, slot) at most (the
// kernel uses as many as seq_len needs, at least chunk tokens each), n_sm
// = the card's SMs (from that many working blocks on, loads stream).  ws
// and counters may be null when P == 1; counters must be zero and not used
// by a launch that can run at the same time.  Launches on `stream` and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_paged_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* seq_lens, float* out,
    float* ws, int* counters, int S, int n_kv, int g, int d, int ps,
    int max_pages, int rows, int warps, int blocks, int chunk, int n_sm,
    void* stream) {
  const int nv = d <= 128 ? 1 : 2;
  if (S <= 0 || S > 65535 || n_kv <= 0 || g <= 0 || d <= 0 || d > 256 ||
      d % 4 != 0 || ps <= 0 || max_pages <= 0 || pt_stride < max_pages ||
      (int64_t)max_pages * ps > (1 << 30) || rows < 1 || rows > 4 / nv ||
      (rows & (rows - 1)) != 0 ||
      warps < 1 || warps > kMaxWarps || blocks < 1 || blocks > 65535 ||
      chunk < 1 || n_sm < 1 ||
      (blocks > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{q, k_pages, v_pages, page_table, seq_lens, out, ws, counters,
         pt_stride, n_kv, g, d, ps, max_pages, (g + rows - 1) / rows,
         chunk, n_sm};
  cudaStream_t st = (cudaStream_t)stream;
  return nv == 1 ? launch_rows<1>(a, S, rows, warps, blocks, st)
                 : launch_rows<2>(a, S, rows, warps, blocks, st);
}
