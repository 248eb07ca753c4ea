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
//   seq_lens   [S]                      i32
//   out        [S, n_kv, g, d]          f32 = acc / max(l, 1e-30)
// Positions >= seq_len are never read, so seq_len = 0 gives zeros and the
// pages past a slot's length (null page 0 included) cannot affect it.
//
// What bounds it: bytes.  Per slot it must read K and V for seq_len tokens,
// 2 * seq_len * n_kv * d * 4 bytes, plus q and out; it does 4 flops per K/V
// element pair, far below the card's ratio of compute to memory rate.
//
// What the design does about that bound:
//   * grid (n_kv, S): one block per (kv head, slot); the block reads that
//     slot's page-table row itself, so translation happens next to the
//     loads that need it (the VBI point of the kernel);
//   * one warp per (query row of the GQA group, token split); lanes stride
//     d, so each K/V row is read with consecutive lanes on consecutive
//     addresses; the g warps of one split read the same rows, served from
//     L1 after the first;
//   * a decode grid is small (slots x kv heads blocks, 32 on the main
//     path against 132 SMs), so the loop over a sequence is a serial chain
//     of memory latencies.  The block splits its tokens over n_split warps
//     per query row (tiles t0 = split, split + n_split, ...), each with its
//     own fp32 online softmax (m, l, acc in registers), and merges the
//     n_split partial states through shared memory at the end;
//   * tokens are taken kTile at a time: the kTile K loads and dot products
//     are independent, so they overlap in flight, and the softmax rescales
//     once per tile;
//   * only ceil(seq_len / ps) pages are visited, so the bytes moved follow
//     the data, not max_pages.
// cp.async/TMA staging and a split over pages across blocks for long
// sequences are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 8;
constexpr int kMaxWarps = 16;          // 512 threads, up to 128 registers each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// PER_LANE = ceil(d / 32) elements of the head vector held by each lane.
// Block = g * n_split warps; warp w serves query row w % g, split w / g.
template <int PER_LANE>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
paged_attn_kernel(const float* __restrict__ q,
                  const float* __restrict__ k_pages,
                  const float* __restrict__ v_pages,
                  const int* __restrict__ page_table, int pt_stride,
                  const int* __restrict__ seq_lens, float* __restrict__ out,
                  int n_kv, int g, int d, int ps, int max_pages,
                  int n_split) {
  extern __shared__ float partial[];   // [n_split][g][2 + d]: m, l, acc
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int qi = warp % g;
  const int split = warp / g;

  const int64_t row = ((int64_t)s * n_kv + h) * g + qi;
  float qr[PER_LANE];
  float acc[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = j * kWarp + lane;
    qr[j] = e < d ? q[row * d + e] : 0.f;
    acc[j] = 0.f;
  }

  const int* pt = page_table + (int64_t)s * pt_stride;
  const int n_tok = min(seq_lens[s], max_pages * ps);
  float m = kNegInf;
  float l = 0.f;

  for (int t0 = split * kTile; t0 < n_tok; t0 += n_split * kTile) {
    float sc[kTile];
    int64_t base[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int p = t0 + u;
      sc[u] = 0.f;
      base[u] = 0;
      if (p < n_tok) {
        const int64_t page = pt[p / ps];
        base[u] = ((page * ps + p % ps) * n_kv + h) * d;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int e = j * kWarp + lane;
          if (e < d) sc[u] += qr[j] * k_pages[base[u] + e];
        }
      }
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      sc[u] = warp_sum(sc[u]);
      if (t0 + u < n_tok) tile_max = fmaxf(tile_max, sc[u]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      if (t0 + u < n_tok) {
        const float p = expf(sc[u] - m_new);
        l += p;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int e = j * kWarp + lane;
          if (e < d) acc[j] += p * v_pages[base[u] + e];
        }
      }
    }
    m = m_new;
  }

  // merge the n_split partial softmax states of each query row
  float* mine = partial + (int64_t)(split * g + qi) * (2 + d);
  if (lane == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = j * kWarp + lane;
    if (e < d) mine[2 + e] = acc[j];
  }
  __syncthreads();
  if (split != 0) return;
  float m_all = kNegInf;
  for (int p = 0; p < n_split; ++p) {
    m_all = fmaxf(m_all, partial[(int64_t)(p * g + qi) * (2 + d)]);
  }
  float l_all = 0.f;
  float o[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) o[j] = 0.f;
  for (int p = 0; p < n_split; ++p) {
    const float* part = partial + (int64_t)(p * g + qi) * (2 + d);
    const float w = expf(part[0] - m_all);
    l_all += part[1] * w;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int e = j * kWarp + lane;
      if (e < d) o[j] += part[2 + e] * w;
    }
  }
  const float denom = fmaxf(l_all, 1e-30f);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = j * kWarp + lane;
    if (e < d) out[row * d + e] = o[j] / denom;
  }
}

template <int PER_LANE>
void launch(const float* q, const float* k, const float* v, const int* pt,
            int pt_stride, const int* lens, float* out, int S, int n_kv,
            int g, int d, int ps, int max_pages, int n_split,
            cudaStream_t stream) {
  const dim3 grid(n_kv, S);
  const dim3 block(g * n_split * kWarp);
  const size_t smem = sizeof(float) * n_split * g * (2 + d);
  paged_attn_kernel<PER_LANE><<<grid, block, smem, stream>>>(
      q, k, v, pt, pt_stride, lens, out, n_kv, g, d, ps, max_pages,
      n_split);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  n_split = token splits per
// query row (0 = as many as fit kMaxWarps warps per block).  Launches on
// `stream` and returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int repro_paged_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* seq_lens, float* out,
    int S, int n_kv, int g, int d, int ps, int max_pages, int n_split,
    void* stream) {
  if (n_split <= 0) n_split = g >= kMaxWarps ? 1 : kMaxWarps / g;
  if (S <= 0 || n_kv <= 0 || g <= 0 || g * n_split > kMaxWarps || d <= 0 ||
      d > 256 || ps <= 0 || max_pages <= 0 || pt_stride < max_pages) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 32) {
    launch<1>(q, k_pages, v_pages, page_table, pt_stride, seq_lens, out, S,
              n_kv, g, d, ps, max_pages, n_split, st);
  } else if (d <= 64) {
    launch<2>(q, k_pages, v_pages, page_table, pt_stride, seq_lens, out, S,
              n_kv, g, d, ps, max_pages, n_split, st);
  } else if (d <= 128) {
    launch<4>(q, k_pages, v_pages, page_table, pt_stride, seq_lens, out, S,
              n_kv, g, d, ps, max_pages, n_split, st);
  } else {
    launch<8>(q, k_pages, v_pages, page_table, pt_stride, seq_lens, out, S,
              n_kv, g, d, ps, max_pages, n_split, st);
  }
  return (int)cudaGetLastError();
}
