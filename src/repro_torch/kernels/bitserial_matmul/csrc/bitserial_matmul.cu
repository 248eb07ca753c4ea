// Bit-serial (bit-plane) int8 matmul for Hopper (sm_90a), on planes packed
// 1 bit per weight per plane.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitserial_matmul/kernel.py::_bsmm_kernel (launched by
// bsmm_raw):
//
//     out[M, N] int32 = sum_b 2^b * (x[M, K] @ W_b[K, N])
//
// with x int8 and W_b the bits of an n_bits-bit unsigned weight (SIMDRAM's
// vertical layout, one plane per bit).
//
// Layout.  The planes arrive packed: int32 words [n_bits, N, KW], KW =
// ceil(K / 32); bit j of word [b, n, w] is W_b at k = 32 w + j, and bits past
// K are zero.  K runs along the word, so 128 k of one column are one 16-byte
// load per plane.
//
// What bounds it: dp4a and the expansion of the planes, not bytes.  Packed,
// the planes are 1/8 of the bytes of one int8 per bit (22.5 MB for a 2048 x
// 11008 matrix at 8 planes); at the main path's M = 128 rows the byte bound
// is a fifth of the time the M K N / 4 dp4a take.  The design follows:
//
// * sum_b 2^b (x @ W_b) = x @ u with u = sum_b W_b << b, an unsigned byte
//   for n_bits <= 8, and one dp4a (signed x bytes times unsigned u bytes)
//   takes four k of x @ u: one product instead of n_bits.
// * The planes are expanded to u on chip, once per block for all BM = 128
//   rows.  For 32 k of one column, a 4 x 4 byte transpose (prmt) per four
//   planes and an 8 x 8 bit transpose (three delta swaps) turn the n_bits
//   plane words into the 8 u words dp4a multiplies, byte t of word i being
//   k = 4 i + t: about 16 integer operations per u word, against 32 for
//   spreading each plane's nibbles by a multiply.
// * Warp specialisation, so the expansion overlaps the products: 2 producer
//   warps (one column each) load the next chunk's plane words and expand
//   them into one of two u tiles in shared memory; 8 consumer warps copy
//   the next chunk's x tile with cp.async and run the dp4a, 8 x 4 outputs
//   per thread from three 16-byte shared loads per 32 dp4a.  Named barriers
//   hand each buffer over: FULL when its chunk is in, EMPTY when read.
// * Split-K where the output grid is small: the wrapper cuts K into S
//   slices of whole chunks (blockIdx.z) when the M x N tiles alone leave
//   the SMs short of blocks, and each slice adds its sums into an output the
//   wrapper zeroed with int32 atomics.  Integer addition modulo 2^32 gives
//   the same bits in any order, so the result stays exact and
//   deterministic.  With S = 1 the block stores its sums.
// * Ragged M, K and N are masked here: out-of-range x and plane words read
//   as 0 and out-of-range outputs are not written, so no padded copy is
//   made.  Warps whose rows all lie past M skip the products (decode
//   batches).  x rows are copied 16 bytes at a time when K and the base are
//   multiples of 16, else a word or a byte at a time.
//
// Every sum is taken modulo 2^32, as the reference's int32 arithmetic is,
// so the result equals bsmm_raw's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BKW = 4;           // packed plane words (32 k each) per chunk
constexpr int BK = 32 * BKW;     // K per chunk: 128
constexpr int BK4 = BK / 4;      // u words (4 k each) per column per chunk
constexpr int TM = 8;            // output rows per consumer thread
constexpr int TN = 4;            // output columns per consumer thread
constexpr int CONSUMERS = (BM / TM) * (BN / TN);         // 256
constexpr int PRODUCERS = BN;                            // one per column
constexpr int ALL = CONSUMERS + PRODUCERS;               // 320
constexpr int X_PIECES = BM * BK / 16 / CONSUMERS;       // 16-B x copies: 4
constexpr int FULL = 1, EMPTY = 3;  // named barriers FULL + buf, EMPTY + buf
static_assert(X_PIECES * CONSUMERS * 16 == BM * BK, "whole x copies");
static_assert(PRODUCERS % 32 == 0 && CONSUMERS % 32 == 0, "whole warps");

// Four bytes row[c..c+3] as one little-endian word, zero past ncols.  One
// 32-bit load when the row is 4-byte aligned (vec) and all four are in range.
__device__ __forceinline__ uint32_t load4(const int8_t* row, int c, int ncols,
                                          bool vec) {
  if (vec && c + 3 < ncols)
    return __ldg(reinterpret_cast<const unsigned int*>(row + c));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < ncols) w |= uint32_t(uint8_t(__ldg(row + c + i))) << (8 * i);
  return w;
}

// d = c + sum_j a.byte_j (signed) * b.byte_j (unsigned)
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(ALL) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(ALL) : "memory");
}

// 16 bytes global -> shared, of which the first `bytes` (0 or 16) are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// a[y] = byte y of p0, p1, p2, p3 (4 x 4 byte transpose)
__device__ __forceinline__ void byte_transpose4(uint32_t p0, uint32_t p1,
                                                uint32_t p2, uint32_t p3,
                                                uint32_t (&a)[4]) {
  const uint32_t t0 = __byte_perm(p0, p1, 0x5140);
  const uint32_t t1 = __byte_perm(p2, p3, 0x5140);
  const uint32_t t2 = __byte_perm(p0, p1, 0x7362);
  const uint32_t t3 = __byte_perm(p2, p3, 0x7362);
  a[0] = __byte_perm(t0, t1, 0x5410);
  a[1] = __byte_perm(t0, t1, 0x7632);
  a[2] = __byte_perm(t2, t3, 0x5410);
  a[3] = __byte_perm(t2, t3, 0x7632);
}

// the first two delta swaps of an 8 x 8 bit transpose, on one half of the
// 64-bit matrix (they move no bit across halves)
__device__ __forceinline__ uint32_t swap_half(uint32_t v) {
  uint32_t t = (v ^ (v >> 7)) & 0x00AA00AAu;
  v ^= t ^ (t << 7);
  t = (v ^ (v >> 14)) & 0x0000CCCCu;
  return v ^ t ^ (t << 14);
}

// The n_bits plane words of 32 k of one column -> the 8 u words of those k
// (byte t of u[i] = u at k = 4 i + t).  Byte y of the eight plane words is
// an 8 x 8 bit matrix, row b = plane b, column j = k 8 y + j: rows 0-3 in
// a[y], rows 4-7 in c[y].  Its transpose, rows = k with bit b from plane b,
// is u[2 y] (k 8 y .. 8 y + 3) and u[2 y + 1].  The third delta swap is the
// one across halves.
template <int NBITS>
__device__ __forceinline__ void expand32(const uint32_t* p, uint32_t (&u)[8]) {
  uint32_t q[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) q[b] = b < NBITS ? p[b] : 0u;
  uint32_t a[4], c[4];
  byte_transpose4(q[0], q[1], q[2], q[3], a);
  byte_transpose4(q[4], q[5], q[6], q[7], c);
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint32_t lo = swap_half(a[y]), hi = swap_half(c[y]);
    const uint32_t t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
    u[2 * y] = lo ^ t;
    u[2 * y + 1] = hi ^ (t >> 4);
  }
}

template <int NBITS>
__global__ void __launch_bounds__(ALL, 2)
bsmm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ w,
            int32_t* __restrict__ out, int M, int K, int N, int slice_words,
            int x_mode, int w_vec) {
  // xs[buf][m][16 (g ^ (m & 7)) + j]: x[m][16 g + j] of the chunk (16-byte
  // pieces swizzled by row, so the two rows a warp reads sit in other
  // banks); us[buf][k4][n]: bytes t = u[4 k4 + t][n].  Named barriers
  // FULL + buf: the buffer holds its chunk; EMPTY + buf: it was read.
  __shared__ __align__(16) int8_t xs[2][BM][BK];
  __shared__ __align__(16) uint32_t us[2][BK4][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KW = (K + 31) / 32;
  const int w_begin = blockIdx.z * slice_words;
  const int w_end = min(KW, w_begin + slice_words);
  const int n_chunks = w_end > w_begin ? (w_end - w_begin + BKW - 1) / BKW : 0;

  if (tid >= CONSUMERS) {       // producers: one column of u per thread
    const int pn = tid - CONSUMERS, n = n0 + pn;
    const uint32_t* wcol = w + size_t(n) * KW;
    const size_t plane = size_t(N) * KW;
    uint32_t pw[NBITS][4];
    auto load = [&](int w0) {
#pragma unroll
      for (int b = 0; b < NBITS; ++b) {
        if (n >= N) {
#pragma unroll
          for (int q = 0; q < 4; ++q) pw[b][q] = 0u;
        } else if (w_vec && w0 + 3 < KW) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              wcol + b * plane + w0));
          pw[b][0] = v.x; pw[b][1] = v.y; pw[b][2] = v.z; pw[b][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pw[b][q] = w0 + q < KW ? __ldg(wcol + b * plane + w0 + q) : 0u;
        }
      }
    };
    if (n_chunks > 0) load(w_begin);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1, w0 = w_begin + BKW * c;
      if (c >= 2) bar_sync(EMPTY + buf);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t p[NBITS], u[8];
#pragma unroll
        for (int b = 0; b < NBITS; ++b) p[b] = pw[b][q];
        expand32<NBITS>(p, u);
#pragma unroll
        for (int i = 0; i < 8; ++i) us[buf][8 * q + i][pn] = u[i];
      }
      if (c + 1 < n_chunks) load(w0 + BKW);
      bar_arrive(FULL + buf);
    }
    return;
  }

  // consumers: rows ty + 16 i and columns 4 tx .. 4 tx + 3 of the tile
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const bool active = m0 + ty < M;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  // consumers: the x tile of chunk c into its buffer, 16 bytes per copy
  auto copy_x = [&](int c) {
    const int buf = c & 1, w0 = w_begin + BKW * c;
#pragma unroll
    for (int r = 0; r < X_PIECES; ++r) {
      const int piece = tid + r * CONSUMERS;
      const int mm = piece / (BK / 16), g = piece % (BK / 16);
      const int m = m0 + mm, k = 32 * w0 + 16 * g;
      int8_t* dst = &xs[buf][mm][16 * (g ^ (mm & 7))];
      if (x_mode == 2) {
        const bool in = m < M && k < K;
        cp_async16(dst, in ? x + size_t(m) * K + k : x, in ? 16 : 0);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = m < M ? load4(x + size_t(m) * K, k + 4 * q, K, x_mode == 1)
                       : 0u;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (n_chunks > 0) copy_x(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    asm volatile("cp.async.wait_all;" ::: "memory");
    bar_sync(FULL + buf);
    if (c + 1 < n_chunks) copy_x(c + 1);
    if (active) {
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16) {
        uint4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int mm = ty + (BM / TM) * i;
          a[i] = *reinterpret_cast<const uint4*>(
              &xs[buf][mm][16 * (k16 ^ (mm & 7))]);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint4 bq =
              *reinterpret_cast<const uint4*>(&us[buf][4 * k16 + h][TN * tx]);
          const uint32_t bv[TN] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const uint32_t av = h == 0 ? a[i].x : h == 1 ? a[i].y
                              : h == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = dp4a_su(av, bv[j], acc[i][j]);
          }
        }
      }
    }
    if (c + 2 < n_chunks) bar_arrive(EMPTY + buf);
  }

  const bool split = gridDim.z > 1;
  if (split && n_chunks == 0) return;          // an empty slice adds nothing
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + (BM / TM) * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + TN * tx + j;
      if (n >= N) continue;
      if (split)
        atomicAdd(out + size_t(m) * N + n, acc[i][j]);
      else
        out[size_t(m) * N + n] = acc[i][j];
    }
  }
}

template <int NBITS>
cudaError_t launch(const int8_t* x, const uint32_t* w, int32_t* out, int M,
                   int K, int N, int splits, int slice_words, int x_mode,
                   int w_vec, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  bsmm_kernel<NBITS><<<grid, ALL, 0, stream>>>(x, w, out, M, K, N,
                                                   slice_words, x_mode, w_vec);
  return cudaGetLastError();
}

// Measures the card's dp4a rate: 8 independent dp4a chains per thread.
__global__ void __launch_bounds__(256)
dp4a_probe_kernel(int32_t* __restrict__ out, int iters) {
  const uint32_t a = 0x01010101u * (threadIdx.x & 0x7F);
  const uint32_t b = 0x80808080u | blockIdx.x;
  int acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = dp4a_su(a + j, b, acc[j]);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j];
  out[size_t(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out [M, N] int32 = sum_b 2^b x [M, K] @ W_b, x int8 row-major, planes
// packed int32 [n_bits, N, ceil(K / 32)] (see the top of the file), both
// contiguous; 1 <= n_bits <= 8, M, N >= 1, K >= 0.  K is cut into `splits`
// slices of `slice_words` packed words (a multiple of 4); with splits > 1
// the output must be zero on entry.  x_mode: 2 x rows and base 16-byte
// aligned, 1 4-byte aligned, 0 neither.  w_vec: ceil(K / 32) a multiple of
// 4 and the planes' base 16-byte aligned.  Returns the CUDA error of the
// launch (0: none).
extern "C" int repro_bsmm_packed(const void* x, const void* planes, void* out,
                                 int M, int K, int N, int n_bits, int splits,
                                 int slice_words, int x_mode, int w_vec,
                                 void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint32_t*>(planes);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 65535 || (splits > 1 && slice_words % BKW))
    return cudaErrorInvalidValue;
  switch (n_bits) {
#define REPRO_BSMM_CASE(NB)                                                    \
    case NB: return launch<NB>(xp, wp, op, M, K, N, splits, slice_words,      \
                               x_mode, w_vec, s);
    REPRO_BSMM_CASE(1) REPRO_BSMM_CASE(2) REPRO_BSMM_CASE(3)
    REPRO_BSMM_CASE(4) REPRO_BSMM_CASE(5) REPRO_BSMM_CASE(6)
    REPRO_BSMM_CASE(7) REPRO_BSMM_CASE(8)
#undef REPRO_BSMM_CASE
    default: return cudaErrorInvalidValue;
  }
}

// Writes one int32 per thread of `blocks` blocks of 256 threads, each after
// iters x 8 dp4a; time it to read the card's dp4a rate.
extern "C" int repro_dp4a_probe(void* out, int blocks, int iters,
                                void* stream) {
  dp4a_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), iters);
  return cudaGetLastError();
}
