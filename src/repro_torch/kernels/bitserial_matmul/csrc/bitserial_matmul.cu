// Bit-serial (bit-plane) int8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitserial_matmul/kernel.py::_bsmm_kernel (launched by
// bsmm_raw):
//
//     out[M, N] int32 = sum_b 2^b * (x[M, K] @ planes[b, K, N])
//
// with x int8 and planes int8 holding 0 or 1 (SIMDRAM's vertical layout of
// an n_bits-bit unsigned weight, one plane per bit).
//
// What bounds it: bytes.  The planes are stored one int8 per bit, so an
// n_bits weight costs n_bits bytes; at the main path's shapes (M = 128
// activation rows, K x N = 2048 x 11008 and 11008 x 2048, 8 planes) they
// are 97% of the bytes moved, and a multiply-add per weight per row is far
// below the card's integer rate.  The design follows from that:
//
// * sum_b 2^b (x @ W_b) = x @ u with u = sum_b W_b << b, an unsigned byte
//   for n_bits <= 8.  A block builds u once per tile from the n_bits plane
//   tiles (shift-or of four weights per 32-bit word) and runs one int32
//   product with dp4a (signed x bytes times unsigned u bytes), instead of
//   n_bits plane products as the TPU kernel runs on its matrix unit.
// * One block owns a BM x BN output tile and walks all of K itself, so no
//   sum crosses blocks (the Pallas grid carries it across its innermost
//   grid axis in the output block).  Blocks that share a plane tile (same
//   N tile, another M tile) are adjacent in the grid, so they run together
//   and the second reads the tile from L2, not from device memory.
// * The next K chunk's plane and x words are loaded into registers while
//   the current chunk is multiplied, so loads stay in flight even when a
//   small grid puts one block on an SM.
// * Ragged M, K and N are masked here: out-of-range x and weights read as
//   0 and out-of-range outputs are not written, so no padded copy is made.
//   Rows whose length or base is not a multiple of 4 bytes are read byte by
//   byte.
//
// Every sum is taken modulo 2^32, as the reference's int32 arithmetic is,
// so the result equals bsmm_raw's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 32;           // output columns per block
constexpr int BK = 64;           // K per chunk
constexpr int BK4 = BK / 4;      // 32-bit words of K per chunk
constexpr int TM = 4;            // output rows per thread
constexpr int TN = 4;            // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);           // 128
constexpr int XPAD = 4;          // keeps x-tile rows 16-byte aligned
constexpr int X_WORDS = BM * BK4 / THREADS;              // 8 per thread
static_assert(BK4 * (BN / 4) == THREADS, "one (k4, n4) plane word per thread");

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

template <int NBITS>
__global__ void __launch_bounds__(THREADS)
bsmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            int32_t* __restrict__ out, int M, int K, int N, int vec_x,
            int vec_w) {
  // xs[k4][m]: bytes j = x[m][4 k4 + j]; us[k4][n]: bytes j = u[4 k4 + j][n]
  __shared__ __align__(16) uint32_t xs[BK4][BM + XPAD];
  __shared__ __align__(16) uint32_t us[BK4][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lk4 = tid / (BN / 4), ln4 = tid % (BN / 4);    // plane loader
  const int xk4 = tid % BK4, xm = tid / BK4;               // x loader
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);    // compute
  const size_t plane = size_t(K) * N;

  uint32_t pw[NBITS][4];   // plane words of rows 4 lk4 .. 4 lk4 + 3
  uint32_t xw[X_WORDS];
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * lk4 + j;
#pragma unroll
      for (int b = 0; b < NBITS; ++b)
        pw[b][j] = k < K ? load4(w + b * plane + size_t(k) * N, n0 + 4 * ln4,
                                 N, vec_w)
                         : 0u;
    }
#pragma unroll
    for (int i = 0; i < X_WORDS; ++i) {
      const int m = m0 + xm + i * (THREADS / BK4);
      xw[i] = m < M ? load4(x + size_t(m) * K, k0 + 4 * xk4, K, vec_x) : 0u;
    }
  };

  auto store = [&]() {
    // u row words: byte i of r[j] = u[4 lk4 + j][4 ln4 + i] (planes hold
    // 0 or 1, so shifting a whole word moves each byte's bit alone)
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = 0;
#pragma unroll
      for (int b = 0; b < NBITS; ++b) r[j] |= pw[b][j] << b;
    }
    // 4 x 4 byte transpose: column word i holds u[4 lk4 + 0..3][4 ln4 + i]
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<uint4*>(&us[lk4][4 * ln4]) = make_uint4(
        __byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
        __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
#pragma unroll
    for (int i = 0; i < X_WORDS; ++i) xs[xk4][xm + i * (THREADS / BK4)] = xw[i];
  };

  const int n_chunks = (K + BK - 1) / BK;
  if (n_chunks > 0) load(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();                 // the previous chunk's tiles are read
    store();
    __syncthreads();
    if (c + 1 < n_chunks) load((c + 1) * BK);
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      const uint4 a = *reinterpret_cast<const uint4*>(&xs[k4][TM * ty]);
      const uint4 b = *reinterpret_cast<const uint4*>(&us[k4][TN * tx]);
      const uint32_t av[TM] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = dp4a_su(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + TM * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + TN * tx + j;
      if (n < N) out[size_t(m) * N + n] = acc[i][j];
    }
  }
}

template <int NBITS>
cudaError_t launch(const int8_t* x, const int8_t* w, int32_t* out, int M,
                   int K, int N, int vec_x, int vec_w, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  bsmm_kernel<NBITS><<<grid, THREADS, 0, stream>>>(x, w, out, M, K, N, vec_x,
                                                   vec_w);
  return cudaGetLastError();
}

}  // namespace

// out [M, N] int32 = sum_b 2^b x [M, K] @ planes [n_bits, K, N], all
// row-major and contiguous; 1 <= n_bits <= 8, M, N >= 1, K >= 0.  vec_x /
// vec_w: x / planes rows start on 4-byte boundaries (K / N and the base
// pointer multiples of 4).  Returns the CUDA error of the launch (0: none).
extern "C" int repro_bsmm_raw(const void* x, const void* planes, void* out,
                              int M, int K, int N, int n_bits, int vec_x,
                              int vec_w, void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(planes);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_bits) {
    case 1: return launch<1>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 2: return launch<2>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 3: return launch<3>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 4: return launch<4>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 5: return launch<5>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 6: return launch<6>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 7: return launch<7>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    case 8: return launch<8>(xp, wp, op, M, K, N, vec_x, vec_w, s);
    default: return cudaErrorInvalidValue;
  }
}
