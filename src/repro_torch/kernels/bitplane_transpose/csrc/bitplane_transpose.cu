// The SIMDRAM transposition unit for Hopper (sm_90a): horizontal integers
// to vertical bit planes (pack) and back (unpack).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/bitplane_transpose/kernel.py::_pack_kernel
//   src/repro/kernels/bitplane_transpose/kernel.py::_unpack_kernel
// (driven by pack_tiles / unpack_tiles, wrapped by to_bitplanes /
// from_bitplanes).  tests/test_torch_bitplane.py models this file's
// shuffle and partition in numpy (_np_transpose32, _np_pack_kernel,
// _np_unpack_kernel): change the two together.
//
// Layout (core/bitplane.py): bit l of word w of plane b is bit b of lane
// (element) 32 w + l.  Planes are i32 [n_bits, n_words] carrying the
// uint32 pattern, row b at b * n_words; n_bits 1..32.  Pack takes i32 or
// i64 elements (an i64 cut to its low 32 bits, as x.astype(uint32));
// elements past n_elems read as 0, so the wrapper pads nothing.  Unpack
// writes i32 elements, sign-extended from plane n_bits - 1 when
// sign_extend (the wrapper passes it only for signed and n_bits < 32).
//
// What bounds both: bytes.  Pack reads 4 N bytes (8 N for i64) and writes
// n_bits N / 8; unpack the reverse.  The parent design missed that bound by
// 2.7-5.6x at 2^26 elements: pack took one warp per word and one ballot
// per plane (about 5 n_bits instructions a word, with 4-byte loads taken
// a word at a time: too few bytes in flight), unpack one broadcast 4-byte
// load per plane per element.
//
// What this design does about it:
//   * the element side moves 16 bytes a thread: lane t of a warp holds
//     elements 4t..4t+3 of 4 consecutive words (one int4 load or store;
//     two for i64), so lanes 8g..8g+7 hold word g, lane q of them its
//     elements 4q..4q+3;
//   * those 8 lanes transpose their word's 32 x 32 bit matrix in
//     registers (transpose32): row r = 4q + j is register j of lane q.
//     Five block-swap stages, each on independent index bits so in any
//     order: S = 16, 8, 4 pair lane q with q ^ S/4 (one __shfl_xor_sync of
//     a rotated register, then one bit-select: 3 instructions a register),
//     S = 2, 1 pair registers of one lane.  About 14 warp instructions a
//     word for any n_bits, 3 of them shuffles.  Row r then holds plane r's
//     word; the transpose is its own inverse, so unpack runs the same one
//     on plane words and gets elements;
//   * the plane side goes through shared memory, a tile [NB][TW + 1] (NB
//     rows: n_bits rounded up to 8, 16 or 32, the instance; TW words).  The
//     row pitch TW + 1 = 1 mod 32 makes both accesses conflict-free: the
//     transpose's (row 4q + j, word 4k + g) over a warp's (q, g), and the
//     plane side's (row 4p + b', words 4i..4i+3) over its (p, i).  A warp
//     moves 4 plane rows x 32 words per step, lane (p, i) one int4 of row
//     4p + b': each row's 32 words are one 128-byte line;
//   * tiles of TW = 32 K words, K the 4-word groups a warp takes.  A
//     thread issues all its loads before it uses any (pack: K int4 of
//     elements; unpack: NB TW / 1024 int4 of planes), so a block is one
//     round trip to memory, and several blocks a SM keep tens of KB in
//     flight.  Pack takes 64 words (K = 2) at every size: 512 blocks at
//     2^20 elements spread over the whole card, and on an H100 at 2^26 it
//     was within 2% of 128- and 256-word tiles (faster at 8 bits, 1% slower
//     at 32).  Unpack takes 128 words at NB = 8 and 64 above, so each
//     thread issues one plane load: its time is the chain of stores a block
//     issues after its one round trip (ops.py::PACK_TILE, unpack_tile);
//   * alignment: a 16-byte access is used only where it is aligned and
//     wholly inside its row; otherwise that chunk goes by 4-byte accesses
//     (each guarded).  So x[1:] (4 bytes off), i64 input 8 bytes off and
//     plane rows with n_words % 4 != 0 are taken as they are; ragged
//     tails read 0 and write nothing past n_elems / n_words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr unsigned kFull = 0xffffffffu;

// bits c of a word with (c & s) == 0
__host__ __device__ constexpr uint32_t low_mask(int s) {
  return s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu
       : s == 4 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u : 0x55555555u;
}

// Swap the off-diagonal S x S blocks between rows r and r + S held by
// lanes q and q ^ S/4 (r = 4q + j): the lower lane takes the upper row's
// bits c - S into its bits c with c & S set, the upper lane the lower row's
// bits c + S into its bits with c & S clear.  Each lane sends its row
// rotated so that the partner's bits already sit in place.
template <int S>
__device__ __forceinline__ void cross_stage(uint32_t v[4], int q) {
  constexpr uint32_t m = low_mask(S);
  const bool upper = q & (S / 4);
  const uint32_t keep = upper ? ~m : m;
  const int rot = upper ? S : 32 - S;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t got =
        __shfl_xor_sync(kFull, __funnelshift_l(v[j], v[j], rot), S / 4);
    v[j] = (v[j] & keep) | (got & ~keep);
  }
}

// The same swap between registers j and j + S of one lane (S = 2, 1).
template <int S>
__device__ __forceinline__ void lane_stage(uint32_t v[4]) {
  constexpr uint32_t m = low_mask(S);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j & S) continue;
    const uint32_t t = ((v[j] >> S) ^ v[j + S]) & m;
    v[j + S] ^= t;
    v[j] ^= t << S;
  }
}

// Transpose the 32 x 32 bit matrix whose row 4q + j is register j of lane
// q (q = lane & 7; lanes 8g..8g+7 hold one matrix): afterwards bit c of
// row r is bit r of the old row c.
__device__ __forceinline__ void transpose32(uint32_t v[4], int q) {
  cross_stage<16>(v, q);
  cross_stage<8>(v, q);
  cross_stage<4>(v, q);
  lane_stage<2>(v);
  lane_stage<1>(v);
}

// Four consecutive 32-bit values from i (< n), 0 past n: one 16-byte load
// where it is aligned and whole, else guarded 4-byte loads.
__device__ __forceinline__ void load4(const int32_t* __restrict__ row,
                                      long long i, long long n,
                                      uint32_t v[4]) {
  const int32_t* p = row + i;
  if (i + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = i + m < n ? (uint32_t)__ldg(p + m) : 0u;
  }
}

// The low words of four consecutive i64 from i: two 16-byte loads where
// aligned and whole, else guarded 4-byte loads of the low words.
__device__ __forceinline__ void load4(const int64_t* __restrict__ row,
                                      long long i, long long n,
                                      uint32_t v[4]) {
  const int64_t* p = row + i;
  if (i + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p + 2));
    v[0] = a.x; v[1] = a.z; v[2] = b.x; v[3] = b.z;
  } else {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(p);  // little end
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = i + m < n ? __ldg(lo + 2 * m) : 0u;
  }
}

// Store four values at i.. of a row of n: one 16-byte store where aligned
// and whole, else guarded 4-byte stores.
__device__ __forceinline__ void store4(int32_t* __restrict__ row, long long i,
                                       long long n, const uint32_t v[4]) {
  int32_t* p = row + i;
  if (i + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) if (i + m < n) p[m] = (int32_t)v[m];
  }
}

// Block: TW = 32 K words.  Warp w takes words w 4K + 4k + g (k < K) of the
// tile; the plane side steps over (4 rows, 32 words) items, warp w taking
// items w, w + 8, ...: item c covers rows 4 (c / (TW / 32)) + p and words
// 32 (c % (TW / 32)) + 4i.. for lane (p, i) = (lane >> 3, lane & 7).
template <typename T, int NB, int K>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, long long n_elems, int n_words,
            int n_bits, int32_t* __restrict__ planes) {
  constexpr int TW = kWarps * 4 * K, kRuns = TW / 32;
  __shared__ uint32_t tile[NB][TW + 1];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int hi = lane >> 3, lo = lane & 7;
  const long long w0 = (long long)blockIdx.x * TW;
  uint32_t v[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {           // all loads first: one round trip
    const int lw = warp * 4 * K + 4 * k + hi;
    load4(x, (w0 + lw) * kWarp + 4 * lo, n_elems, v[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    transpose32(v[k], lo);
    const int lw = warp * 4 * K + 4 * k + hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * lo + j < NB) tile[4 * lo + j][lw] = v[k][j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = warp; c < NB / 4 * kRuns; c += kWarps) {
    const int b = 4 * (c / kRuns) + hi, w = 32 * (c % kRuns) + 4 * lo;
    if (b < n_bits) {
      const uint32_t o[4] = {tile[b][w], tile[b][w + 1], tile[b][w + 2],
                             tile[b][w + 3]};
      store4(planes + (long long)b * n_words, w0 + w, n_words, o);
    }
  }
}

template <int NB, int K>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int32_t* __restrict__ planes, int n_bits, int n_words,
              long long n_elems, int sign_extend, int32_t* __restrict__ out) {
  constexpr int TW = kWarps * 4 * K, kRuns = TW / 32;
  constexpr int kItems = NB / 4 * kRuns;
  constexpr int kPer = (kItems + kWarps - 1) / kWarps;
  __shared__ uint32_t tile[NB][TW + 1];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int hi = lane >> 3, lo = lane & 7;
  const long long w0 = (long long)blockIdx.x * TW;
  uint32_t r[kPer][4];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {        // all loads first: one round trip
    const int c = warp + n * kWarps;
    const int b = 4 * (c / kRuns) + hi, w = 32 * (c % kRuns) + 4 * lo;
    if (c < kItems && b < n_bits) {
      load4(planes + (long long)b * n_words, w0 + w, n_words, r[n]);
    } else {
      r[n][0] = r[n][1] = r[n][2] = r[n][3] = 0u;   // rows past n_bits: 0
    }
  }
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int c = warp + n * kWarps;
    const int b = 4 * (c / kRuns) + hi, w = 32 * (c % kRuns) + 4 * lo;
    if (c < kItems) {
#pragma unroll
      for (int m = 0; m < 4; ++m) tile[b][w + m] = r[n][m];
    }
  }
  __syncthreads();
  const int sh = 32 - n_bits;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lw = warp * 4 * K + 4 * k + hi;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = 4 * lo + j < NB ? tile[4 * lo + j][lw] : 0u;
    }
    transpose32(v, lo);
    if (sign_extend) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (uint32_t)((int32_t)(v[j] << sh) >> sh);
      }
    }
    store4(out, (w0 + lw) * kWarp + 4 * lo, n_elems, v);
  }
}

// NB: n_bits rounded up to 8, 16 or 32.  Tiles: pack 32 kPackK words,
// unpack 32 unpack_k(NB) (ops.py::PACK_TILE, ops.py::unpack_tile).
int rows_for(int n_bits) { return n_bits <= 8 ? 8 : n_bits <= 16 ? 16 : 32; }

constexpr int kPackK = 2;
constexpr int unpack_k(int nb) { return nb == 8 ? 4 : 2; }

template <typename T>
void launch_pack(cudaStream_t st, const T* x, long long n_elems, int n_words,
                 int n_bits, int32_t* planes) {
  constexpr int tw = 32 * kPackK;
  const int blocks = (int)(((long long)n_words + tw - 1) / tw);
  switch (rows_for(n_bits)) {
    case 8: pack_kernel<T, 8, kPackK><<<blocks, kThreads, 0, st>>>(
        x, n_elems, n_words, n_bits, planes); break;
    case 16: pack_kernel<T, 16, kPackK><<<blocks, kThreads, 0, st>>>(
        x, n_elems, n_words, n_bits, planes); break;
    default: pack_kernel<T, 32, kPackK><<<blocks, kThreads, 0, st>>>(
        x, n_elems, n_words, n_bits, planes);
  }
}

template <int NB>
void launch_unpack(cudaStream_t st, const int32_t* planes, int n_bits,
                   int n_words, long long n_elems, int sign_extend,
                   int32_t* out) {
  constexpr int tw = 32 * unpack_k(NB);
  const long long words = (n_elems + kWarp - 1) / kWarp;
  const int blocks = (int)((words + tw - 1) / tw);
  unpack_kernel<NB, unpack_k(NB)><<<blocks, kThreads, 0, st>>>(
      planes, n_bits, n_words, n_elems, sign_extend, out);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernels do not take) so the caller can raise on a refused launch.

// x: n_elems elements of elem_bytes (4: i32, 8: i64) -> planes
// [n_bits, n_words], n_words >= ceil(n_elems / 32) (words past the
// elements are written 0).
extern "C" int repro_bitplane_pack(const void* x, int elem_bytes,
                                   long long n_elems, int n_bits,
                                   int n_words, int32_t* planes,
                                   void* stream) {
  if (n_elems < 1 || n_bits < 1 || n_bits > 32 ||
      (long long)n_words * kWarp < n_elems ||
      (elem_bytes != 4 && elem_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    launch_pack(st, static_cast<const int32_t*>(x), n_elems, n_words, n_bits,
                planes);
  } else {
    launch_pack(st, static_cast<const int64_t*>(x), n_elems, n_words, n_bits,
                planes);
  }
  return (int)cudaGetLastError();
}

// planes [n_bits, n_words] -> out [n_elems] i32, sign-extended from bit
// n_bits - 1 when sign_extend (the wrapper passes it only for n_bits < 32).
extern "C" int repro_bitplane_unpack(const int32_t* planes, int n_bits,
                                     int n_words, long long n_elems,
                                     int sign_extend, int32_t* out,
                                     void* stream) {
  if (n_elems < 1 || n_bits < 1 || n_bits > 32 ||
      (long long)n_words * kWarp < n_elems ||
      (sign_extend && n_bits >= 32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows_for(n_bits)) {
    case 8: launch_unpack<8>(st, planes, n_bits, n_words, n_elems,
                             sign_extend, out); break;
    case 16: launch_unpack<16>(st, planes, n_bits, n_words, n_elems,
                               sign_extend, out); break;
    default: launch_unpack<32>(st, planes, n_bits, n_words, n_elems,
                               sign_extend, out);
  }
  return (int)cudaGetLastError();
}
