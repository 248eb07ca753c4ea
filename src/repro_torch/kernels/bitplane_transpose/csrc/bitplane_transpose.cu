// The SIMDRAM transposition unit for Hopper (sm_90a): horizontal integers
// to vertical bit planes (pack) and back (unpack).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/bitplane_transpose/kernel.py::_pack_kernel
//   src/repro/kernels/bitplane_transpose/kernel.py::_unpack_kernel
// (driven by pack_tiles / unpack_tiles, wrapped by to_bitplanes /
// from_bitplanes).
//
// Layout (core/bitplane.py): bit l of word w of plane b is bit b of lane
// (element) 32 w + l.  Planes are i32 [n_bits, n_words] carrying the
// uint32 pattern; n_bits <= 32.
//
// What bounds both: bytes.  Pack reads 4 N bytes and writes
// 4 n_bits N / 32; unpack the reverse.  The work per byte is a few shifts.
//
// Pack: one warp per 32-element word.  Lane l loads element 32 w + l (an
// i32, or an i64 cut to its low 32 bits, as x.astype(uint32)); lanes past
// n_elems load zero, so the wrapper needs no padding copy.  For each bit b,
// __ballot_sync(full, (x >> b) & 1) is already plane b's word: no
// reduction, where the Pallas kernel multiplied and summed.  Lane b keeps
// plane b's word; a block transposes its 32 words x n_bits planes through
// shared memory so that each plane's 32 words go out as one 128-byte
// store, and reads are 128 contiguous bytes per warp.
//
// Unpack: one thread per output element, a loop over the planes; the 32
// threads of a warp read the same word (one broadcast load per plane) and
// write 32 consecutive elements.  It applies the sign extension of
// from_bitplanes (signed and n_bits < 32), so it writes the final i32
// values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWordsPerBlock = 32;
constexpr int kPackWarps = 8;
constexpr int kUnpackThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kPackWarps * kWarp)
pack_kernel(const T* __restrict__ x, long long n_elems, int n_words,
            int n_bits, int32_t* __restrict__ planes) {
  __shared__ uint32_t tile[kWarp][kWordsPerBlock + 1];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long w0 = (long long)blockIdx.x * kWordsPerBlock;
  for (int j = warp; j < kWordsPerBlock; j += kPackWarps) {
    const long long e = (w0 + j) * kWarp + lane;
    const uint32_t v = e < n_elems ? (uint32_t)x[e] : 0u;
    uint32_t mine = 0;
    for (int b = 0; b < n_bits; ++b) {
      const uint32_t word = __ballot_sync(0xffffffffu, (v >> b) & 1u);
      if (lane == b) mine = word;
    }
    tile[lane][j] = mine;
  }
  __syncthreads();
  const long long w = w0 + lane;
  if (w < n_words) {
    for (int b = warp; b < n_bits; b += kPackWarps) {
      planes[(long long)b * n_words + w] = (int32_t)tile[b][lane];
    }
  }
}

__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const int32_t* __restrict__ planes, int n_bits, int n_words,
              long long n_elems, int sign_extend,
              int32_t* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kUnpackThreads + threadIdx.x;
  if (e >= n_elems) return;
  const long long w = e / kWarp;
  const int l = (int)(e % kWarp);
  uint32_t v = 0;
  for (int b = 0; b < n_bits; ++b) {
    const uint32_t word = (uint32_t)__ldg(planes + (long long)b * n_words + w);
    v |= ((word >> l) & 1u) << b;
  }
  if (sign_extend && ((v >> (n_bits - 1)) & 1u)) v |= ~0u << n_bits;
  out[e] = (int32_t)v;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() so the caller can raise on a refused launch.

// x: n_elems elements of elem_bytes (4: i32, 8: i64) -> planes
// [n_bits, n_words], n_words = ceil(n_elems / 32).
extern "C" int repro_bitplane_pack(const void* x, int elem_bytes,
                                   long long n_elems, int n_bits,
                                   int n_words, int32_t* planes,
                                   void* stream) {
  if (n_elems < 1 || n_bits < 1 || n_bits > 32 ||
      (long long)n_words * kWarp < n_elems ||
      (elem_bytes != 4 && elem_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    pack_kernel<int32_t><<<blocks, kPackWarps * kWarp, 0, st>>>(
        static_cast<const int32_t*>(x), n_elems, n_words, n_bits, planes);
  } else {
    pack_kernel<int64_t><<<blocks, kPackWarps * kWarp, 0, st>>>(
        static_cast<const int64_t*>(x), n_elems, n_words, n_bits, planes);
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
  const long long blocks = (n_elems + kUnpackThreads - 1) / kUnpackThreads;
  unpack_kernel<<<(unsigned)blocks, kUnpackThreads, 0,
                  (cudaStream_t)stream>>>(planes, n_bits, n_words, n_elems,
                                          sign_extend, out);
  return (int)cudaGetLastError();
}
