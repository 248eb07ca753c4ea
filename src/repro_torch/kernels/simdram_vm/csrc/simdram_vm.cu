// The SIMDRAM control unit as a μProgram virtual machine for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/simdram_vm/kernel.py::make_vm_kernel
// (driven by run_uprogram), which unrolls one μProgram into each traced
// kernel.  Here the kernel is compiled once and the μProgram is data: an
// instruction stream lowered on the host by ../lower.py.
//
// Contract (lower.py::lower, ops.py::run_uprogram):
//   prog      [n_instr] int4    eight 16-bit fields s0 s1 s2 d0 d1 d2 d3 -,
//                               each slot << 1 | complement
//   init      [n_slots] i32     -1: zero; else input << 16 | bit
//   out_slots [out_bits] i32    slot of each output plane
//   inputs    up to kMaxInputs pointers to i32 [n_bits_i, n_words] planes
//   out       [out_bits, n_words] i32
// Per instruction: v = MAJ(s0, s1, s2), then d0..d3 <- v in order (a
// complemented field reads or writes the complement).  All three sources
// are read before any write, as a triple-row activation does.  This is the
// destructive-TRA semantics of core/engine.py::execute, bit for bit.
//
// What bounds it: operations for long programs, bytes for short ones.  It
// must read the input planes once and write the output planes once; per
// 32-lane word it does one three-input logic op (a LOP3) per μOp.  mul and
// div at 32 bits (8,016 and 29,888 μOps) are bound by operations, add at
// 32 bits (385 μOps) by bytes.
//
// What the design does about that bound:
//   * one thread per 32-lane word: a μOp is one LOP3 on registers loaded
//     from the row file, and the lanes of a word never interact, so threads
//     never synchronise;
//   * the row file lives in dynamic shared memory laid out [slot][thread],
//     so a warp's 32 accesses to one slot hit 32 banks; the wrapper picks
//     threads per block so that n_slots x threads x 4 B fits in 227 KB;
//   * every thread reads the same instruction, so the stream is a uniform
//     16-byte load served from L1 (at 30k instructions it cannot live in
//     constant memory);
//   * the inputs are read into the row file once and never written back:
//     a program may overwrite its input rows.
// Keeping small programs' rows in registers and sharing a row file across
// a cluster are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxInputs = 8;

struct VmInputs {
  const int32_t* p[kMaxInputs];
};

__device__ __forceinline__ uint32_t rd(const uint32_t* rf, uint32_t f,
                                       int T, int t) {
  return rf[(f >> 1) * T + t] ^ (0u - (f & 1u));
}

__device__ __forceinline__ void wr(uint32_t* rf, uint32_t f, int T, int t,
                                   uint32_t v) {
  rf[(f >> 1) * T + t] = v ^ (0u - (f & 1u));
}

__global__ void simdram_vm_kernel(const int4* __restrict__ prog, int n_instr,
                                  const int32_t* __restrict__ init,
                                  int n_slots,
                                  const int32_t* __restrict__ out_slots,
                                  int out_bits, VmInputs in, int n_words,
                                  int32_t* __restrict__ out) {
  extern __shared__ uint32_t rf[];  // [n_slots][blockDim.x]
  const int T = blockDim.x, t = threadIdx.x;
  const long long w = (long long)blockIdx.x * T + t;
  if (w >= n_words) return;  // threads never synchronise
  for (int s = 0; s < n_slots; ++s) {
    const int code = __ldg(init + s);
    uint32_t v = 0;
    if (code >= 0) {
      v = (uint32_t)__ldg(in.p[code >> 16] +
                          (long long)(code & 0xffff) * n_words + w);
    }
    rf[s * T + t] = v;
  }
#pragma unroll 4
  for (int k = 0; k < n_instr; ++k) {
    const int4 ins = __ldg(prog + k);
    const uint32_t f0 = (uint32_t)ins.x, f1 = (uint32_t)ins.y;
    const uint32_t f2 = (uint32_t)ins.z, f3 = (uint32_t)ins.w;
    const uint32_t a = rd(rf, f0 & 0xffffu, T, t);
    const uint32_t b = rd(rf, f0 >> 16, T, t);
    const uint32_t c = rd(rf, f1 & 0xffffu, T, t);
    const uint32_t v = (a & b) | (a & c) | (b & c);
    wr(rf, f1 >> 16, T, t, v);
    wr(rf, f2 & 0xffffu, T, t, v);
    wr(rf, f2 >> 16, T, t, v);
    wr(rf, f3 & 0xffffu, T, t, v);
  }
  for (int b = 0; b < out_bits; ++b) {
    out[(long long)b * n_words + w] = (int32_t)rf[__ldg(out_slots + b) * T + t];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `inputs` is a host array of
// n_inputs device pointers; `threads` is the block size (words per block)
// the wrapper chose.  Launches on `stream` and returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int repro_simdram_vm(const int32_t* prog, int n_instr,
                                const int32_t* init, int n_slots,
                                const int32_t* out_slots, int out_bits,
                                const int32_t* const* inputs, int n_inputs,
                                int n_words, int threads, int32_t* out,
                                void* stream) {
  if (n_instr < 0 || n_slots < 1 || out_bits < 1 || n_inputs < 0 ||
      n_inputs > kMaxInputs || n_words < 1 || threads < 1 ||
      threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  VmInputs in = {};
  for (int k = 0; k < n_inputs; ++k) in.p[k] = inputs[k];
  const size_t smem = sizeof(uint32_t) * (size_t)n_slots * threads;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        simdram_vm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_words + threads - 1) / threads;
  simdram_vm_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(prog), n_instr, init, n_slots, out_slots,
      out_bits, in, n_words, out);
  return (int)cudaGetLastError();
}
