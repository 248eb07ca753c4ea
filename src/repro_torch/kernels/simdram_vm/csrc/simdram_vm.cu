// The SIMDRAM control unit as a μProgram virtual machine for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/simdram_vm/kernel.py::make_vm_kernel
// (driven by run_uprogram), which unrolls one μProgram into each traced
// kernel.  Here the kernel is compiled once and the μProgram is data: a
// stream of MAJ, LOAD, STORE and WAIT instructions compiled on the host
// by ../lower.py (lower, then compile_lowered).
//
// Contract (lower.py::compile_lowered, ops.py::run_uprogram):
//   prog     [n_instr + kAhead] uint2  four 16-bit fields f0 f1 f2 f3, f0
//            the low half of .x; f3 = dst << 2 | kind and
//              MAJ   (0): f0..f2 = slot << 1 | complement, only f0 ever
//                         complemented; dst <- maj(f0, f1, f2)
//              LOAD  (1): dst <- plane f1 of input f0, landing later
//              STORE (2): plane f1 of out <- slot f0 >> 1, complemented
//                         when f0 & 1
//              WAIT  (3): until every LOAD this thread issued has landed
//                         (one precedes the first read of a loaded slot)
//            n_instr is a multiple of kAhead; the kAhead instructions
//            after them may be fetched and are never run
//   n_slots  row-file slots; slot 0 is the zero row (a constant is a read
//            of slot 0 or its complement), every other slot is written
//            before it is read
//   inputs   up to kMaxInputs pointers to i32 [n_bits_i, n_words] planes,
//            only ever read
//   out      [out_bits, n_words] i32; the stream stores every plane once
//   W        words per thread: n_words is a multiple of W, and every plane
//            and out start 4·W-byte aligned
// An instruction reads all its operands before it writes its destination,
// so a destination may be one of its operands' slots.  The outputs are
// bit for bit those of core/engine.py::execute, with its destructive-TRA
// semantics, which the host compiler resolved into this dataflow.
//
// What bounds it: bytes for most programs, operations for the long ones.
// It must read the input planes once and write the output planes once;
// per 32-lane word it does one three-input logic op (a LOP3) per MAJ
// instruction.  add at 32 bits (96 MAJ over 96 planes of I/O) is bound by
// bytes, mul and div at 32 bits (2,016 and 5,769 MAJ) by operations.
//
// What the design does about that bound:
//   * each thread carries W consecutive 32-lane words (W = 1, 2 or 4, a
//     template argument the wrapper picks from the word count), so one
//     uniform 8-byte instruction load and its decode serve W words, and
//     every access is one vector access: 4·W bytes of a slot, a plane or
//     an output plane;
//   * the row file lives in dynamic shared memory laid out
//     [slot][thread][W]: a warp's vector access to one slot covers
//     128·W contiguous bytes, as few shared-memory wavefronts as its
//     bytes allow; slots are allocated by liveness on the host, so the
//     file holds only live values (11 slots for add at 32 bits, 105 for
//     div) and blocks stay large;
//   * a MAJ is three shared loads, one LOP3 per word (inline PTX; the
//     truth table 0xE8, or 0x8E when the first operand is complemented,
//     so a complement costs nothing) and one shared store;
//   * a LOAD is a cp.async from device memory straight into the row file,
//     so the host's groups of eight LOADs, issued ahead of their first
//     reads, are in flight at once and a thread waits once per group; a
//     STORE goes straight to `out`, coalesced across the warp;
//   * the stream is fetched in groups of kAhead instructions, a group
//     ahead of execution, so its loads (L1 or L2: the row file leaves L1
//     little room) overlap the work instead of each instruction waiting
//     for its own;
//   * threads never interact, so they never synchronise: a thread whose
//     words are past n_words returns.  All plane indexing is 64-bit.
// A LOAD may reuse a slot that an earlier instruction read last: that
// read's value was consumed (by a LOP3 or a store) before the LOAD issues,
// so the copy cannot overtake it.
// Rows in registers for one program compiled per μProgram, and one launch
// per bbop sequence, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kAhead = 8;  // instructions fetched ahead of execution
constexpr uint32_t kMaj = 0, kLoad = 1, kStore = 2;

struct VmInputs {
  const int32_t* p[kMaxInputs];
};

template <uint32_t kTable>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kTable));
  return d;
}

// W consecutive words as one vector access
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = *p;
  } else if constexpr (W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_words(T* p, const uint32_t (&v)[W]) {
  if constexpr (W == 1) {
    *reinterpret_cast<uint32_t*>(p) = v[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
}

// dst <- maj over W words; the first operand read through kTable
template <int W, uint32_t kTable>
__device__ __forceinline__ void maj(const uint32_t* a, const uint32_t* b,
                                    const uint32_t* c, uint32_t* dst) {
  uint32_t va[W], vb[W], vc[W];
  load_words<W>(a, va);  // every operand before the write
  load_words<W>(b, vb);
  load_words<W>(c, vc);
#pragma unroll
  for (int j = 0; j < W; ++j) va[j] = lop3<kTable>(va[j], vb[j], vc[j]);
  store_words<W>(dst, va);
}

// the cp.async of W words of one plane into the row file
template <int W>
__device__ __forceinline__ void load_plane(uint32_t* to,
                                           const int32_t* from) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(to);
  if constexpr (W == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(from) : "memory");
  } else if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(from) : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s + 16 * q), "l"(from + 4 * q) : "memory");
    }
  }
}

template <int W>
__device__ __forceinline__ void run(uint2 ins, uint32_t* mine, int T,
                                    const VmInputs& in, long long w0,
                                    int n_words, int32_t* __restrict__ out) {
  const uint32_t f0 = ins.x & 0xffffu, f1 = ins.x >> 16;
  const uint32_t f2 = ins.y & 0xffffu, f3 = ins.y >> 16;
  const int slot = W * T;
  uint32_t* dst = mine + (f3 >> 2) * slot;
  switch (f3 & 3u) {
    case kMaj: {
      const uint32_t* a = mine + (f0 >> 1) * slot;
      const uint32_t* b = mine + (f1 >> 1) * slot;
      const uint32_t* c = mine + (f2 >> 1) * slot;
      if (f0 & 1u) {
        maj<W, 0x8E>(a, b, c, dst);  // maj(~a, b, c)
      } else {
        maj<W, 0xE8>(a, b, c, dst);
      }
      break;
    }
    case kLoad:
      load_plane<W>(dst, in.p[f0] + (long long)f1 * n_words + w0);
      break;
    case kStore: {
      uint32_t v[W];
      load_words<W>(mine + (f0 >> 1) * slot, v);
      const uint32_t m = 0u - (f0 & 1u);
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] ^= m;
      store_words<W>(out + (long long)f1 * n_words + w0, v);
      break;
    }
    default:  // WAIT
      asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// at most 1024 / W threads, so that W = 4 has 255 registers to spare
template <int W>
__global__ void __launch_bounds__(1024 / W)
    simdram_vm_kernel(const uint2* __restrict__ prog, int n_instr,
                      VmInputs in, int n_words, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t rf[];  // [n_slots][T][W]
  const int T = blockDim.x;
  const long long w0 = ((long long)blockIdx.x * T + threadIdx.x) * W;
  if (w0 >= n_words) return;  // threads never synchronise
  uint32_t* mine = rf + threadIdx.x * W;
  const uint32_t zero[W] = {};
  store_words<W>(mine, zero);  // slot 0: the zero row
  // The stream is fetched a group of kAhead instructions ahead, into two
  // register groups that take turns: each group's loads are read only a
  // group later.  It is the same for every thread, and the compiler moves
  // a uniform load's value into a uniform register at once, which waits
  // for the load; offsetting the stream by this thread's zero row, read
  // back as volatile (so 0, but a per-thread value to the compiler),
  // keeps the groups in vector registers.
  prog += (int)*reinterpret_cast<volatile uint32_t*>(mine);
  uint2 now[kAhead], next[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) now[i] = __ldg(prog + i);
  for (int k = 0; k < n_instr; k += 2 * kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) next[i] = __ldg(prog + k + kAhead + i);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      run<W>(now[i], mine, T, in, w0, n_words, out);
    }
    if (k + kAhead == n_instr) break;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      now[i] = __ldg(prog + k + 2 * kAhead + i);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      run<W>(next[i], mine, T, in, w0, n_words, out);
    }
  }
}

template <int W>
int launch(const uint2* prog, int n_instr, int n_slots, const VmInputs& in,
           int n_words, int threads, int32_t* out, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)n_slots * W * threads;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        simdram_vm_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long per_block = (long long)threads * W;
  const long long blocks = (n_words + per_block - 1) / per_block;
  simdram_vm_kernel<W><<<(unsigned)blocks, threads, smem, stream>>>(
      prog, n_instr, in, n_words, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `inputs` is a host array of
// n_inputs device pointers; `threads` (per block) and `words_per_thread`
// (1, 2 or 4; threads x words_per_thread <= 1024) are the launch shape the
// wrapper chose.  Launches on `stream` and returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int repro_simdram_vm(const int32_t* prog, int n_instr,
                                int n_slots, const int32_t* const* inputs,
                                int n_inputs, int n_words, int threads,
                                int words_per_thread, int32_t* out,
                                void* stream) {
  if (n_instr < 0 || n_instr % kAhead != 0 || n_slots < 1 ||
      n_inputs < 0 || n_inputs > kMaxInputs || n_words < 1 || threads < 1 ||
      threads * words_per_thread > 1024 ||
      n_words % words_per_thread != 0) {
    return (int)cudaErrorInvalidValue;
  }
  VmInputs in = {};
  for (int k = 0; k < n_inputs; ++k) in.p[k] = inputs[k];
  const uint2* p = reinterpret_cast<const uint2*>(prog);
  cudaStream_t s = (cudaStream_t)stream;
  switch (words_per_thread) {
    case 1: return launch<1>(p, n_instr, n_slots, in, n_words, threads,
                             out, s);
    case 2: return launch<2>(p, n_instr, n_slots, in, n_words, threads,
                             out, s);
    case 4: return launch<4>(p, n_instr, n_slots, in, n_words, threads,
                             out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
