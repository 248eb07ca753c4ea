"""The SIMDRAM control unit on the card: the μProgram-VM kernel
(``csrc/simdram_vm.cu``) and its wrappers.

:func:`run_uprogram` executes a μProgram over packed bit planes.  For CUDA
tensors it lowers and compiles the program to the VM's instruction stream
(once per program and input widths, ``lower.py``) and launches the kernel
— or raises; for CPU tensors it runs the plain version,
:func:`repro_torch.core.engine.execute`.  There is no fallback from one to
the other.  ``run_uprogram.launches`` counts kernel launches.
:func:`simdram_op` runs a registered operation by name.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from ...core.bitplane import BitPlaneArray
from ...core.engine import execute
from ...core.operations import OPS, get_uprogram
from ...core.uprogram import UProgram
from .. import _build
from .lower import CompiledProgram, compile_lowered, lower

SOURCE = Path(__file__).resolve().parent / "csrc" / "simdram_vm.cu"
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_BYTES = 232_448
MAX_INPUTS = 8
#: words a thread may carry (the kernel's template instances)
MAX_WORDS_PER_THREAD = 4
#: threads x words per thread of one block (the kernel's launch bounds)
MAX_BLOCK_WORDS = 1024
#: blocks per SM the grid should give before a thread carries more words
BLOCKS_PER_SM = 2
#: compiled programs kept, most recently used last
_CACHE_ENTRIES = 64
_COMPILED: "OrderedDict[tuple, Tuple[UProgram, CompiledProgram, Dict]]" = \
    OrderedDict()


def build_kernel() -> Tuple[Path, str]:
    """Compile the VM library (once per source and flags).  Returns
    (library path, compiler log with ``ptxas``' report)."""
    return _build.build(SOURCE, "simdram_vm")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "simdram_vm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_simdram_vm.argtypes = [p, i, i, p, i, i, i, i, p, p]
    lib.repro_simdram_vm.restype = i
    return lib


def compiled(uprog: UProgram, input_names: Sequence[str],
             input_bits: Sequence[int], out_bits: int
             ) -> Tuple[CompiledProgram, Dict]:
    """The compiled program and its per-device tensors, from a cache keyed
    by the program object: a μProgram is a static artifact, not edited
    once it has run."""
    key = (id(uprog), tuple(input_names), tuple(input_bits), out_bits)
    hit = _COMPILED.get(key)
    if hit is None or hit[0] is not uprog:
        hit = (uprog, compile_lowered(lower(uprog, input_names, input_bits,
                                            out_bits)), {})
        _COMPILED[key] = hit
        if len(_COMPILED) > _CACHE_ENTRIES:
            _COMPILED.popitem(last=False)
    _COMPILED.move_to_end(key)
    return hit[1], hit[2]


def threads_per_block(n_slots: int, block_words: int) -> int:
    """Threads per block: ``block_words``, cut to the most multiple of 32
    whose row file (n_slots x threads x 4 B) fits in shared memory."""
    fit = SMEM_BYTES // (4 * n_slots) // 32 * 32
    if fit < 32:
        raise ValueError(f"{n_slots} rows x 32 threads x 4 B exceed the "
                         f"{SMEM_BYTES} B of shared memory of a block")
    return min(block_words, fit, MAX_BLOCK_WORDS)


def launch_shape(n_slots: int, n_words: int, block_words: int,
                 n_sms: int, align_words: int = MAX_WORDS_PER_THREAD
                 ) -> Tuple[int, int]:
    """(threads per block, words per thread).  A thread carries 1, 2 or 4
    consecutive words: more while the count divides ``n_words`` and
    ``align_words`` (the words to which every plane's address is aligned),
    threads x words stays within ``MAX_BLOCK_WORDS``, the grid still gives
    ``BLOCKS_PER_SM`` blocks to each of ``n_sms`` SMs, and the row file
    (n_slots x words x threads x 4 B) fits in half the shared memory, so
    two blocks share an SM."""
    threads = threads_per_block(n_slots, block_words)
    words = 1
    while (words < MAX_WORDS_PER_THREAD
           and n_words % (2 * words) == 0 and align_words % (2 * words) == 0
           and 2 * words * threads <= MAX_BLOCK_WORDS
           and 8 * n_slots * words * threads <= SMEM_BYTES // 2
           and -(-n_words // (2 * words * threads))
           >= BLOCKS_PER_SM * n_sms):
        words *= 2
    return threads, words


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda_args(planes, input_names, out_bits, block_words) -> None:
    dev = planes[0].device
    if len(planes) != len(input_names) or len(planes) > MAX_INPUTS:
        raise ValueError(f"{len(planes)} planes for inputs {input_names} "
                         f"(at most {MAX_INPUTS})")
    for name, p in zip(input_names, planes):
        if p.device != dev:
            raise ValueError(f"planes of {name} are on {p.device}, the "
                             f"first input's on {dev}")
        if p.dtype != torch.int32:
            raise TypeError(f"planes of {name} must be int32, got {p.dtype}")
        if p.dim() != 2 or not p.is_contiguous():
            raise ValueError(f"planes of {name} must be a contiguous "
                             f"[n_bits, n_words] tensor")
        if p.shape[1] != planes[0].shape[1]:
            raise ValueError(f"planes of {name} have {p.shape[1]} words, "
                             f"the first input's {planes[0].shape[1]}")
    if not isinstance(out_bits, int) or out_bits < 1:
        raise ValueError(f"out_bits must be a positive int, got {out_bits!r}")
    if not isinstance(block_words, int) or block_words < 1:
        raise ValueError(f"block_words must be a positive int, got "
                         f"{block_words!r}")


def run_uprogram(uprog: UProgram, planes: Sequence[torch.Tensor],
                 input_names: Sequence[str], out_bits: int,
                 block_words: int = 128) -> torch.Tensor:
    """Execute a μProgram over packed planes int32 [n_bits_i, n_words] each;
    returns int32 [out_bits, n_words].  ``block_words`` is the CUDA threads
    per block, cut to what the row file lets fit; each thread carries one
    or more words, as the word count asks (:func:`launch_shape`).  The
    result depends on neither."""
    planes = list(planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return execute(uprog, dict(zip(input_names, planes)),
                       planes[0].shape[1], out_bits=out_bits)
    if dev.type != "cuda":
        raise ValueError(f"run_uprogram runs on CUDA or CPU tensors, got "
                         f"{dev}")
    _check_cuda_args(planes, input_names, out_bits, block_words)
    n_words = planes[0].shape[1]
    out = torch.empty((out_bits, n_words), dtype=torch.int32, device=dev)
    if n_words == 0:
        return out
    prog, on_device = compiled(uprog, input_names,
                               [p.shape[0] for p in planes], out_bits)
    if dev not in on_device:
        on_device[dev] = torch.from_numpy(prog.code).to(dev)
    # the words to which every plane read is aligned (out is fresh)
    addrs = [p.data_ptr() for p in planes if p.numel()]
    align = min((a & -a for a in addrs),
                default=4 * MAX_WORDS_PER_THREAD) // 4
    threads, words = launch_shape(prog.n_slots, n_words, block_words,
                                  _n_sms(dev.index), align)
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[p.data_ptr() for p in planes])
    rc = _library().repro_simdram_vm(
        on_device[dev].data_ptr(), prog.n_instr, prog.n_slots, ptrs,
        len(planes), n_words, threads, words, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"simdram_vm kernel launch failed with CUDA error "
                           f"{rc}")
    run_uprogram.launches += 1
    return out


def simdram_op(name: str, *inputs: BitPlaneArray, style: str = "simdram",
               block_words: int = 128) -> BitPlaneArray:
    """Run a registered SIMDRAM operation (``core.operations.OPS``) on
    bit-plane inputs through :func:`run_uprogram`."""
    spec = OPS[name]
    n = inputs[0].n_bits
    out = run_uprogram(get_uprogram(name, n, style),
                       [x.planes for x in inputs], spec.input_names,
                       spec.out_bits(n), block_words=block_words)
    return BitPlaneArray(out, inputs[0].n_elems, inputs[0].signed)


run_uprogram.launches = 0
