"""The SIMDRAM control unit on the card: the μProgram-VM kernel
(``csrc/simdram_vm.cu``) and its wrappers.

:func:`run_uprogram` executes a μProgram over packed bit planes.  For CUDA
tensors it lowers the program to the VM's instruction stream (once per
program and input widths, ``lower.py``) and launches the kernel — or
raises; for CPU tensors it runs the plain version,
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
from .lower import LoweredProgram, lower

SOURCE = Path(__file__).resolve().parent / "csrc" / "simdram_vm.cu"
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_BYTES = 232_448
MAX_INPUTS = 8
#: lowered programs kept, most recently used last
_CACHE_ENTRIES = 64
_LOWERED: "OrderedDict[tuple, Tuple[UProgram, LoweredProgram, Dict]]" = \
    OrderedDict()


def build_kernel() -> Tuple[Path, str]:
    """Compile the VM library (once per source and flags).  Returns
    (library path, compiler log with ``ptxas``' report)."""
    return _build.build(SOURCE, "simdram_vm")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "simdram_vm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_simdram_vm.argtypes = [p, i, p, i, p, i, p, i, i, i, p, p]
    lib.repro_simdram_vm.restype = i
    return lib


def _lowered(uprog: UProgram, input_names: Sequence[str],
             input_bits: Sequence[int], out_bits: int
             ) -> Tuple[LoweredProgram, Dict]:
    """The lowered program and its per-device tensors, from a cache keyed
    by the program object: a μProgram is a static artifact, not edited
    once it has run."""
    key = (id(uprog), tuple(input_names), tuple(input_bits), out_bits)
    hit = _LOWERED.get(key)
    if hit is None or hit[0] is not uprog:
        hit = (uprog, lower(uprog, input_names, input_bits, out_bits), {})
        _LOWERED[key] = hit
        if len(_LOWERED) > _CACHE_ENTRIES:
            _LOWERED.popitem(last=False)
    _LOWERED.move_to_end(key)
    return hit[1], hit[2]


def threads_per_block(n_slots: int, block_words: int) -> int:
    """Words (threads) per block: ``block_words``, cut to the most multiple
    of 32 whose row file (n_slots x threads x 4 B) fits in shared memory."""
    fit = SMEM_BYTES // (4 * n_slots) // 32 * 32
    if fit < 32:
        raise ValueError(f"{n_slots} rows x 32 threads x 4 B exceed the "
                         f"{SMEM_BYTES} B of shared memory of a block")
    return min(block_words, fit, 1024)


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
    returns int32 [out_bits, n_words].  ``block_words`` is the words (CUDA
    threads) per block, cut to what the row file lets fit; the result does
    not depend on it."""
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
    prog, on_device = _lowered(uprog, input_names,
                               [p.shape[0] for p in planes], out_bits)
    if dev not in on_device:
        on_device[dev] = tuple(torch.from_numpy(a).to(dev) for a in
                               (prog.instrs, prog.init, prog.out_slots))
    instrs, init, out_slots = on_device[dev]
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[p.data_ptr() for p in planes])
    rc = _library().repro_simdram_vm(
        instrs.data_ptr(), prog.n_instr, init.data_ptr(), prog.n_slots,
        out_slots.data_ptr(), out_bits, ptrs, len(planes), n_words,
        threads_per_block(prog.n_slots, block_words), out.data_ptr(),
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
