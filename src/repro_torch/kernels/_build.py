"""Build a hand-written CUDA source into a shared library and load it.

Every kernel family of the port is a ``.cu`` file with a plain C entry
point, compiled at first use with ``nvcc`` for ``sm_90a`` and bound with
``ctypes``.  A library lands in ``build/kernels/<hash>/lib<name>.so`` at the
repository root, keyed by a hash of the source, the flags and the library
name, so an edited source rebuilds and an unchanged one is reused.  The
compiler log (``ptxas`` register, shared-memory and spill counts) is kept
beside it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source with the CUDA toolkit")
    return path


def build(source: Path, name: str,
          flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, str]:
    """Compile ``source`` into ``lib<name>.so`` unless this source, these
    flags and this name were built already.  Returns (library path,
    compiler log)."""
    flags = tuple(flags)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                            + name.encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib = out_dir / f"lib{name}.so"
    log = out_dir / "build.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp-{os.getpid()}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)            # atomic: concurrent builds agree
    return lib, text


@functools.lru_cache(maxsize=None)
def load(source: Path, name: str,
         flags: Tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of :func:`build` (built on first call)."""
    path, _ = build(source, name, flags)
    return ctypes.CDLL(str(path))
