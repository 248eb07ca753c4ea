"""The port's bit-plane layout and transposition unit on the CPU against
the reference package, bit-exact, on the same numpy-seeded inputs:

  * the plain ``pack``/``unpack`` against the reference's ``pack``/
    ``unpack`` and its Pallas transpose kernels (``to_bitplanes``/
    ``from_bitplanes``, interpret mode, ``block_words=8``) on the grid of
    ``tests/test_kernels.py``;
  * the wrappers ``to_bitplanes``/``from_bitplanes`` on CPU tensors (their
    plain versions) against the same;
  * ``pack_np``/``unpack_np`` up to 64 bits, and the ``from_numpy``/
    ``to_numpy`` bridge.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels import from_bitplanes as j_from_bitplanes
from repro.kernels import to_bitplanes as j_to_bitplanes
from repro.kernels.bitplane_transpose.kernel import (pack_tiles as
                                                     j_pack_tiles)
from repro.kernels.bitplane_transpose.kernel import (unpack_tiles as
                                                     j_unpack_tiles)
from repro_torch.core import bitplane as tbp
from repro_torch.kernels import bitplane_transpose as tt
from repro_torch.kernels import simdram_vm

CPU = torch.device("cpu")


def _ints(n_bits, n_elems, seed):
    rng = np.random.default_rng(seed)
    lo = -(1 << (n_bits - 1))
    return rng.integers(lo, -lo, n_elems)


@pytest.mark.parametrize("n_bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n_elems", [1, 31, 256, 1000])
def test_transpose_matches_reference(n_bits, n_elems):
    x = _ints(n_bits, n_elems, n_bits * 1000 + n_elems).astype(np.int32)
    jplanes = np.asarray(j_to_bitplanes(jnp.asarray(x), n_bits,
                                        block_words=8).planes)
    assert np.array_equal(jplanes, np.asarray(jbp.pack(jnp.asarray(x),
                                                       n_bits).planes))
    xt = torch.from_numpy(x)
    for bp in (tbp.pack(xt, n_bits), tt.to_bitplanes(xt, n_bits),
               tt.to_bitplanes(xt.to(torch.int64), n_bits)):
        assert bp.planes.dtype == torch.int32
        assert bp.planes.shape == (n_bits, -(-n_elems // 32))
        np.testing.assert_array_equal(bp.to_numpy(), jplanes)
    jbp_arr = jbp.BitPlaneArray(jnp.asarray(jplanes), n_elems, True)
    back = np.asarray(j_from_bitplanes(jbp_arr, block_words=8))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(np.asarray(jbp.unpack(jbp_arr)), x)
    tarr = tbp.BitPlaneArray.from_numpy(jplanes, n_elems, True, CPU)
    for got in (tbp.unpack(tarr), tt.from_bitplanes(tarr)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("n_bits", [4, 8, 32])
def test_unsigned_unpack_matches_reference(n_bits):
    """Unsigned planes unpack without sign extension; at 32 bits the int32
    result carries the uint32 pattern, as ``astype(int32)`` does."""
    x = _ints(n_bits, 77, n_bits)
    planes = tbp.pack_np(x, n_bits, signed=False, device=CPU)
    jarr = jbp.BitPlaneArray(jnp.asarray(planes.to_numpy()), 77, False)
    ref = np.asarray(j_from_bitplanes(jarr, block_words=8))
    np.testing.assert_array_equal(tt.from_bitplanes(planes).numpy(), ref)
    np.testing.assert_array_equal(tbp.unpack(planes).numpy(),
                                  np.asarray(jbp.unpack(jarr)))


@pytest.mark.parametrize("n_bits", [8, 16, 32, 64])
def test_pack_np_unpack_np_match_reference(n_bits):
    x = _ints(n_bits, 100, n_bits)
    ref = jbp.pack_np(x, n_bits)
    got = tbp.pack_np(x, n_bits, device=CPU)
    assert got.planes.shape == (n_bits, 4)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.planes))
    np.testing.assert_array_equal(tbp.unpack_np(got), jbp.unpack_np(ref))
    np.testing.assert_array_equal(tbp.unpack_np(got), x)
    # the torch unpack is 64-bit exact too
    np.testing.assert_array_equal(tbp.unpack(got, torch.int64).numpy(), x)


def test_wide_ints_are_cut_to_their_low_32_bits():
    """``x.astype(uint32)``: an int64 beyond 32 bits packs its low word."""
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 62), 1 << 62, 300)
    low = (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ref = np.asarray(jbp.pack(jnp.asarray(low), 32).planes)
    for n_bits in (32, 40):
        got = tbp.pack(torch.from_numpy(x), n_bits)
        np.testing.assert_array_equal(got.to_numpy()[:32], ref)
        assert not got.to_numpy()[32:].any()
    np.testing.assert_array_equal(
        tt.to_bitplanes(torch.from_numpy(x), 32).to_numpy(), ref)


def test_tiles_match_reference_kernels():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, (16, 32), dtype=np.uint64)
    words = words.astype(np.uint32)
    jplanes = np.asarray(j_pack_tiles(jnp.asarray(words), 32, block_words=8))
    got = tt.pack_tiles(torch.from_numpy(words.view(np.int32)), 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), jplanes)
    jlanes = np.asarray(j_unpack_tiles(jnp.asarray(jplanes), 32,
                                       block_words=8))
    np.testing.assert_array_equal(jlanes, words)
    np.testing.assert_array_equal(
        tt.unpack_tiles(got).numpy().view(np.uint32), jlanes)


def test_from_numpy_round_trip_and_maj3():
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 1 << 32, (5, 9), dtype=np.uint64)
    planes = planes.astype(np.uint32)
    bp = tbp.BitPlaneArray.from_numpy(planes, 270, False, CPU)
    assert (bp.n_bits, bp.n_words, bp.device) == (5, 9, CPU)
    np.testing.assert_array_equal(bp.to_numpy(), planes)
    a, b, c = (torch.from_numpy(p.view(np.int32).copy()) for p in planes[:3])
    ref = jbp.maj3(*(jnp.asarray(p) for p in planes[:3]))
    np.testing.assert_array_equal(tbp.maj3(a, b, c).numpy().view(np.uint32),
                                  np.asarray(ref))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbp.pack_np(np.arange(4), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbp.BitPlaneArray.from_numpy(np.zeros((8, 1), np.uint32), 4)


@pytest.mark.parametrize("n_bits", [0, 33])
def test_transpose_wrappers_refuse_widths_past_32(n_bits):
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="bit"):
        tt.to_bitplanes(x, n_bits)
    planes = torch.zeros((max(n_bits, 1), 1), dtype=torch.int32)
    bp = tbp.BitPlaneArray(planes if n_bits else planes[:0], 8)
    with pytest.raises(ValueError, match="bit"):
        tt.from_bitplanes(bp)


def test_transpose_wrappers_refuse_other_devices():
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tt.to_bitplanes(x, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tt.from_bitplanes(tbp.BitPlaneArray(
            torch.zeros((8, 1), dtype=torch.int32, device="meta"), 8))


@pytest.mark.parametrize("build", [tt.build_kernel,
                                   simdram_vm.build_kernel],
                         ids=["bitplane_transpose", "simdram_vm"])
def test_build_needs_the_cuda_toolkit(build):
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build()
