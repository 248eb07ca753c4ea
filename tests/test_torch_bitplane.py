"""The port's bit-plane layout and transposition unit on the CPU against
the reference package, bit-exact, on the same numpy-seeded inputs:

  * the plain ``pack``/``unpack`` against the reference's ``pack``/
    ``unpack`` and its Pallas transpose kernels (``to_bitplanes``/
    ``from_bitplanes``, interpret mode, ``block_words=8``) on the grid of
    ``tests/test_kernels.py``;
  * the wrappers ``to_bitplanes``/``from_bitplanes`` on CPU tensors (their
    plain versions) against the same;
  * ``pack_np``/``unpack_np`` up to 64 bits, and the ``from_numpy``/
    ``to_numpy`` bridge;
  * a numpy model of the CUDA kernels (``csrc/bitplane_transpose.cu``):
    their 32 x 32 bit transpose in 8 lanes of 4 registers, stage by stage
    (three shuffle stages, two inside a lane), their tiles
    (``ops.PACK_TILE``, ``ops.unpack_tile``) and the 16-byte or 4-byte
    choice for each chunk
    of 4 elements or plane words, against ``pack_np``/``unpack_np`` and the
    reference's ``pack_tiles``/``unpack_tiles`` for every n_bits 1..32,
    ragged and unaligned inputs included.

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
from repro_torch.kernels.bitplane_transpose import ops as tops

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


# -- numpy model of csrc/bitplane_transpose.cu ---------------------------------
_U32 = np.uint32
#: low_mask(s): the bits c of a word with c & s == 0
_LOW = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
        1: 0x55555555}
_LANE = np.arange(32)
_WARPS = 8


def _rows(n_bits):
    """The instance's tile rows: n_bits rounded up to 8, 16 or 32."""
    return 8 if n_bits <= 8 else 16 if n_bits <= 16 else 32


def _np_transpose32(v):
    """``transpose32``: v uint32 [..., 32 lanes, 4 registers]; lanes 8g..8g+7
    hold one 32 x 32 bit matrix, row 4q + j in register j of lane q.
    Stages S = 16, 8, 4 pair lane q with q ^ S/4 (the lane sends its
    register rotated left by S if it holds the upper row, by 32 - S if the
    lower, and keeps its own bits under ``keep``); S = 2, 1 swap inside a
    lane."""
    v = v.copy()
    q = _LANE & 7
    for s in (16, 8, 4):
        m = _U32(_LOW[s])
        upper = (q & (s // 4)) != 0
        keep = np.where(upper, ~m, m).astype(_U32)[:, None]
        rot = np.where(upper, s, 32 - s).astype(_U32)[:, None]
        send = (v << rot) | (v >> (_U32(32) - rot))
        got = send[..., _LANE ^ (s // 4), :]           # __shfl_xor_sync
        v = (v & keep) | (got & ~keep)
    for s in (2, 1):
        m = _U32(_LOW[s])
        for j in range(4):
            if j & s:
                continue
            t = ((v[..., j] >> _U32(s)) ^ v[..., j + s]) & m
            v[..., j + s] ^= t
            v[..., j] ^= t << _U32(s)
    return v


def _grid(blocks, tile_words):
    """(block, word of the tile, lane q) of every (block, warp, k, lane):
    warp w takes words w 4K + 4k + g, g = lane >> 3."""
    K = tile_words // 32
    blk, warp, k, lane = np.meshgrid(np.arange(blocks), np.arange(_WARPS),
                                     np.arange(K), _LANE, indexing="ij")
    return blk, warp * 4 * K + 4 * k + (lane >> 3), lane & 7


def _items(NB, tile_words):
    """The plane side's items c (warp c % 8 takes them): lane (p, i) moves
    row 4 (c / runs) + p, words 32 (c % runs) + 4i .. + 3 of the tile."""
    runs = tile_words // 32
    for c in range(NB // 4 * runs):
        yield 4 * (c // runs) + (_LANE >> 3), 32 * (c % runs) + 4 * (_LANE & 7)


def _np_pack_kernel(x, n_bits, tile_words, x_addr=0):
    """``pack_kernel`` on int array ``x`` (int32 or int64, its itemsize the
    element's) whose element 0 lies ``x_addr`` bytes past a 16-byte
    boundary.  Returns (planes uint32 [n_bits, n_words], counts of 16-byte
    and 4-byte loads and stores)."""
    n, eb = len(x), x.dtype.itemsize
    n_words = -(-n // 32)
    xu = (x.astype(np.int64) & 0xFFFFFFFF).astype(_U32)
    NB, blocks = _rows(n_bits), -(-n_words // tile_words)
    blk, lw, q = _grid(blocks, tile_words)
    e = (blk * tile_words + lw) * 32 + 4 * q          # the lane's chunk
    vec = (e + 3 < n) & ((x_addr + e * eb) % 16 == 0)
    idx = e[..., None] + np.arange(4)
    v = np.where(idx < n, xu[np.minimum(idx, n - 1)], _U32(0)).astype(_U32)
    stats = {"load16": int(vec.sum()),
             "load4": int(((idx < n) & ~vec[..., None]).sum())}
    v = _np_transpose32(v)
    tile = np.zeros((blocks, NB, tile_words + 1), _U32)
    hits = np.zeros(tile.shape, int)
    rows = 4 * q[..., None] + np.arange(4)
    ok = rows < NB
    at = (np.broadcast_to(blk[..., None], rows.shape)[ok], rows[ok],
          np.broadcast_to(lw[..., None], rows.shape)[ok])
    tile[at] = v[ok]
    np.add.at(hits, at, 1)
    assert (hits[:, :, :tile_words] == 1).all()      # each cell once
    planes = np.zeros((n_bits, n_words), _U32)
    writes = np.zeros(planes.shape, int)
    stats.update(store16=0, store4=0)
    for b, w in _items(NB, tile_words):
        word = np.arange(blocks)[:, None] * tile_words + w      # [blocks, 32]
        b = np.broadcast_to(b, word.shape)
        live = b < n_bits
        vec = live & (word + 3 < n_words) & ((b * n_words + word) % 4 == 0)
        stats["store16"] += int(vec.sum())
        for m in range(4):
            put = live & (word + m < n_words)
            stats["store4"] += int((put & ~vec).sum())
            planes[b[put], word[put] + m] = tile[
                np.broadcast_to(np.arange(blocks)[:, None], b.shape)[put],
                b[put], np.broadcast_to(w, b.shape)[put] + m]
            np.add.at(writes, (b[put], word[put] + m), 1)
    assert (writes == 1).all()                       # each plane word once
    return planes, stats


def _np_unpack_kernel(planes, n_elems, signed, tile_words):
    """``unpack_kernel`` on uint32 planes [n_bits, n_words] (row stride
    n_words, base 16-byte aligned).  Returns (int32 [n_elems], counts of
    16-byte and 4-byte loads and stores)."""
    n_bits, n_words = planes.shape
    NB = _rows(n_bits)
    blocks = -(-(-(-n_elems // 32)) // tile_words)
    tile = np.zeros((blocks, NB, tile_words + 1), _U32)
    stats = {"load16": 0, "load4": 0}
    bi = np.arange(blocks)[:, None]
    for b, w in _items(NB, tile_words):
        word = bi * tile_words + w
        b = np.broadcast_to(b, word.shape)
        live = b < n_bits
        vec = live & (word + 3 < n_words) & ((b * n_words + word) % 4 == 0)
        stats["load16"] += int(vec.sum())
        for m in range(4):
            get = live & (word + m < n_words)
            stats["load4"] += int((get & ~vec).sum())
            val = np.where(get, planes[np.minimum(b, n_bits - 1),
                                       np.minimum(word + m, n_words - 1)], 0)
            tile[np.broadcast_to(bi, b.shape), b,
                 np.broadcast_to(w, b.shape) + m] = val
    blk, lw, q = _grid(blocks, tile_words)
    rows = 4 * q[..., None] + np.arange(4)
    v = np.where(rows < NB, tile[blk[..., None], np.minimum(rows, NB - 1),
                                 lw[..., None]], _U32(0)).astype(_U32)
    v = _np_transpose32(v)
    if signed and n_bits < 32:
        sh = _U32(32 - n_bits)
        v = ((v << sh).view(np.int32) >> sh.astype(np.int32)).view(_U32)
    e = (blk * tile_words + lw) * 32 + 4 * q
    idx = e[..., None] + np.arange(4)
    vec = (e + 3 < n_elems) & (e % 4 == 0)
    put = idx < n_elems
    stats.update(store16=int(vec.sum()),
                 store4=int((put & ~vec[..., None]).sum()))
    out = np.zeros(n_elems, _U32)
    writes = np.zeros(n_elems, int)
    out[idx[put]] = v[put]
    np.add.at(writes, idx[put], 1)
    assert (writes == 1).all()                       # each element once
    return out.view(np.int32), stats


def test_model_transpose_is_a_bit_transpose_and_its_own_inverse():
    """After ``transpose32`` bit c of row r (register j of lane q, r = 4q +
    j) is bit r of the old row c, in all four 8-lane groups at once."""
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 32, (3, 32, 4), dtype=np.uint64).astype(_U32)
    got = _np_transpose32(v)
    for g in range(4):
        rows = v[:, 8 * g:8 * g + 8].reshape(3, 32)      # row 4q + j
        bits = (rows[:, :, None] >> np.arange(32, dtype=_U32)) & _U32(1)
        want = (bits.transpose(0, 2, 1).astype(np.uint64)
                << np.arange(32, dtype=np.uint64)).sum(-1).astype(_U32)
        np.testing.assert_array_equal(
            got[:, 8 * g:8 * g + 8].reshape(3, 32), want)
    np.testing.assert_array_equal(_np_transpose32(got), v)


@pytest.mark.parametrize("n_bits", range(1, 33))
def test_unpack_tile_gives_each_thread_one_plane_load(n_bits):
    """The instance's rows (n_bits rounded up to 8, 16, 32) and the unpack
    tile: rows x words / 4 int4 loads cover the block's 256 threads once,
    or twice at 32 rows; pack's 64-word tile gives 2^20 elements 512
    blocks."""
    rows = _rows(n_bits)
    assert n_bits <= rows
    tw = tops.unpack_tile(n_bits)
    assert tw % 32 == 0
    assert rows * tw // 4 == 256 * (1 if rows == 8 else rows // 16)
    assert -(-(1 << 15) // tops.PACK_TILE) == 512


def _model_sizes(n_bits):
    """n_elems 1, 31 and 33, and one pack tile and one unpack tile +- 1
    element."""
    tiles = {tops.PACK_TILE, tops.unpack_tile(n_bits)}
    return sorted({1, 31, 33} | {32 * tw + d for tw in tiles
                                 for d in (-1, 1)})


@pytest.mark.parametrize("n_bits", range(1, 33))
def test_kernel_model_matches_pack_np_and_reference_tiles(n_bits):
    """The model of both kernels, each at its own tile, on ragged sizes
    around both tiles, with int32 input 16-byte aligned or 4 bytes off
    (x[1:]) and int64 input 8 bytes off, equals pack_np / unpack_np (signed
    and unsigned) and, on one size, the reference's Pallas tiles
    (interpret mode)."""
    tw = tops.unpack_tile(n_bits)
    for n in _model_sizes(n_bits):
        x = _ints(max(n_bits, 2), n, 31 * n_bits + n)
        ref = tbp.pack_np(x, n_bits, device=CPU)
        want = ref.to_numpy()
        for dtype, addr in ((np.int32, 0), (np.int32, 4), (np.int64, 8)):
            planes, st = _np_pack_kernel(x.astype(dtype), n_bits,
                                         tops.PACK_TILE, addr)
            np.testing.assert_array_equal(planes, want)
            if addr:                        # unaligned: every chunk 4-byte
                assert st["load16"] == 0 and st["load4"] == n
        for signed in (True, False):
            bp = tbp.BitPlaneArray(ref.planes, n, signed)
            got, st = _np_unpack_kernel(want, n, signed, tw)
            np.testing.assert_array_equal(
                got.view(np.uint32), tbp.unpack_np(bp).astype(np.uint32))
            # n_words % 4 != 0 puts rows 1.. off 16 bytes: 4-byte loads
            if want.shape[1] % 4 and n_bits > 1:
                assert st["load4"] > 0
    # the reference's kernels on 33 elements, padded to 8 words
    x = _ints(max(n_bits, 2), 33, n_bits)
    words = np.zeros((8, 32), _U32)
    words.reshape(-1)[:33] = x.astype(np.int64) & 0xFFFFFFFF
    jplanes = np.asarray(j_pack_tiles(jnp.asarray(words), n_bits,
                                      block_words=8))
    planes, _ = _np_pack_kernel(words.reshape(-1).view(np.int32), n_bits,
                                tops.PACK_TILE)
    np.testing.assert_array_equal(planes, jplanes)
    jlanes = np.asarray(j_unpack_tiles(jnp.asarray(jplanes), n_bits,
                                       block_words=8))
    got, _ = _np_unpack_kernel(planes, 256, False, tw)
    np.testing.assert_array_equal(got.view(_U32), jlanes.reshape(-1))


@pytest.mark.parametrize("n_bits", range(1, 33))
def test_kernel_model_at_2_20_plus_17(n_bits):
    """At 2^20 + 17 elements (32,769 words, a ragged last tile; pack at its
    64-word tile, unpack at its own): the model's planes equal
    pack_np's, every chunk but the ragged last one is one 16-byte load,
    and the unpack model gives the elements back, signed and unsigned
    (unpack_np at 8 and 32 bits)."""
    n = (1 << 20) + 17
    x = _ints(max(n_bits, 2), n, n_bits)
    planes, st = _np_pack_kernel(x.astype(np.int32), n_bits,
                                 tops.PACK_TILE)
    ref = tbp.pack_np(x, n_bits, device=CPU)
    np.testing.assert_array_equal(planes, ref.to_numpy())
    assert st["load16"] == n // 4 and st["load4"] == n % 4
    low = x & ((1 << n_bits) - 1)
    for signed in (True, False):
        got, st = _np_unpack_kernel(planes, n, signed,
                                    tops.unpack_tile(n_bits))
        want = low - ((low >> (n_bits - 1)) << n_bits) if signed else low
        np.testing.assert_array_equal(got.view(_U32),
                                      want.astype(np.int64).astype(_U32))
        assert st["store16"] == n // 4 and st["store4"] == n % 4
        if n_bits in (8, 32):
            np.testing.assert_array_equal(
                got.view(_U32), tbp.unpack_np(tbp.BitPlaneArray(
                    ref.planes, n, signed)).astype(_U32))
