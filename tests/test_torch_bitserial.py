"""``repro_torch/kernels/bitserial_matmul`` against
``repro/kernels/bitserial_matmul``, on the CPU (the wrapper runs the plain
version for CPU tensors; the kernel itself is checked against it on the
card in ``test_torch_cuda.py``).  Inputs come from numpy with a seed.

Tolerances:
  * the raw product, ``quantize_weights`` and ``quantize_activations``:
    bit-exact (integer sums; the same float32 operations in the same
    order, round half to even on both sides);
  * ``bitserial_matmul``, ``QuantizedLinear`` and ``ref_quantized_matmul``:
    1e-6 relative — the int32 sums are equal, and only the float32
    epilogue (two products by the scales) may round in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitserial_matmul import QuantizedLinear as JQuantizedLinear
from repro.kernels.bitserial_matmul import bitserial_matmul as j_bitserial
from repro.kernels.bitserial_matmul import quantize_activations as j_quant_act
from repro.kernels.bitserial_matmul import quantize_weights as j_quant_w
from repro.kernels.bitserial_matmul.kernel import bsmm_raw as j_bsmm_raw
from repro.kernels.bitserial_matmul.ref import ref_bsmm_raw as j_ref_bsmm
from repro.kernels.bitserial_matmul.ref import \
    ref_quantized_matmul as j_ref_qmm
from repro_torch.kernels.bitserial_matmul import ops, ref

REL = dict(rtol=1e-6, atol=0)
#: test_kernels.py's grid, then ragged shapes and the decode batches M = 1, 4
SHAPES = [(128, 128, 128), (256, 128, 384), (5, 70, 33), (1, 128, 256),
          (4, 70, 33)]


def _operands(shape, n_bits, seed):
    M, K, N = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(0, 2, (n_bits, K, N)).astype(np.int8)
    return x, w


def _pallas_bsmm(x, w):
    """The Pallas kernel (interpret mode) on inputs zero-padded to its
    128-multiples, cut back to [M, N]."""
    M, K = x.shape
    N = w.shape[2]
    pm, pk, pn = -M % 128, -K % 128, -N % 128
    xp = np.pad(x, ((0, pm), (0, pk)))
    wp = np.pad(w, ((0, 0), (0, pk), (0, pn)))
    return np.asarray(j_bsmm_raw(jnp.asarray(xp), jnp.asarray(wp)))[:M, :N]


@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bsmm_equals_pallas_kernel_and_ref(shape, n_bits):
    x, w = _operands(shape, n_bits, seed=n_bits)
    before = ops.bsmm_packed.launches
    got = ops.bsmm_raw(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and ops.bsmm_packed.launches == before
    np.testing.assert_array_equal(got.numpy(), _pallas_bsmm(x, w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref_bsmm(jnp.asarray(x), jnp.asarray(w))))


def test_plain_bsmm_wraps_like_int32():
    """|x @ u| above 2^31 wraps modulo 2^32 in the reference's int32
    arithmetic; the plain version's float64 sums are exact and wrap the
    same way on the cast."""
    x = np.full((2, 70_000), 127, np.int8)
    x[1] = -128
    w = np.ones((8, 70_000, 3), np.int8)
    got = ref.ref_bsmm_raw(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(j_ref_bsmm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = x.astype(np.int64).sum(1, keepdims=True) * 255
    assert np.abs(exact).max() > 2 ** 31
    np.testing.assert_array_equal(got.numpy()[:, :1],
                                  exact.astype(np.int32))


@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(200, 120), (70, 33)])
def test_quantize_weights_bit_exact(shape, n_bits):
    rng = np.random.default_rng(n_bits)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0                         # a zero column: scale clamps
    w[0, 5] = 2.5 * np.abs(w[:, 5]).max()  # one outlier per column
    jp, js = j_quant_w(jnp.asarray(w), n_bits)
    tp, ts = ops.quantize_weights(torch.from_numpy(w), n_bits)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert set(np.unique(tp.numpy())) <= {0, 1}


@pytest.mark.parametrize("shape", [(17, 200), (2, 5, 70), (1, 33)])
def test_quantize_activations_bit_exact(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0     # an all-zero row
    jx, js = j_quant_act(jnp.asarray(x))
    tx, ts = ops.quantize_activations(torch.from_numpy(x))
    assert tx.dtype == torch.int8
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("shape", [(17, 200, 120), (5, 70, 33)])
def test_bitserial_matmul_matches_reference(shape, n_bits):
    M, K, N = shape
    rng = np.random.default_rng(M + n_bits)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    xi, xs = j_quant_act(jnp.asarray(x))
    wp, ws = j_quant_w(jnp.asarray(w), n_bits)
    want = np.asarray(j_bitserial(xi, xs, wp, ws))
    t = [torch.from_numpy(np.asarray(a)) for a in (xi, xs, wp, ws)]
    got = ops.bitserial_matmul(*t)
    np.testing.assert_allclose(got.numpy(), want, **REL)
    # the dequantized reference from the signed weights gives it too
    zero = 1 << (n_bits - 1)
    wq = sum(np.asarray(wp)[b].astype(np.int32) << b
             for b in range(n_bits)) - zero
    args = (np.asarray(xi), np.asarray(xs), wq, np.asarray(ws))
    np.testing.assert_allclose(
        ref.ref_quantized_matmul(*map(torch.from_numpy, args), zero).numpy(),
        np.asarray(j_ref_qmm(*map(jnp.asarray, args), zero)), **REL)
    np.testing.assert_allclose(
        ref.ref_quantized_matmul(*map(torch.from_numpy, args), zero).numpy(),
        got.numpy(), **REL)


@pytest.mark.parametrize("n_bits", [4, 8])
def test_quantized_linear_matches_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    w = rng.standard_normal((200, 120)).astype(np.float32)
    x = rng.standard_normal((2, 9, 200)).astype(np.float32)
    jql = JQuantizedLinear.from_dense(jnp.asarray(w), n_bits=n_bits)
    tql = ops.QuantizedLinear.from_numpy(np.asarray(jql.w_planes),
                                        np.asarray(jql.w_scale),
                                        device="cpu")
    assert isinstance(tql, torch.nn.Module)
    assert {n for n, _ in tql.named_buffers()} == {"w_packed", "w_scale"}
    y = tql(torch.from_numpy(x))
    assert y.shape == (2, 9, 120) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jql(jnp.asarray(x))),
                               **REL)
    dense = ops.QuantizedLinear.from_dense(torch.from_numpy(w), n_bits)
    np.testing.assert_array_equal(dense.w_planes.numpy(),
                                  np.asarray(jql.w_planes))
    np.testing.assert_array_equal(dense.w_scale.numpy(),
                                  np.asarray(jql.w_scale))
    assert tql.hbm_bytes == dense.hbm_bytes == jql.hbm_bytes
    # the accuracy bound of test_kernels.py holds for the port as well
    ref_y = x @ w
    rel = np.abs(y.numpy() - ref_y).max() / np.abs(ref_y).max()
    assert rel < (0.02 if n_bits == 8 else 0.2), rel


def test_wrapper_takes_cpu_or_cuda_only():
    x = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 4, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.bsmm_raw(x, w)
    if not torch.cuda.is_available():     # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.QuantizedLinear.from_numpy(np.zeros((2, 4, 3), np.int8),
                                           np.ones(3, np.float32))


# -- the packed plane layout and the kernel's arithmetic on it -----------------
PACK_KS = [0, 1, 31, 32, 33, 70, 130, 2048]


def _ref_planes(K, N, n_bits, seed):
    """The reference's planes of a random [K, N] weight (numpy zeros at
    K = 0, which the reference's quantizer cannot take)."""
    if K == 0:
        return np.zeros((n_bits, 0, N), np.int8)
    w = np.random.default_rng(seed).standard_normal((K, N))
    return np.asarray(j_quant_w(jnp.asarray(w.astype(np.float32)),
                                n_bits)[0])


def _np_pack(planes):
    """numpy's own packing: bit j of word [b, n, w] is planes[b, 32 w + j,
    n], as uint32."""
    nb, K, N = planes.shape
    kw = -(-K // 32)
    bits = np.zeros((nb, N, 32 * kw), np.uint8)
    bits[:, :, :K] = planes.transpose(0, 2, 1)
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


@pytest.mark.parametrize("K", PACK_KS)
@pytest.mark.parametrize("n_bits", range(1, 9))
def test_pack_planes_round_trips_reference_planes(n_bits, K):
    planes = _ref_planes(K, 5, n_bits, seed=K + n_bits)
    packed = ref.pack_planes(torch.from_numpy(planes))
    assert packed.dtype == torch.int32 and packed.shape == (n_bits, 5,
                                                            -(-K // 32))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  _np_pack(planes))
    np.testing.assert_array_equal(ref.unpack_planes(packed, K).numpy(),
                                  planes)


@pytest.mark.parametrize("K", [1, 31, 33, 70, 130])
def test_pack_planes_zeroes_the_bits_past_k(K):
    """All-ones planes: the last word holds exactly K % 32 low bits."""
    packed = ref.pack_planes(torch.ones((8, K, 3), dtype=torch.int8))
    words = packed.numpy().view(np.uint32)
    assert (words[..., :-1] == 0xFFFFFFFF).all()
    assert (words[..., -1] == (1 << (K % 32)) - 1).all()


def _np_byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) on uint32 arrays."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
          [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
               for i in range(4)).astype(np.uint32)


def _np_expand32(p):
    """numpy model of ``csrc/bitserial_matmul.cu::expand32``: 8 plane words
    (uint32 [8, ...], planes past n_bits zero) → the 8 u words of those
    32 k, step by step as the kernel computes them."""
    u32 = np.uint32

    def byte_transpose4(p0, p1, p2, p3):
        t0, t1 = _np_byte_perm(p0, p1, 0x5140), _np_byte_perm(p2, p3, 0x5140)
        t2, t3 = _np_byte_perm(p0, p1, 0x7362), _np_byte_perm(p2, p3, 0x7362)
        return [_np_byte_perm(t0, t1, 0x5410), _np_byte_perm(t0, t1, 0x7632),
                _np_byte_perm(t2, t3, 0x5410), _np_byte_perm(t2, t3, 0x7632)]

    def swap_half(v):
        t = (v ^ (v >> u32(7))) & u32(0x00AA00AA)
        v = v ^ t ^ (t << u32(7))
        t = (v ^ (v >> u32(14))) & u32(0x0000CCCC)
        return v ^ t ^ (t << u32(14))

    a, c = byte_transpose4(*p[:4]), byte_transpose4(*p[4:])
    out = []
    for y in range(4):
        lo, hi = swap_half(a[y]), swap_half(c[y])
        t = (lo ^ (hi << u32(4))) & u32(0xF0F0F0F0)
        out += [lo ^ t, hi ^ (t >> u32(4))]
    return np.stack(out)


@pytest.mark.parametrize("n_bits", range(1, 9))
def test_kernel_expansion_model_equals_u(n_bits):
    """The kernel turns the packed words of 32 k of one column into u =
    Σ_b W_b << b, byte t of u word i being k = 4 i + t: the word dp4a
    multiplies with four x bytes."""
    planes = _ref_planes(130, 7, n_bits, seed=n_bits)
    words = _np_pack(planes)                       # [n_bits, N, 5]
    p = np.zeros((8,) + words.shape[1:], np.uint32)
    p[:n_bits] = words
    got = _np_expand32(p)                          # [8, N, 5]: word i
    u = sum(planes[b].astype(np.uint32) << b for b in range(n_bits))
    up = np.zeros((32 * 5, 7), np.uint32)
    up[:130] = u
    # u word i of packed word w: bytes u[32 w + 4 i + t], t = 0..3
    want = (up.reshape(5, 8, 4, 7) << (8 * np.arange(4, dtype=np.uint32)
                                       )[None, None, :, None]).sum(2)
    np.testing.assert_array_equal(got, want.transpose(1, 2, 0))


@pytest.mark.parametrize("n_bits", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES + [(3, 31, 7), (2, 33, 5)])
def test_packed_entry_plain_equals_pallas_kernel(shape, n_bits):
    """The entry's CPU plain version on packed planes equals the
    reference's kernel (interpret mode), ragged K included."""
    x, w = _operands(shape, n_bits, seed=10 + n_bits)
    before = ops.bsmm_packed.launches
    got = ops.bsmm_packed(torch.from_numpy(x),
                          ref.pack_planes(torch.from_numpy(w)))
    assert ops.bsmm_packed.launches == before
    np.testing.assert_array_equal(got.numpy(), _pallas_bsmm(x, w))


@pytest.mark.parametrize("M,K,N,sms", [
    (128, 2048, 11008, 132), (128, 11008, 2048, 132), (1, 11008, 2048, 132),
    (64, 4000, 256, 132), (128, 11008, 2048, 114), (1024, 1024, 4096, 132),
    (128, 128, 128, 132), (5, 70, 33, 132), (3, 0, 5, 132), (2, 1, 9, 4),
    (8, 4000, 16, 4)])
def test_split_k_cuts_k_into_whole_chunks(M, K, N, sms):
    """S > 1 only where the tiles give fewer than 2 blocks per SM; then S
    slices of whole 4-word chunks, each of at least MIN_SLICE_CHUNKS, cover
    the packed words once, none empty, and the products of the slices add
    up to the whole, modulo 2^32."""
    splits, words = ops.split_k(M, N, K, sms)
    kw = -(-K // 32)
    tiles = -(-M // ops.BM) * -(-N // ops.BN)
    assert words % ops.CHUNK_WORDS == 0 and splits >= 1
    assert (splits - 1) * words < max(kw, 1) <= splits * words or kw == 0
    if splits > 1:
        assert tiles < ops.BLOCKS_PER_SM * sms
        assert words // ops.CHUNK_WORDS >= ops.MIN_SLICE_CHUNKS
    if (M, K, N, sms) in [(128, 2048, 11008, 132), (128, 11008, 2048, 132)]:
        assert splits == {2048: 3, 11008: 8}[K]      # the main path's S
    if (M, K, N, sms) == (8, 4000, 16, 4):
        assert splits > 1
    if K and M * N <= 4096:
        rng = np.random.default_rng(M + K)
        x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
        w = torch.from_numpy(rng.integers(0, 2, (8, K, N)).astype(np.int8))
        parts = sum(ref.ref_bsmm_raw(x[:, 32 * words * z:32 * words * (z + 1)],
                                     w[:, 32 * words * z:32 * words * (z + 1)]
                                     ).to(torch.int64)
                    for z in range(splits))
        assert torch.equal(parts.to(torch.int32), ref.ref_bsmm_raw(x, w))


@pytest.mark.parametrize("K", [64, 96, 200, 70])
def test_quantized_linear_stores_packed_planes(K):
    """Only the packed words and the scales are stored; ``w_planes`` reads
    back the reference's planes after ``from_numpy`` and ``from_dense``;
    ``stored_bytes`` equals ``hbm_bytes`` where K is a multiple of 32."""
    rng = np.random.default_rng(K)
    w = rng.standard_normal((K, 40)).astype(np.float32)
    jql = JQuantizedLinear.from_dense(jnp.asarray(w), n_bits=8)
    planes = np.asarray(jql.w_planes)
    for ql in (ops.QuantizedLinear.from_numpy(planes,
                                              np.asarray(jql.w_scale),
                                              device="cpu"),
               ops.QuantizedLinear.from_dense(torch.from_numpy(w), 8)):
        assert {n for n, _ in ql.named_buffers()} == {"w_packed", "w_scale"}
        assert ql.in_features == K and ql.w_packed.shape == (8, 40,
                                                             -(-K // 32))
        np.testing.assert_array_equal(ql.w_packed.numpy().view(np.uint32),
                                      _np_pack(planes))
        np.testing.assert_array_equal(ql.w_planes.numpy(), planes)
        assert ql.hbm_bytes == jql.hbm_bytes
        assert ql.stored_bytes == 4 * (8 * 40 * -(-K // 32) + 40)
        assert (ql.stored_bytes == ql.hbm_bytes) == (K % 32 == 0)
