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
    before = ops.bsmm_raw.launches
    got = ops.bsmm_raw(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and ops.bsmm_raw.launches == before
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
    assert {n for n, _ in tql.named_buffers()} == {"w_planes", "w_scale"}
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
