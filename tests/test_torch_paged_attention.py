"""The paged-attention kernel's plain twins on the CPU against the
reference's Pallas kernel, run in interpret mode as
``tests/test_kernels.py`` runs it.  The hand-written CUDA kernel itself is
held against the same twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Tolerance: 1e-5 absolute and relative (float32,
different summation order)."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_attn_one_seq
from repro_torch.kernels.paged_attention import (build_kernel,
                                                 paged_attention,
                                                 ref_paged_attention)
from repro_torch.serve.engine import batched_paged_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seq_len, n_kv, g, seed):
    n_pages, ps, dh = 12, 4, 8
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    pt = rng.choice(np.arange(1, n_pages), size=8,
                    replace=False).astype(np.int32)
    q = rng.standard_normal((n_kv, g, dh)).astype(np.float32)
    ln = np.array([seq_len], np.int32)
    return pt, ln, q, kp, vp


@pytest.mark.parametrize("seq_len", [0, 1, 5, 16, 31])
@pytest.mark.parametrize("gqa", [(2, 3), (1, 4), (4, 1)])
def test_plain_twins_match_pallas_kernel(seq_len, gqa):
    n_kv, g = gqa
    pt, ln, q, kp, vp = _case(seq_len, n_kv, g, seq_len * 10 + n_kv)
    ref = np.asarray(paged_attn_one_seq(*[jnp.asarray(x)
                                          for x in (pt, ln, q, kp, vp)]))
    t = [torch.from_numpy(x) for x in (pt, ln, q, kp, vp)]
    one = ref_paged_attention(*t)
    np.testing.assert_allclose(one.numpy(), ref, **TOL)
    # the batched forms: the wrapper (its CPU branch) and the engine twin,
    # with the row handed over wider than max_pages
    wide = torch.cat([t[0], torch.zeros(3, dtype=torch.int32)])[None]
    for fn in (paged_attention, batched_paged_attention):
        out = fn(t[2][None], t[3], t[4], wide, t[1], 8)
        np.testing.assert_allclose(out[0].numpy(), ref, **TOL)
    if seq_len == 0:
        assert not one.any()


def test_plain_twins_ignore_garbage_pages():
    """Entries beyond seq_len (incl. null page 0) must not affect output."""
    n_pages, ps, n_kv, g, dh = 6, 2, 1, 2, 4
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, n_kv, dh)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, n_kv, dh)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((n_kv, g, dh)).astype(np.float32))
    pt1 = torch.tensor([3, 1, 0, 0], dtype=torch.int32)
    pt2 = torch.tensor([3, 1, 5, 2], dtype=torch.int32)
    ln = torch.tensor([3], dtype=torch.int32)
    torch.testing.assert_close(ref_paged_attention(pt1, ln, q, kp, vp),
                               ref_paged_attention(pt2, ln, q, kp, vp),
                               atol=1e-6, rtol=0)
    for fn in (paged_attention, batched_paged_attention):
        torch.testing.assert_close(
            fn(q[None], kp, vp, pt1[None], ln, 4),
            fn(q[None], kp, vp, pt2[None], ln, 4), atol=1e-6, rtol=0)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_attention(q, q, q, q, q, 1)


def test_build_needs_the_cuda_toolkit():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build_kernel()
