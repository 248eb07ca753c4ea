"""The legacy per-sequence serve path in the port
(``serve/paged.py::PagedServer``,
``kernels/paged_attention/ops.py::paged_decode_attention``, the
launcher's ``--legacy``) against the reference's and against the port's
engine.

  * ``PagedServer`` logits equal the reference ``PagedServer``'s over 7
    ragged steps that cross page boundaries (page size 4, slots 0 and 2:
    ``tests/test_serve_engine.py::test_decode_batch_matches_legacy``'s
    schedule), and the port's ``PagedEngine``'s on the same schedule;
  * ``PagedServer`` against ``forward_train`` with untied embeddings
    (``tests/test_system.py::test_paged_serving_matches_dense_decode``);
  * ``paged_decode_attention`` against the reference's (interpret mode)
    on a seeded state, ``seq_ids`` out of order and ``max_pages`` below
    the row width;
  * ``main(["--legacy", ...])`` gives the engine launcher's generations
    token for token, and every usage error around ``--legacy`` exits with
    its message.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, one_torch_thread  # noqa: F401
from repro.core.vbi.kvcache import PagedKVState as RefKVState
from repro.kernels.paged_attention import \
    paged_decode_attention as ref_paged_decode_attention
from repro.serve.paged import PagedServer as RefServer
from repro_torch.configs import smoke_config
from repro_torch.core.vbi.kvcache import PagedKVState
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.paged import PagedServer

#: logits, port against reference and against the port's engine (the
#: reference's own bound for engine vs legacy, tests/test_serve_engine.py;
#: readings at most 2.26e-6 and 1.79e-6)
TOL = 1e-5
#: paged_decode_attention against the reference's (reading 3.6e-7)
ATTN_TOL = 1e-6


def _schedule(cfg, serve_fn):
    """The reference's ragged schedule: slots 0 and 2, 7 steps of seeded
    token pairs; ``serve_fn(pair)`` → logits [2, V] per step."""
    rng = np.random.default_rng(1)
    return [serve_fn(rng.integers(0, cfg.vocab, 2)) for _ in range(7)]


def test_paged_server_matches_reference():
    """Port and reference ``PagedServer`` on the same weights: logits
    within ``TOL`` at every step (reading 2.26e-6), and the VBI stats (page
    promotions and delayed allocations) equal."""
    cfg, jp, tp = bridged("qwen3-0.6b")
    ref = RefServer(cfg, jp, n_pages=64, page_size=4, max_seqs=4)
    srv = PagedServer(cfg, tp, n_pages=64, page_size=4, max_seqs=4,
                      device="cpu")
    for s in (0, 2):
        ref.admit(s)
        srv.admit(s)
    want = _schedule(cfg, lambda pair: np.asarray(ref.decode(
        jnp.asarray(pair, jnp.int32)[:, None], [0, 2]))[:, 0])
    got = _schedule(cfg, lambda pair: srv.decode(
        torch.tensor(pair, dtype=torch.int32)[:, None], [0, 2])[:, 0])
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL,
                                   err_msg=f"step {step}")
    assert srv.kv.stats == ref.kv.stats
    assert srv.kv.stats["promotions"] == 2       # 7 tokens > one 4-token page
    np.testing.assert_array_equal(srv.kv.state.seq_lens.numpy(),
                                  np.asarray(ref.kv.state.seq_lens))


def test_paged_server_matches_engine():
    """The port's legacy server against the port's engine on the same
    schedule, within the reference's 1e-5 (reading 1.79e-6: the engine's
    batched step sums in other shapes)."""
    cfg, _, tp = bridged("qwen3-0.6b")
    srv = PagedServer(cfg, tp, n_pages=64, page_size=4, max_seqs=4,
                      device="cpu")
    eng = PagedEngine(cfg, tp, n_pages=64, page_size=4, max_seqs=4,
                      max_pages_per_seq=8, device="cpu")
    for s in (0, 2):
        srv.admit(s)
        eng.alloc.alloc(s)
    mask = torch.tensor([True, False, True, False])

    def batched(pair):
        full = torch.zeros(4, dtype=torch.int32)
        full[0], full[2] = int(pair[0]), int(pair[1])
        return eng.decode(full, mask)[[0, 2], 0]

    got = _schedule(cfg, lambda pair: srv.decode(
        torch.tensor(pair, dtype=torch.int32)[:, None], [0, 2])[:, 0])
    for step, (a, b) in enumerate(zip(got, _schedule(cfg, batched))):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL,
                                   msg=f"step {step}")


def test_paged_server_matches_forward_train():
    """tests/test_system.py:85-102 on the port: the legacy server's logits
    at each of 6 positions within 2e-3 / 1e-3 of one ``forward_train``
    over the whole sequence (page size 2, so pages are allocated as
    tokens arrive)."""
    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"),
                              param_dtype="float32",
                              compute_dtype="float32", tie_embeddings=False)
    p = tm.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 6))
    t = torch.from_numpy(toks).int()
    full = tm.forward_train(cfg, p, {"tokens": t, "labels": t})
    srv = PagedServer(cfg, p, n_pages=32, page_size=2, max_seqs=4,
                      device="cpu")
    srv.admit(0)
    srv.admit(1)
    for i in range(6):
        lg = srv.decode(t[:, i:i + 1], [0, 1])
        torch.testing.assert_close(lg[:, 0], full[:, i], atol=2e-3,
                                   rtol=1e-3)
    assert srv.kv.stats["delayed_page_allocs"] > 0


def test_paged_decode_attention_matches_reference():
    """A seeded 2-layer state (16 pages of 4, 2 kv heads of 16, 4 rows of
    8 pages, lengths 5, 1, 13, 9): sequences [2, 0, 3] out of row order,
    the first 4 columns of each row, against the reference's kernel in
    interpret mode; the default (rows 0..b-1, every column) too."""
    rng = np.random.default_rng(3)
    shape = (2, 16, 4, 2, 16)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, 16))[:8]
                      for _ in range(4)]).astype(np.int32)
    lens = np.asarray([5, 1, 13, 9], np.int32)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    ref_state = RefKVState(*(jnp.asarray(a) for a in (k, v, table, lens)))
    state = PagedKVState(*(torch.from_numpy(a) for a in (k, v, table,
                                                          lens)))
    for layer in (0, 1):
        for ids, mp in (([2, 0, 3], 4), (None, None)):
            want = ref_paged_decode_attention(
                jnp.asarray(q), ref_state, layer, n_kv=2,
                seq_ids=None if ids is None else jnp.asarray(ids),
                max_pages=mp, interpret=True)
            got = paged_decode_attention(torch.from_numpy(q), state, layer,
                                         n_kv=2, seq_ids=ids, max_pages=mp)
            assert got.shape == (3, 4, 16) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATTN_TOL)


def test_paged_server_refuses_mixed_stacks():
    cfg, _, tp = bridged("gemma3-12b")
    with pytest.raises(ValueError, match="uniform GQA"):
        PagedServer(cfg, tp, device="cpu")


@pytest.mark.parametrize("extra", [
    [], ["--requests", "5", "--max-new", "12", "--batch-slots", "2",
         "--prompt-len", "7", "--seed", "3"],
    ["--shared-prefix", "9", "--batch-slots", "3"]])
def test_legacy_launcher_matches_engine_launcher(extra):
    """The verify skill's contract: ``--legacy`` generations equal the
    engine launcher's token for token at the same seed."""
    base = ["--device", "cpu"] + extra
    legacy, srv, sched = tserve.main(base + ["--legacy"])
    engine, eng, _ = tserve.main(base)
    assert isinstance(srv, PagedServer) and sched is None
    assert {r.rid: r.out for r in legacy} == {r.rid: r.out for r in engine}
    assert {r.rid: r.prompt for r in legacy} == \
        {r.rid: r.prompt for r in engine}
    assert srv.kv.pages_in_use == 0                # every request evicted


@pytest.mark.parametrize("extra,msg", [
    (["--traffic", "poisson"], "--traffic/--overlap"),
    (["--overlap"], "--traffic/--overlap"),
    (["--trace", "t.jsonl"], "--trace/--metrics"),
    (["--metrics"], "--trace/--metrics"),
    (["--disagg"], "--disagg needs"),
    (["--faults"], "--faults needs"),
    (["--fault-model", "simdram:node=22"], "--faults needs"),
    (["--mesh-shape", "1x1"], "--mesh-shape needs"),
    (["--arch", "gemma3-12b"], "uniform dense"),
    (["--arch", "mixtral-8x7b"], "uniform dense"),
    (["--arch", "recurrentgemma-9b"], "uniform dense"),
    (["--arch", "mamba2-1.3b"], "uniform dense")])
def test_legacy_usage_errors(extra, msg, capsys):
    """Each of the reference's usage errors around ``--legacy``
    (``repro/launch/serve.py:199-217,240-245``): exit 2, its message."""
    with pytest.raises(SystemExit) as e:
        tserve.main(["--device", "cpu", "--legacy"] + extra)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert msg in err and "--legacy" in err

