"""The step cost walker (``repro_torch/distributed/hlo_cost.py``) and the
roofline (``hlo_analysis.py``) against the reference's HLO walker.

The reference's ``tests/test_hlo_cost.py`` cases in torch: the matmul's
FLOPs exact, loops' trips multiplied in (eager PyTorch runs a body once a
trip, so the walker counts what ran), the loop report listing trips,
``0 < bytes_min <= bytes``.  Then qwen3-0.6b at full width cut to 2
layers, float32, on one device: the walker's FLOPs of the train, prefill
and decode steps (traced on meta) against the reference's ``analyze_hlo``
of the same jitted steps.

Tolerances, each with its reason: the matmul FLOPs are exact; the train,
prefill and decode steps within ``STEP_RTOL`` (matmuls agree exactly; the
elementwise and reduction counts differ because XLA fuses and rewrites
them and the walker counts each dispatched op: readings 1.0e-3, 5.2e-4
and 9.0e-5).  The port's prefill writes the caches from
the k and v its attention computed (``models/model.py::_prefill_kv``), one
q/k/v projection a layer, as XLA's common-subexpression pass leaves the
reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.distributed.hlo_cost import analyze_hlo
from repro.distributed.hlo_cost import comms_share as ref_comms_share
from repro.models import model as jm
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch.configs import get_config
from repro_torch.distributed import hlo_cost
from repro_torch.distributed.hlo_analysis import (HBM_BW, ICI_BW,
                                                  PEAK_FLOPS, Roofline,
                                                  collective_bytes,
                                                  roofline_from_step)
from repro_torch.launch.mesh import CountingMesh
from repro_torch.launch.specs import batch_specs
from repro_torch.models.model import abstract_cache, abstract_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.step import abstract_train_state, make_train_step

#: walker vs reference FLOPs of a whole step (module doc)
STEP_RTOL = 1e-2
#: the 2-layer cut's batch, prompt and decode cache lengths
B, S, CACHE, POS = 2, 32, 64, 40


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    r = hlo_cost.analyze_step(lambda a, b: a @ b, _meta(256, 512),
                              _meta(512, 128))
    assert r["flops"] == 2 * 256 * 512 * 128


def test_loop_trip_count_multiplied():
    def f(x, w):
        with hlo_cost.loop("body", 24):
            for _ in range(24):
                x = torch.tanh(x @ w)
        return x

    r = hlo_cost.analyze_step(f, _meta(64, 64), _meta(64, 64))
    expect = 24 * 2 * 64 * 64 * 64
    assert abs(r["flops"] - expect) / expect < 0.02, r["flops"]


def test_nested_loop_trip_counts():
    def f(x, w):
        with hlo_cost.loop("outer", 7):
            for _ in range(7):
                with hlo_cost.loop("inner", 5):
                    for _ in range(5):
                        x = x @ w
        return x

    cost = hlo_cost.trace_step(f, _meta(32, 32), _meta(32, 32))
    expect = 7 * 5 * 2 * 32 ** 3
    assert abs(cost.flops - expect) / expect < 0.05, cost.flops
    rows = {r["body"]: r for r in cost.while_report()}
    assert rows["outer"]["trips"] == 7 and rows["inner"]["trips"] == 5
    assert rows["inner"]["enclosing_mult"] == 7
    assert rows["inner"]["body_flops"] == 2 * 32 ** 3
    assert rows["outer"]["body_flops"] == 5 * 2 * 32 ** 3


def test_while_report_lists_loops():
    def f(x):
        with hlo_cost.loop("body", 13):
            for _ in range(13):
                x = x * 2.0
        return x

    cost = hlo_cost.trace_step(f, _meta(8))
    assert 13.0 in [row["trips"] for row in cost.while_report()]


def test_stage_loops_list_the_stage_counts():
    """``run_stages`` opens one loop scope a stage: its trips are the
    stage's ``count`` and a trip's FLOPs one period's."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=3,
                              d_model=64, n_heads=4, n_kv=2, head_dim=16,
                              d_ff=128, vocab=256, compute_dtype="float32")
    step = make_prefill_step(cfg, 16)
    cost = hlo_cost.trace_step(step, abstract_params(cfg),
                               batch_specs(cfg, 2, 8))
    rows = cost.while_report()
    assert [r["trips"] for r in rows] == [st.count for st in cfg.stages()]
    assert rows[0]["body"] == "prefill stages[0]"
    assert 0 < rows[0]["body_flops"] * rows[0]["trips"] < cost.flops


def test_bytes_min_leq_bytes():
    r = hlo_cost.analyze_step(lambda a, b: torch.relu(a @ b).sum(),
                              _meta(128, 128), _meta(128, 128))
    assert 0 < r["bytes_min"] <= r["bytes"]


def test_comms_share_equals_the_reference():
    for coll, byts in ((0.0, 10.0), (3.0, 9.0), (5e9, 0.0), (1.0, 0.5)):
        rep = {"collectives": {"total": coll}, "bytes": byts}
        assert hlo_cost.comms_share(rep) == ref_comms_share(rep)


def test_collectives_by_the_reference_byte_rules():
    """A counting mesh's calls by HLO kind: an all-reduce 2x its result,
    a reduce-scatter its operand, an all-gather its result."""
    mesh = CountingMesh({"data": 2, "model": 4})
    x = _meta(8, 16)

    def f(x):
        y = mesh.all_reduce(x.clone(), "model")
        z = mesh.all_gather(y, 0, "model")
        return mesh.reduce_scatter(z, 1, "data")

    r = hlo_cost.analyze_step(f, x, mesh=mesh)
    nb = 8 * 16 * 4
    assert r["collectives"]["all-reduce"] == 2 * nb
    assert r["collectives"]["all-gather"] == 4 * nb
    assert r["collectives"]["reduce-scatter"] == 4 * nb
    assert r["collectives"]["total"] == 10 * nb
    assert r["collective_counts"]["all-gather"] == 1
    assert collective_bytes(mesh)["total"] == 10 * nb
    assert {k: v["calls"] for k, v in mesh.collectives.items()
            if v["calls"]} == {"all_reduce": 1, "all_gather": 1,
                               "reduce_scatter": 1}


def test_roofline_on_the_h100_constants():
    rl = roofline_from_step({"flops": 989e12, "bytes_min": 6.7e12,
                             "bytes": 7e12, "collectives": {"total": 5e10}},
                            256)
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 50e9)
    assert rl.compute_s == 1.0 and rl.memory_s == 2.0
    assert rl.collective_s == 1.0 and rl.bottleneck == "memory"
    assert rl.step_s == 2.0 and rl.chips == 256
    assert set(rl.as_dict()) == set(Roofline(1, 1, 1, 1).as_dict())


def test_a_kernel_launch_fails_the_trace(monkeypatch):
    """A ctypes launch is invisible to the dispatcher, so a trace that
    moved a launch counter fails rather than count short."""
    from repro_torch.kernels.paged_attention import ops as pa

    def launch(x):
        pa.paged_attention.launches += 1
        return x

    monkeypatch.setattr(pa.paged_attention, "launches", 0)
    with pytest.raises(RuntimeError, match="hand-written kernels"):
        hlo_cost.trace_step(launch, _meta(4))
    assert hlo_cost.active() is None


# --------------------------------------------------------------------------
# qwen3-0.6b at full width, 2 layers, float32: walker vs analyze_hlo
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cfgs():
    ref = dataclasses.replace(ref_get_config("qwen3-0.6b"), n_layers=2,
                              compute_dtype="float32")
    port = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                               compute_dtype="float32")
    return ref, port


def _ref_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _sds(shape, dt=jnp.int32):
    return jax.ShapeDtypeStruct(shape, dt)


def _rel(a, b):
    return abs(a - b) / b


def test_train_step_flops_match_the_reference(cfgs):
    ref, port = cfgs
    want = _ref_flops(jtrain.make_train_step(ref, RefAdamW()),
                      jtrain.abstract_train_state(ref, RefAdamW()),
                      {"tokens": _sds((B, S)), "labels": _sds((B, S))})
    got = hlo_cost.analyze_step(make_train_step(port, AdamWConfig()),
                                abstract_train_state(port, AdamWConfig()),
                                batch_specs(port, B, S))
    assert _rel(got["flops"], want) < STEP_RTOL, (got["flops"], want)
    assert 0 < got["bytes_min"] <= got["bytes"]


def test_prefill_flops_match_the_reference(cfgs):
    ref, port = cfgs
    want = _ref_flops(jserve.make_prefill_step(ref, max_len=S + 8),
                      jm.abstract_params(ref),
                      {"tokens": _sds((B, S)), "labels": _sds((B, S))})
    got = hlo_cost.analyze_step(make_prefill_step(port, S + 8),
                                abstract_params(port),
                                batch_specs(port, B, S))
    assert _rel(got["flops"], want) < STEP_RTOL, (got["flops"], want)


def test_decode_step_flops_match_the_reference(cfgs):
    ref, port = cfgs
    want = _ref_flops(jserve.make_decode_step(ref), jm.abstract_params(ref),
                      jm.abstract_cache(ref, B, CACHE), _sds((B, 1)),
                      _sds(()))
    got = hlo_cost.analyze_step(
        make_decode_step(port), abstract_params(port),
        abstract_cache(port, B, CACHE), _meta(B, 1, dtype=torch.int32), POS)
    assert _rel(got["flops"], want) < STEP_RTOL, (got["flops"], want)
