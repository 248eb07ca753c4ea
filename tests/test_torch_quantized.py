"""The quantized LM path of the port against the reference: the serving
quantization (``models/quantized.py``), the model on a quantized params
tree, ``forward_train``, the synthetic data, and the bit-plane example
(``examples/simdram_quantized_lm.py``), all on the CPU.

Tolerances:
  * ``q8`` and ``s`` of ``quantize_serving_params``, the data and the byte
    figures: exact;
  * logits, dense or quantized: 1e-4 absolute and relative, as in
    ``test_torch_model.py`` — float32 layers summed in another order by the
    two frameworks.  The int8 dots themselves are exact; an activation whose
    int8 code flips moves one term of one dot (measured here: at most
    1.5e-6 on logits of magnitude 3-5);
  * the example's bit-plane logits: 1e-4 at all but at most 2 of the 128
    positions.  Its activations are quantized per row at every FFN matmul,
    and an activation within float32 rounding of a .5 code boundary rounds
    to another int8 code in the other framework (seen: x/scale = 30.500021
    at batch 1, token 12, from inputs 4.5e-7 apart); that position then
    differs by up to 1e-2 (seen: 8.4e-3);
  * the example's perplexities: 1e-4 relative (seen: 2.1e-5, the flipped
    position's share of the mean), so its drift in %: 1e-2 (seen: 1.9e-3).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, one_torch_thread
from repro.configs import smoke_config as j_smoke_config
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData
from repro.kernels.bitserial_matmul import QuantizedLinear as JQuantizedLinear
from repro.models import model as jm
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.quantized import is_quantized as j_is_quantized
from repro.models.quantized import quantize_serving_params as j_quantize
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.examples import simdram_quantized_lm as example
from repro_torch.models import model as tm
from repro_torch.models.quantized import (is_quantized, qmm,
                                          quantize_serving_params)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-0.6b", "qwen2.5-3b", "nemotron-4-340b"]


def _pairs(jt, tt, path=()):
    """(path, JAX leaf or {q8, s}, port leaf or {q8, s}) over both trees."""
    if j_is_quantized(jt) or not isinstance(jt, (dict, list, tuple)):
        yield path, jt, tt
    elif isinstance(jt, dict):
        assert set(jt) == set(tt), path
        for k in jt:
            yield from _pairs(jt[k], tt[k], path + (k,))
    else:
        assert len(jt) == len(tt), path
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _pairs(a, b, path + (i,))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_serving_params_matches_reference(arch):
    cfg, jp, tp = bridged(arch)
    jq, tq = j_quantize(jp), quantize_serving_params(tp)
    n_q = 0
    for (path, j, t), (_, _, orig) in zip(_pairs(jq, tq), _pairs(jq, tp)):
        assert j_is_quantized(j) == is_quantized(t), path
        if is_quantized(t):
            n_q += 1
            assert t["q8"].dtype == torch.int8, path
            np.testing.assert_array_equal(t["q8"].numpy(),
                                          np.asarray(j["q8"]), err_msg=path)
            np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]),
                                          err_msg=path)
        else:
            assert t is orig, path                # untouched, not copied
    # wq wk wv wo w1 w2 (w3 for swiglu) and an untied lm_head
    assert n_q == 6 + (cfg.act == "swiglu") + (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_prefill_and_decode_match_reference(arch):
    """The reference serves a quantize_serving_params tree through qmm in
    every projection; the port's prefill and decode_step do the same."""
    cfg, jp, tp = bridged(arch)
    jq, tq = j_quantize(jp), quantize_serving_params(tp)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 6)
                                             ).astype(np.int32)
    jl, jc = jm.prefill(cfg, jq, {"tokens": jnp.asarray(toks)}, 10)
    tl, tc = tm.prefill(cfg, tq, {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.array(jnp.argmax(jl[:, 0], -1))
    for pos in range(6, 10):
        jl, jc = jm.decode_step(cfg, jq, jc, jnp.asarray(nxt)[:, None],
                                jnp.int32(pos))
        tl, tc = tm.decode_step(cfg, tq, tc, torch.from_numpy(nxt)[:, None],
                                pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"pos {pos}")
        nxt = np.array(jnp.argmax(jl[:, 0], -1))
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), nxt)


def test_qmm_matches_reference_on_odd_shapes():
    """qmm on a 3-D input whose widths are not multiples of 8."""
    from repro.models.quantized import qmm as j_qmm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 13)).astype(np.float32)
    w = rng.standard_normal((13, 7)).astype(np.float32)
    jw = j_quantize({"w1": jnp.asarray(w)})["w1"]
    tw = quantize_serving_params({"w1": torch.from_numpy(w)})["w1"]
    got = qmm(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 7)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_qmm(jnp.asarray(x), jw)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch, quantized):
    cfg, jp, tp = bridged(arch)
    if quantized:
        jp, tp = j_quantize(jp), quantize_serving_params(tp)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 9)
                                              ).astype(np.int32)
    want = np.asarray(jm.forward_train(cfg, jp, {"tokens":
                                                 jnp.asarray(toks)}))
    got = tm.forward_train(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 9, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_synthetic_data_matches_reference():
    cfg = example.config(smoke=True)
    for seed, step in ((0, 0), (0, 3), (5, 1)):
        a = SyntheticLMData(cfg, 4, 32, seed).batch_at(step)
        b = JSyntheticLMData(cfg, 4, 32, seed).batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _reference_example(params, tokens, labels):
    """The reference example's computation from JAX's public functions on
    the port's params: its config, dense forward, bit-plane q_forward and
    perplexities."""
    cfg = dataclasses.replace(j_smoke_config("qwen2.5-3b"), n_layers=4,
                              param_dtype="float32",
                              compute_dtype="float32")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    stacked = jp["stages"][0][0]
    qls, dense_bytes, plane_bytes = [], 0, 0
    for li in range(cfg.n_layers):
        lp = jax.tree.map(lambda x: x[li], stacked)
        q = {k: JQuantizedLinear.from_dense(lp["mlp"][k], n_bits=8)
             for k in ("w1", "w2", "w3")}
        qls.append(q)
        for k in ("w1", "w2", "w3"):
            dense_bytes += lp["mlp"][k].size * 2
            plane_bytes += q[k].hbm_bytes
    x = jp["embed"][batch["tokens"]].astype(jnp.float32)
    for li in range(cfg.n_layers):
        lp = jax.tree.map(lambda v: v[li], stacked)
        h = j_rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + jm._self_attn_train(JLayerSpec("attn"), cfg, lp["attn"], h)
        h2 = j_rms_norm(x, lp["ln2"], cfg.norm_eps)
        q = qls[li]
        x = x + q["w2"](jax.nn.silu(q["w1"](h2)) * q["w3"](h2))
    x = j_rms_norm(x, jp["final_norm"], cfg.norm_eps)
    q_logits = x @ jp["lm_head"]

    def ppl(logits):
        lse = jax.nn.logsumexp(logits, -1)
        ll = jnp.take_along_axis(logits, batch["labels"][..., None],
                                 -1)[..., 0]
        return float(jnp.exp((lse - ll).mean()))

    ref_logits = jm.forward_train(cfg, jp, batch)
    return dict(cfg=cfg, qls=qls, dense_bytes=dense_bytes,
                plane_bytes=plane_bytes, ppl_ref=ppl(ref_logits),
                ppl_q=ppl(q_logits), ref_logits=ref_logits,
                q_logits=q_logits)


def test_smoke_example_matches_reference_computation():
    res = example.main(device="cpu", smoke=True)
    want = _reference_example(res["params"], res["tokens"].numpy(),
                              res["labels"].numpy())
    assert dataclasses.asdict(res["cfg"]) == dataclasses.asdict(want["cfg"])
    for tq, jq in zip(res["qls"], want["qls"]):
        for k in ("w1", "w2", "w3"):
            np.testing.assert_array_equal(tq[k].w_planes.numpy(),
                                          np.asarray(jq[k].w_planes))
            np.testing.assert_array_equal(tq[k].w_scale.numpy(),
                                          np.asarray(jq[k].w_scale))
    assert res["dense_bytes"] == want["dense_bytes"]
    assert res["plane_bytes"] == want["plane_bytes"]
    assert res["stored_plane_bytes"] == sum(             # packed words
        4 * q[k].w_planes.shape[0] * q[k].w_planes.shape[2]
        * -(-q[k].w_planes.shape[1] // 32) for q in want["qls"] for k in q)
    np.testing.assert_allclose(res["ref_logits"].numpy(),
                               np.asarray(want["ref_logits"]), **TOL)
    got, ref_q = res["q_logits"].numpy(), np.asarray(want["q_logits"])
    np.testing.assert_allclose(got, ref_q, atol=1e-2, rtol=0)
    close = np.isclose(got, ref_q, **TOL).all(-1)
    assert (~close).sum() <= 2, np.argwhere(~close).tolist()
    for key in ("ppl_ref", "ppl_q"):
        assert res[key] == pytest.approx(want[key], rel=1e-4)
    drift = abs(want["ppl_q"] - want["ppl_ref"]) / want["ppl_ref"] * 100
    # the drift in % moves by 100x the perplexities' relative tolerance
    assert res["drift"] == pytest.approx(drift, abs=1e-2)
    assert res["drift"] < example.MAX_DRIFT


def test_example_command_line():
    """The module's command line: --device cpu runs the smoke config."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.simdram_quantized_lm",
         "--device", "cpu", "--smoke"], cwd=ROOT, capture_output=True,
        text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "qwen2.5-3b-smoke on cpu" in out.stdout
    assert "bit-planes as stored" in out.stdout


def test_example_published_config():
    cfg = example.config(smoke=False)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.qkv_bias, cfg.tie_embeddings) == (
        36, 2048, 16, 2, 128, 11008, 151936, True, False)
    assert cfg.param_dtype == cfg.compute_dtype == "float32"
