"""The port's training stack against the reference's: ``optim/adamw.py``,
``train/step.py`` (gradient accumulation, ``bf16_params_in_compute``, the
``compress`` hook), ``train/loop.py``, ``data/pipeline.py``,
``launch/train.py`` and resume through the shared checkpoint format.

Tolerances, each with its reason:
  * AdamW alone on the same params and gradients: params 1e-6 absolute
    (float32 math); float32 moments 1e-5 relative (the clip scale divides
    by a norm summed in another order, and ``b1·m + (1 - b1)·g`` can
    cancel: one element of 30 was 1.07e-6 off); bfloat16 moments one
    bfloat16 step (2^-7 relative: a float32 value a rounding apart in the
    two frameworks may round to either neighbour);
  * one train step, ``grad_accum`` 1 against 4 and the port against the
    reference: the reference's ``test_grad_accum_matches_full_batch``
    bounds, loss 1e-4 and params 5e-5; with ``bf16_params_in_compute`` at
    bfloat16 compute the loss within 2e-3 (bfloat16 weights, 8 bits).
    The params bound alone checks little: Adam's first step moves each
    element by about its learning rate (1e-5 here, in warmup) whatever
    the size of its gradient.  So the grad norm and the moments m
    (= 0.1·clipped g) and v after the step are held too: the grad norm
    relative to the reference's, each moment leaf by the norm of its
    difference over its own norm.  Bounds, each about five times the
    largest reading:

                                       grad norm   moments   (readings)
      float32 compute                  1e-6        1e-5      1.5e-7, 1.4e-6
      bfloat16 compute                 1e-4        2e-2      1.2e-5, 5.4e-3
      bf16 params, float32 compute     1e-5        5e-4      5.2e-7, 9.1e-5
      bf16 params, bfloat16 compute    5e-4        6e-2      7.1e-5, 1.8e-2
      the port, accum 1 vs 4 (bf16)    1e-5        2e-2      9.9e-7, 4.2e-3

    bfloat16 activations round at every layer (2^-9 relative), and the
    two frameworks round in other places, hence the wider bounds there.
    They still separate the faults they guard against: accumulating 3 of
    4 microbatches moves the grad norm by 0.14 and the moments by 0.59;
    a sum not divided by ``accum`` moves the grad norm by 3.0 (the moments
    not: clipping rescales them);
  * resume inside the port: bit-equal (the same ops on the same bytes);
  * resume across frameworks (3 steps each after a shared checkpoint, at
    float32 compute): loss 1e-5, params 1e-6 (measured 3.0e-8 both ways;
    float32 gradients agree to a few ulps, far from the sign flips that
    would let Adam move an element by up to 2·lr);
  * the TINY config trains: the reference's margin, the mean of the last
    five losses 0.3 below the first five's (``tests/test_train.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread
from repro import checkpoint as jckpt
from repro.data import pipeline as jdata
from repro.models import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import checkpoint as tckpt
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelConfig
from repro_torch.models import model as tm
from repro_torch.optim import adamw as tadamw
from repro_torch.train.loop import StragglerMonitor, TrainLoop
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import leaves, tree_map

TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=32,
               n_heads=4, n_kv=2, head_dim=8, d_ff=64, vocab=128,
               remat=False)
TINY = ModelConfig(**TINY_KW)
J_TINY = JModelConfig(**TINY_KW)


def _data(cfg=TINY, B=8, S=32):
    return tdata.SyntheticLMData(cfg, B, S, seed=0)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_port(jtree):
    return tm.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                device="cpu")


def _rel_err(want, got):
    """Max over leaves of ||got - want|| / ||want|| (float64)."""
    assert len(got) == len(want)
    errs = []
    for w, g in zip(want, got):
        w, g = (np.asarray(x, np.float64) for x in (w, g))
        errs.append(np.linalg.norm(g - w) / np.linalg.norm(w))
    return max(errs)


def _np(tree):
    return [t.float().numpy() for t in leaves(tree)]


def _check_grads(jm_, js, tm_, ts, gn_tol, moment_tol):
    """The step's grad norm and the moments it left, port against
    reference."""
    assert abs(float(tm_["grad_norm"]) / float(jm_["grad_norm"]) - 1) \
        < gn_tol
    for name in ("m", "v"):
        want = [np.asarray(x, np.float32) for x in jax.tree.leaves(
            js["opt"][name])]
        assert _rel_err(want, _np(ts["opt"][name])) < moment_tol, name


#: (grad norm, moments) bounds of one step, by compute dtype and
#: ``bf16_params_in_compute`` (see the module docstring)
STEP_TOL = {("float32", False): (1e-6, 1e-5),
            ("bfloat16", False): (1e-4, 2e-2),
            ("float32", True): (1e-5, 5e-4),
            ("bfloat16", True): (5e-4, 6e-2)}


def _max_diff(jtree, ttree):
    got, want = leaves(ttree), jax.tree.leaves(jtree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(w, np.float32)
                            - g.float().numpy()).max())
               for g, w in zip(got, want))


# -- AdamW -------------------------------------------------------------------
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    assert ([f.name for f in dataclasses.fields(tadamw.AdamWConfig)]
            == [f.name for f in dataclasses.fields(jadamw.AdamWConfig)])
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b": [(16,), (3, 5, 2)]}
    params = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
              "b": [rng.standard_normal(s).astype(np.float32)
                    for s in shapes["b"]]}
    kw = dict(lr=1e-2, warmup_steps=2, state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js = jadamw.init_opt_state(jp, jcfg)
    ts = tadamw.init_opt_state(tp, tcfg)
    assert all(str(m.dtype) == f"torch.{state_dtype}"
               for m in leaves(ts["m"]) + leaves(ts["v"]))
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for i in range(3):
        # step 0 clips (norm about 20 against clip_norm 1), the rest not
        scale = 3.0 if i == 0 else 0.01
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                    ).astype(np.float32), params)
        jp, js, jm_ = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                          js, jcfg)
        tp2, ts, tm_ = tadamw.adamw_update(tp, tree_map(torch.from_numpy, g),
                                           ts, tcfg)
        assert tp2 is tp                                  # in place
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert tm_[k].dim() == 0
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-6)
        assert _max_diff(jp, tp) < 1e-6
        m_tol = 2 ** -7 if state_dtype == "bfloat16" else 1e-5
        for name in ("m", "v"):
            for w, t in zip(jax.tree.leaves(js[name]), leaves(ts[name])):
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(w, np.float32),
                                           rtol=m_tol, atol=1e-12)


# -- the train step ----------------------------------------------------------
def test_init_train_state_layout_matches_reference():
    opt = tadamw.AdamWConfig(state_dtype="bfloat16")
    got = init_train_state(TINY, opt, seed=0, device="cpu")
    want = jstep.init_train_state(J_TINY, jadamw.AdamWConfig(
        state_dtype="bfloat16"), jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(leaves(got))
    for (path, w), t in zip(flat, leaves(got)):
        assert tuple(t.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype)


def _one_step(cfg, jcfg, batch, opt_kw=None):
    """The reference's state at key 0 bridged to the port; one step of
    each package.  Returns (port state, port metrics, reference state,
    reference metrics)."""
    opt_kw = opt_kw or dict(lr=1e-3)
    js = jstep.init_train_state(jcfg, jadamw.AdamWConfig(**opt_kw),
                                jax.random.key(0))
    ts = _to_port(js)
    ts, tm_ = make_train_step(cfg, tadamw.AdamWConfig(**opt_kw))(
        ts, _t(batch))
    js, jm_ = jax.jit(jstep.make_train_step(jcfg, jadamw.AdamWConfig(
        **opt_kw)))(js, _j(batch))
    return ts, tm_, js, jm_


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(accum, compute):
    kw = dict(grad_accum=accum, compute_dtype=compute)
    cfg, jcfg = (dataclasses.replace(c, **kw) for c in (TINY, J_TINY))
    batch = _data().batch_at(0)
    ts, tm_, js, jm_ = _one_step(cfg, jcfg, batch)
    assert all(tm_[k].dim() == 0 for k in ("loss", "grad_norm", "lr"))
    assert abs(float(tm_["loss"]) - float(jm_["loss"])) < 1e-4
    assert _max_diff(js["params"], ts["params"]) < 5e-5
    _check_grads(jm_, js, tm_, ts, *STEP_TOL[compute, False])
    assert int(ts["opt"]["step"]) == 1


def test_grad_accum_matches_full_batch():
    """The reference's test on the port: accum 4 == one full batch."""
    batch = _t(_data().batch_at(0))
    base = init_train_state(TINY, tadamw.AdamWConfig(), seed=0,
                            device="cpu")
    out = {}
    for accum in (1, 4):
        cfg = dataclasses.replace(TINY, grad_accum=accum)
        s = tree_map(lambda t: t.clone(), base)
        out[accum] = make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3))(
            s, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    assert max(float((a - b).abs().max()) for a, b in zip(
        leaves(s1["params"]), leaves(s4["params"]))) < 5e-5
    assert abs(float(m4["grad_norm"]) / float(m1["grad_norm"]) - 1) < 1e-5
    for name in ("m", "v"):
        assert _rel_err(_np(s1["opt"][name]), _np(s4["opt"][name])) < 2e-2
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(dataclasses.replace(TINY, grad_accum=3),
                        tadamw.AdamWConfig())(s1, batch)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_bf16_params_in_compute_matches_reference(compute):
    kw = dict(bf16_params_in_compute=True, compute_dtype=compute)
    cfg, jcfg = (dataclasses.replace(c, **kw) for c in (TINY, J_TINY))
    ts, tm_, js, jm_ = _one_step(cfg, jcfg, _data().batch_at(0))
    loss_tol = 2e-3 if compute == "bfloat16" else 1e-4
    assert abs(float(tm_["loss"]) - float(jm_["loss"])) < loss_tol
    assert _max_diff(js["params"], ts["params"]) < 5e-5
    _check_grads(jm_, js, tm_, ts, *STEP_TOL[compute, True])
    assert all(t.dtype == torch.float32 for t in leaves(ts["params"]))


def test_compress_hook_sees_the_grads():
    seen = []

    def compress(grads):
        seen.append(grads)
        return tree_map(torch.zeros_like, grads)

    s = init_train_state(TINY, tadamw.AdamWConfig(), seed=0, device="cpu")
    before = tree_map(lambda t: t.clone(), s["params"])
    opt = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    s, m = make_train_step(TINY, opt, compress=compress)(
        s, _t(_data().batch_at(0)))
    assert len(seen) == 1 and float(m["grad_norm"]) == 0.0
    assert [tuple(g.shape) for g in leaves(seen[0])] == \
        [tuple(p.shape) for p in leaves(before)]
    # zero gradients: only the decoupled weight decay moves the params
    for a, b in zip(leaves(s["params"]), leaves(before)):
        torch.testing.assert_close(a, b * (1 - opt.lr * opt.weight_decay),
                                   rtol=1e-6, atol=0)


def test_tiny_config_trains():
    """The reference's ``test_loss_decreases`` on the port."""
    opt = tadamw.AdamWConfig(lr=3e-3, warmup_steps=5)
    state = init_train_state(TINY, opt, seed=0, device="cpu")
    step = make_train_step(TINY, opt)
    data = _data()
    losses = []
    for i in range(40):
        state, m = step(state, _t(data.batch_at(i)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


# -- resume ------------------------------------------------------------------
def test_resume_is_exact(tmp_path):
    """6 steps straight == 3 + checkpoint + restore + 3, bit for bit."""
    opt = tadamw.AdamWConfig(lr=1e-3)
    step = make_train_step(TINY, opt)
    data = _data()
    sA = init_train_state(TINY, opt, seed=2, device="cpu")
    for i in range(6):
        sA, _ = step(sA, _t(data.batch_at(i)))
    sB = init_train_state(TINY, opt, seed=2, device="cpu")
    for i in range(3):
        sB, _ = step(sB, _t(data.batch_at(i)))
    tckpt.save_pytree(sB, tmp_path, 3)
    sB2 = tckpt.restore_pytree(init_train_state(TINY, opt, seed=5,
                                                device="cpu"), tmp_path, 3)
    for i in range(3, 6):
        sB2, _ = step(sB2, _t(data.batch_at(i)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(sA), leaves(sB2)))


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_resume_across_frameworks(tmp_path, saved_by):
    """A state saved at step 3 by one package, continued 3 steps by each:
    the two continuations agree."""
    cfg = dataclasses.replace(TINY, compute_dtype="float32")
    jcfg = dataclasses.replace(J_TINY, compute_dtype="float32")
    kw = dict(lr=1e-3)
    data = _data(cfg)
    jstep_fn = jax.jit(jstep.make_train_step(jcfg, jadamw.AdamWConfig(**kw)))
    tstep_fn = make_train_step(cfg, tadamw.AdamWConfig(**kw))
    js = jstep.init_train_state(jcfg, jadamw.AdamWConfig(**kw),
                                jax.random.key(0))
    if saved_by == "reference":
        for i in range(3):
            js, _ = jstep_fn(js, _j(data.batch_at(i)))
        jckpt.save_pytree(js, tmp_path, 3)
    else:
        ts = _to_port(js)
        for i in range(3):
            ts, _ = tstep_fn(ts, _t(data.batch_at(i)))
        tckpt.save_pytree(ts, tmp_path, 3)
    template = init_train_state(cfg, tadamw.AdamWConfig(**kw), seed=1,
                                device="cpu")
    ts = tckpt.restore_pytree(template, tmp_path, 3)
    js = jckpt.restore_pytree(jax.tree.map(jnp.asarray, js), tmp_path, 3)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 3
    assert _max_diff(js, ts) == 0.0                    # the same bytes
    for i in range(3, 6):
        b = data.batch_at(i)
        js, jm_ = jstep_fn(js, _j(b))
        ts, tm_ = tstep_fn(ts, _t(b))
        assert abs(float(jm_["loss"]) - float(tm_["loss"])) < 1e-5
    assert _max_diff(js["params"], ts["params"]) < 1e-6


# -- the loop, the data, the launcher -----------------------------------------
def test_train_loop_writes_log_and_checkpoints(tmp_path):
    opt = tadamw.AdamWConfig(lr=1e-3)
    state = init_train_state(TINY, opt, seed=0, device="cpu")
    data = _data()
    loop = TrainLoop(make_train_step(TINY, opt),
                     lambda i: _t(data.batch_at(i)),
                     tckpt.CheckpointManager(tmp_path), ckpt_every=5,
                     log_path=str(tmp_path / "log.jsonl"))
    state, end, losses = loop.run(state, 0, 8)
    assert end == 8 and len(losses) == 8 and np.isfinite(losses).all()
    assert tckpt.latest_step(tmp_path) == 8
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_5", "step_8"]
    recs = [json.loads(line)
            for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(1, 9))
    assert [r["loss"] for r in recs] == list(losses)
    assert all(set(r) == {"step", "loss", "dt_s", "grad_norm", "straggler"}
               for r in recs)
    restored = tckpt.restore_pytree(state, tmp_path, 8)
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(state), leaves(restored)))


def test_straggler_monitor_matches_reference():
    dts = [0.1] * 10 + [0.5, 0.12, 0.3, 0.05, 1.0, 0.2, 0.2]
    t, j = StragglerMonitor(factor=2.0), jloop.StragglerMonitor(factor=2.0)
    assert [t.observe(dt) for dt in dts] == [j.observe(dt) for dt in dts]
    assert (t.slow_steps, t.ewma) == (j.slow_steps, j.ewma)
    assert t.slow_steps >= 2


def test_memmap_dataset_and_batch_fn_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 10_000).astype(
        np.uint16).tofile(path)
    for n_hosts, host_id in ((1, 0), (2, 1)):
        t = tdata.MemmapTokenDataset(str(path), 8, 64, n_hosts=n_hosts,
                                     host_id=host_id)
        j = jdata.MemmapTokenDataset(str(path), 8, 64, n_hosts=n_hosts,
                                     host_id=host_id)
        assert t.n_windows == j.n_windows
        for step in (0, 1, 7, 300):
            a, b = t.batch_at(step), j.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    for p in (str(path), str(tmp_path / "missing.bin"), None):
        a = tdata.make_batch_fn(TINY, 4, 16, seed=3, path=p)(5)
        b = jdata.make_batch_fn(J_TINY, 4, 16, seed=3, path=p)(5)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _launch(tmp_path, steps, *extra):
    return launch_train.main([
        "--smoke", "--device", "cpu", "--steps", str(steps), "--batch", "4",
        "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
        str(tmp_path / "ckpt"), *extra])


def test_launcher_trains_resumes_and_refuses_pod(tmp_path, capsys):
    state, end, losses, loop = _launch(tmp_path, 3, "--log",
                                       str(tmp_path / "log.jsonl"))
    assert end == 3 and len(losses) == 3 and np.isfinite(losses).all()
    assert tckpt.latest_step(tmp_path / "ckpt") == 3
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 3
    state2, end2, losses2, _ = _launch(tmp_path, 5)
    assert end2 == 5 and len(losses2) == 2
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "qwen3-0.6b-smoke: steps 3->5" in out
    # the same five steps without the restart
    _, _, straight, _ = launch_train.main([
        "--smoke", "--device", "cpu", "--steps", "5", "--batch", "4",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "other")])
    np.testing.assert_array_equal(np.concatenate([losses, losses2]),
                                  straight)
    with pytest.raises(RuntimeError, match="needs 256 processes"):
        _launch(tmp_path, 1, "--mesh", "pod")
    assert launch_train.parse_args([]).smoke is False
    assert launch_train.parse_args([]).device == "cuda"
