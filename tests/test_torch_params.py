"""The port's configs and its weight bridge against the reference package.

  * every config module and the smoke/serve variants are field-for-field
    the reference's;
  * ``params_from_numpy`` carries every leaf of the reference's
    ``init_params`` tree over with the same nesting, shape, dtype and bytes;
  * the port's own ``init_params`` draws the same tree layout, shapes,
    dtypes and scales from a ``torch.Generator`` (constant leaves equal),
    for every layer kind: attention, RG-LRU, Mamba-2, dense and MoE, and
    for whisper-small's encoder tree and cross-attention leaves and
    internvl2-26b (their smoke configs: the serve config turns whisper
    into a decoder-only stack);
  * the serve engine's stack geometry (full / ring / RG-LRU / SSM layers,
    window, ring pages, per-stage plans) is the reference's, field by
    field; encoder-decoder stacks are refused, and a request for the card
    without one raises instead of falling back.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import bridged, bridged_smoke, one_torch_thread
from repro import configs as jcfg
from repro.launch.serve import serve_config as j_serve_config
from repro.models import model as jm
from repro.serve.engine import build_stack_geom as j_build_stack_geom
from repro_torch import configs as tcfg
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_config
from repro_torch.models import model as tm
from repro_torch.serve.engine import build_stack_geom

MIXED = ["gemma3-12b", "mixtral-8x7b", "recurrentgemma-9b", "mamba2-1.3b",
         "qwen3-moe-235b-a22b"]
ARCHS = ["qwen3-0.6b", "qwen2.5-3b", "nemotron-4-340b"] + MIXED
#: held at their smoke configs, not the serve configs
SMOKE_ONLY = ["whisper-small", "internvl2-26b"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_match_reference(arch):
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    for fn in ("get_config", "smoke_config"):
        ref = dataclasses.asdict(getattr(jcfg, fn)(arch))
        assert dataclasses.asdict(getattr(tcfg, fn)(arch)) == ref
    for smoke in (True, False):
        assert (dataclasses.asdict(serve_config(arch, smoke))
                == dataclasses.asdict(j_serve_config(arch, smoke)))


@pytest.mark.parametrize("arch", ARCHS + SMOKE_ONLY)
def test_params_bridge_round_trip(arch):
    """Every leaf survives numpy → torch → numpy bit for bit."""
    cfg, jp, tp = (bridged_smoke if arch in SMOKE_ONLY else bridged)(arch)
    ref = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(tp))
    assert got.keys() == ref.keys()
    for path, a in ref.items():
        b = got[path].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, path
        assert b.tobytes() == a.tobytes(), path


@pytest.mark.parametrize("arch", ARCHS + SMOKE_ONLY)
def test_init_params_layout_matches_reference(arch):
    """Same tree, shapes, dtypes; same init scales: the two sample stds
    within 5%, or within 3 standard errors of their ratio where a leaf is
    too small for 5% (sqrt(1/N) for two draws of N normal values each:
    the smoke configs' narrow K/V and conv leaves, N under 3,600)."""
    cfg = (tcfg.smoke_config(arch) if arch in SMOKE_ONLY
           else serve_config(arch))
    ref = dict(_leaves(jax.tree.map(np.asarray,
                                    jm.init_params(cfg, jax.random.key(0)))))
    got = dict(_leaves(tm.init_params(cfg, seed=0, device="cpu")))
    assert got.keys() == ref.keys()
    for path, a in ref.items():
        b = got[path].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, path
        if a.std() == 0:                # constant leaves: equal
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:
            tol = max(0.05, 3 * a.size ** -0.5)
            assert abs(b.std() / a.std() - 1) < tol, path
    again = dict(_leaves(tm.init_params(cfg, seed=0, device="cpu")))
    assert all(torch.equal(again[p], got[p]) for p in got)
    if cfg.is_encdec:
        assert "/encoder/final_norm" in got and "/stages/0/0/xattn/wq" in got


@pytest.mark.parametrize("arch", MIXED)
def test_stack_geom_matches_reference(arch):
    """Smoke and published widths, at the launcher's page size."""
    for smoke in (True, False):
        cfg = serve_config(arch, smoke)
        got = build_stack_geom(cfg, page_size=8)
        ref = j_build_stack_geom(cfg, page_size=8)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.kind_props == ref.kind_props
        assert got.has_full == ref.has_full


def test_encoder_decoder_is_not_servable():
    cfg = dataclasses.replace(tcfg.smoke_config("whisper-small"),
                              compute_dtype="float32")
    with pytest.raises(ValueError, match="encoder-decoder"):
        build_stack_geom(cfg, page_size=8)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(serve_config("qwen3-0.6b"), seed=0)
    assert resolve_device("cpu") == torch.device("cpu")
