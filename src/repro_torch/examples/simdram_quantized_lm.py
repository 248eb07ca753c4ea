"""The thesis's technique inside the LM: every FFN matrix of qwen2.5-3b is
stored in SIMDRAM's vertical (bit-plane) layout and multiplied bit-serially
— on the card through the hand-written bit-serial matmul kernel, on the CPU
through its plain version (counterpart of
``examples/simdram_quantized_lm.py``).

Reports the perplexity drift of the bit-plane model against the fp32 model
on synthetic data, and the FFN weight bytes.

    PYTHONPATH=src python -m repro_torch.examples.simdram_quantized_lm \\
        [--device cpu]     # the reference's config: qwen2.5-3b smoke, 4 layers
    PYTHONPATH=src python -m repro_torch.examples.simdram_quantized_lm \\
        --no-smoke         # the published config: 36 layers, d_ff 11008
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Tuple, Union

import torch

from ..configs import get_config, smoke_config
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..kernels.bitserial_matmul import QuantizedLinear
from ..models.config import LayerSpec, ModelConfig
from ..models.layers import rms_norm
from ..models.model import (_layer_params, _self_attn_full, forward_train,
                            init_params)

FFN = ("w1", "w2", "w3")
#: planes per weight, as in the reference example
N_BITS = 8
#: the reference example's acceptance bound on the perplexity drift, in %
MAX_DRIFT = 5.0


def config(smoke: bool = True) -> ModelConfig:
    """qwen2.5-3b in float32: the reference example's 4-layer smoke config,
    or the published one."""
    cfg = (dataclasses.replace(smoke_config("qwen2.5-3b"), n_layers=4)
           if smoke else get_config("qwen2.5-3b"))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def quantize_ffns(cfg: ModelConfig, params
                  ) -> Tuple[List[Dict[str, QuantizedLinear]], int, int]:
    """Every FFN matrix as ``N_BITS`` bit planes, packed.  Returns
    (per-layer ``{w1, w2, w3: QuantizedLinear}``, dense bytes counted as
    bf16, packed plane bytes), the byte figures as the reference example
    counts them."""
    stacked = params["stages"][0][0]
    qls, dense_bytes, plane_bytes = [], 0, 0
    for li in range(cfg.n_layers):
        mlp = _layer_params(stacked["mlp"], li)
        q = {k: QuantizedLinear.from_dense(mlp[k], n_bits=N_BITS)
             for k in FFN}
        qls.append(q)
        for k in FFN:
            dense_bytes += mlp[k].numel() * 2              # bf16 baseline
            plane_bytes += q[k].hbm_bytes
    return qls, dense_bytes, plane_bytes


def q_forward(cfg: ModelConfig, params, qls, tokens: torch.Tensor
              ) -> torch.Tensor:
    """The forward with every FFN through the bit-serial path (attention,
    norms and the head dense) → logits [B, S, V]."""
    x = params["embed"][tokens].to(torch.float32)
    stacked = params["stages"][0][0]
    for li, q in enumerate(qls):
        lp = _layer_params(stacked, li)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _self_attn_full(LayerSpec("attn"), cfg, lp["attn"], h)[0]
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        ff = torch.nn.functional.silu(q["w1"](h2)) * q["w3"](h2)
        x = x + q["w2"](ff)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head


def perplexity(logits: torch.Tensor, labels: torch.Tensor) -> float:
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return float(torch.exp((lse - ll).mean()))


def main(device: Union[str, torch.device] = "cuda", smoke: bool = True
         ) -> dict:
    """Run the example on ``device``.  Returns the numbers it prints
    (``ppl_ref``, ``ppl_q``, ``drift`` in %, ``dense_bytes``,
    ``plane_bytes``, ``stored_plane_bytes``) and what it computed them from
    (``cfg``, ``params``, ``qls``, ``tokens``, ``labels``, ``ref_logits``,
    ``q_logits``).  Raises if the drift is not below ``MAX_DRIFT``."""
    dev = resolve_device(device)
    cfg = config(smoke)
    params = init_params(cfg, seed=0, device=dev)
    batch = SyntheticLMData(cfg, 4, 32, 0).batch_at(0)
    tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
    labels = torch.from_numpy(batch["labels"]).long().to(dev)

    qls, dense_bytes, plane_bytes = quantize_ffns(cfg, params)
    stored = sum(4 * q[k].w_packed.numel() for q in qls for k in FFN)
    ref_logits = forward_train(cfg, params, {"tokens": tokens})
    q_logits = q_forward(cfg, params, qls, tokens)

    p_ref, p_q = perplexity(ref_logits, labels), perplexity(q_logits, labels)
    drift = abs(p_q - p_ref) / p_ref * 100
    print(f"[simdram-lm] {cfg.name} on {dev}: fp32 ppl {p_ref:.2f}  "
          f"bit-plane int8 ppl {p_q:.2f} ({drift:.2f}% drift)")
    print(f"[simdram-lm] FFN weight bytes: dense bf16 {dense_bytes/1e6:.2f}MB"
          f" → bit-planes {plane_bytes/1e6:.2f}MB "
          f"({dense_bytes/plane_bytes:.2f}x less HBM traffic per decode)")
    print(f"[simdram-lm] bit-planes as stored, packed 1 bit per weight per "
          f"plane (what the kernel reads): {stored/1e6:.2f}MB")
    if not drift < MAX_DRIFT:
        raise RuntimeError(f"perplexity drift {drift:.2f}% is not below "
                           f"{MAX_DRIFT}%")
    return {"ppl_ref": p_ref, "ppl_q": p_q, "drift": drift,
            "dense_bytes": dense_bytes, "plane_bytes": plane_bytes,
            "stored_plane_bytes": stored, "cfg": cfg, "params": params,
            "qls": qls, "tokens": tokens, "labels": labels,
            "ref_logits": ref_logits, "q_logits": q_logits}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.simdram_quantized_lm",
        description="qwen2.5-3b with bit-plane FFN weights: perplexity "
                    "drift and weight bytes")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reference example's 4-layer smoke config "
                         "(default); --no-smoke runs the published one")
    args = ap.parse_args()
    main(args.device, args.smoke)
