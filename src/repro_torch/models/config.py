"""Model configuration: a composable stage-based decoder description.

A model is a list of **stages**; each stage repeats a *period* of layer
specs ``count`` times over params stacked along a leading ``[count]`` axis.
This expresses uniform stacks (1-layer period), gemma3's 5-local:1-global
pattern (6-layer period), recurrentgemma's 2-recurrent:1-attention pattern,
etc.  A copy of the reference package's ``models/config.py``: the port and
the reference read the same configurations.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # 'attn' | 'local' | 'rglru' | 'mamba'
    moe: bool = False
    window: int = 0             # for 'local' / SWA ('attn' with window>0)


@dataclasses.dataclass(frozen=True)
class Stage:
    period: Tuple[LayerSpec, ...]
    count: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0                      # SWA window for all attn layers
    local_global_period: int = 0         # gemma3: N local then 1 global
    local_window: int = 1024
    # activations
    act: str = "swiglu"                  # swiglu|sq_relu|gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 32                 # dispatch groups (≥ batch shards)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (recurrentgemma): RG-LRU + local attn, pattern R,R,A
    rglru_period: int = 0                # 3 → (rglru, rglru, attn)
    rnn_width: int = 0
    conv_width: int = 4
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    # VLM stub
    n_vis_tokens: int = 0
    # training
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    grad_accum: int = 1                  # microbatches per step
    remat: bool = True
    remat_policy: str = "nothing"        # nothing|dots (§Perf knob)
    seq_parallel: bool = False           # Megatron-SP residual stream (§Perf)
    attn_p_bf16: bool = False            # bf16 softmax weights in PV (§Perf)
    bf16_params_in_compute: bool = False  # cast f32 params→bf16 before use:
    # FSDP all-gathers move half the bytes, matmuls hit the bf16 MXU (§Perf)
    fsdp_axes: str = "data"              # "data" | "pod_data": shard params/
    # optimizer over the pod (DCN) axis too — fits larger states at the cost
    # of cross-pod parameter all-gathers (§Perf)
    moe_legacy_dispatch: bool = False    # pre-§Perf-A1 behaviour: host-side
    # B·S merge before the EP shard_map (forces GSPMD boundary resharding) —
    # kept so the §Perf baseline is reproducible under the final cost meter
    decode_onehot_update: bool = False   # KV write as masked select instead
    # of DUS along the sequence-sharded cache dim (kills the decode
    # all-gather GSPMD inserts for cross-shard dynamic updates) (§Perf)
    decode_replicate_activations: bool = False  # decode activations are
    # tiny ([B,1,d]); replicating them over 'data' lets 2D-sharded weights
    # contract locally (+psum) instead of being all-gathered — the
    # weight-stationary serving layout (§Perf C)
    kv_cache_dtype: str = ""             # ""=compute dtype | "float8_e4m3fn":
    # halve KV bytes for long-context decode (§Perf D)
    attn_causal_groups: int = 0          # >0: split the q axis of chunked
    # attention into N groups, each scanning only its causal KV prefix —
    # skips ~(1 - (N+1)/2N) of the masked chunk compute/bytes (§Perf D)
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    # quantized (bit-plane) serving path — the paper's technique in the LM
    quantize_bits: Optional[int] = None  # None | 8 | 4
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def stages(self) -> List[Stage]:
        if self.family == "ssm":
            return [Stage((LayerSpec("mamba"),), self.n_layers)]
        if self.rglru_period:
            per = (LayerSpec("rglru"), LayerSpec("rglru"),
                   LayerSpec("local", window=self.local_window))
            full, rem = divmod(self.n_layers, len(per))
            out = [Stage(per, full)] if full else []
            if rem:
                out.append(Stage(per[:rem], 1))
            return out
        if self.local_global_period:
            p = self.local_global_period
            per = tuple([LayerSpec("local", window=self.local_window)] * p
                        + [LayerSpec("attn")])
            full, rem = divmod(self.n_layers, p + 1)
            out = [Stage(per, full)] if full else []
            if rem:
                out.append(Stage(per[:rem], 1))
            return out
        spec = LayerSpec("attn", moe=self.n_experts > 0, window=self.window)
        return [Stage((spec,), self.n_layers)]

    def dec_stages(self) -> List[Stage]:
        return self.stages()

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §Arch-applicability)."""
        if self.family == "ssm" or self.rglru_period:
            return True
        if self.local_global_period:
            return True
        if self.window:          # sliding-window attention (mixtral)
            return True
        return False

    def layer_kinds(self) -> List[LayerSpec]:
        out: List[LayerSpec] = []
        for st in self.stages():
            for _ in range(st.count):
                out.extend(st.period)
        return out

    # -- parameter counting (for roofline MODEL_FLOPS) --------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d                      # embed
        if not self.tie_embeddings:
            total += d * self.vocab                 # lm head
        for spec in self.layer_kinds():
            total += 2 * d                          # norms
            # temporal-mixing block
            if spec.kind in ("attn", "local"):
                total += d * (self.n_heads + 2 * self.n_kv) * hd
                total += self.n_heads * hd * d
            elif spec.kind == "mamba":
                din = self.ssm_expand * d
                total += d * (2 * din + 2 * self.ssm_state
                              + self.ssm_heads) + din * d
            elif spec.kind == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + w * d + 2 * w * w + 2 * w
            # channel-mixing block (mamba2 has none)
            if spec.kind != "mamba":
                if spec.moe:
                    eff = self.expert_d_ff or self.d_ff
                    n_e = (self.top_k if active_only else self.n_experts)
                    total += d * self.n_experts     # router (always resident)
                    total += n_e * 3 * d * eff
                else:
                    n_mats = 3 if self.act == "swiglu" else 2
                    total += n_mats * d * self.d_ff
        if self.is_encdec:
            # encoder layers: self-attn + mlp ; decoder adds cross-attn
            enc = self.n_enc_layers * (
                d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
                + 2 * d * self.d_ff + 2 * d)
            cross = self.n_layers * (
                d * (self.n_heads + 2 * self.n_kv) * hd
                + self.n_heads * hd * d + d)
            total += enc + cross
        return total
