"""Model configuration for the 10 assigned architectures (+ reduced smoke
variants), the port's own copy of ``repro/models/config.py``.  One frozen
dataclass drives model construction and the serving entry point; the
distribution hints are kept so that both packages read the same configs."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- MLP / MoE ---
    mlp_type: str = "swiglu"       # swiglu | gelu
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    moe_capacity_factor: float = 1.25

    # --- attention ---
    swa_window: int = 0            # 0 = full attention
    mrope: bool = False            # qwen2-vl multi-axis rotary
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    use_layernorm: bool = False    # stablelm-2: LayerNorm w/ bias
    rope_theta: float = 10000.0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- hybrid (zamba2): one shared attn block every k backbone layers ---
    hybrid_attn_every: int = 0

    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0            # >0 -> enc-dec; n_layers = decoder layers
    enc_seq_divisor: int = 4       # encoder frames = seq_len // divisor

    # --- modality frontend stubs ---
    modality: str = "text"         # text | vision_stub | audio_stub
    frontend_len: int = 0          # vision_stub: patch positions at seq start

    # --- distribution hints (set by the launcher; empty = single device) ---
    batch_axes: Tuple[str, ...] = ()   # mesh axes sharding the batch dim
    sp_axis: str = ""                  # sequence-parallel axis between blocks
    dp_size: int = 1                   # product of batch_axes sizes

    # --- numerics / memory ---
    param_dtype: str = "bfloat16"
    remat: str = "nothing_saveable"   # nothing_saveable | dots | none
    attn_q_block: int = 512
    attn_kv_block: int = 1024

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ---- derived ----
    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """long_500k eligibility: SSM/hybrid state is O(1); SWA cache is
        window-bounded. Pure full-attention archs are skipped (DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate total parameters (for 6ND model-flops accounting)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        n = 0
        emb = V * D
        att = D * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * D if self.n_heads else 0
        if self.mlp_type == "swiglu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        if self.family == "moe":
            moe = self.moe_experts * 3 * D * F + D * self.moe_experts
            dense = 3 * D * self.d_ff if self.moe_dense_residual else 0
            per_layer = att + moe + dense + 2 * D
        elif self.family == "ssm":
            di, G, N, H = self.d_inner, 1, self.ssm_state, self.ssm_heads
            per_layer = D * (2 * di + 2 * G * N + H) + di * D + \
                self.ssm_conv * (di + 2 * G * N) + 3 * H + di + 2 * D
        elif self.family == "hybrid":
            di, G, N, H = self.d_inner, 1, self.ssm_state, self.ssm_heads
            mamba_l = D * (2 * di + 2 * G * N + H) + di * D + \
                self.ssm_conv * (di + 2 * G * N) + 3 * H + di + 2 * D
            shared = att + mlp + 2 * D
            return emb + D * V + self.n_layers * mamba_l + shared
        else:
            per_layer = att + mlp + 2 * D
        layers = self.n_layers + self.enc_layers
        return emb + D * V + layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of E experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        full = self.param_count()
        moe_total = self.n_layers * self.moe_experts * 3 * D * F
        moe_active = self.n_layers * self.moe_top_k * 3 * D * F
        return full - moe_total + moe_active

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            d_head=16 if self.n_heads else 0,
            d_ff=96 if self.d_ff else 0,
            vocab=256,
            moe_experts=4 if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            swa_window=min(self.swa_window, 32) if self.swa_window else 0,
            frontend_len=8 if self.frontend_len else 0,
            moe_capacity_factor=4.0,   # dropless at smoke scale -> exact tests
            attn_q_block=16,
            attn_kv_block=32,
            mrope_sections=(2, 3, 3) if self.mrope else self.mrope_sections,
            name=self.name + "-reduced",
        )
        return ModelConfig(**kw)
