"""Unified architecture config for the 10 assigned architectures.

Port of ``repro.models.config``: framework-free, a copy.

Every field mirrors the public config of the source model; `family` selects
the block structure. Head/vocab padding to mesh divisibility is derived here
(padded sizes are what the mesh shards; true sizes drive MODEL_FLOPS
accounting so padding waste is visible in the roofline tables).
"""

from __future__ import annotations

import dataclasses


def pad_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    router_noise: float = 0.0
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention geometry."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    sliding_window: int | None = None   # SWA width; None = full attention
    swa_every: int = 1           # 1 = all layers SWA; k = 1 global per k
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mrope: bool = False          # M-RoPE (t/h/w sections)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    frontend: str | None = None  # 'audio' / 'vision' stub frontends
    mtp_heads: int = 0           # multi-token-prediction extra heads

    # ---- derived ----------------------------------------------------------

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def padded_heads(self, tp: int) -> tuple[int, int]:
        """(q_heads, kv_heads) padded to the TP width (zero-init pad heads)."""
        nq = pad_to(self.n_heads, tp)
        nkv = pad_to(self.n_kv_heads, tp)
        # GQA grouping must stay integral after padding
        while nq % nkv:
            nkv += tp
        return nq, nkv

    def padded_vocab(self, tp: int) -> int:
        return pad_to(self.vocab, tp)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window is not None and self.swa_every == 1)

    # ---- parameter / flops accounting (true, unpadded sizes) --------------

    def param_count(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":
            if self.mla:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.nope_head_dim + m.rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.rope_head_dim)
                per_layer += m.kv_lora_rank * self.n_heads * (
                    m.nope_head_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                per_layer += self.n_heads * hd * d
        if self.family in ("ssm", "hybrid"):
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_layer += d * (2 * d_in + 2 * s.d_state + nh) + d_in * d
        if self.moe:
            e = self.moe
            per_layer += d * e.n_experts * 3 * e.d_ff_expert
            per_layer += d * e.n_shared * 3 * self.d_ff
            per_layer += d * e.n_experts   # router
        elif f:
            per_layer += 3 * d * f          # SwiGLU
        return emb + (L + self.mtp_heads) * per_layer

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        d = self.d_model
        L = self.n_layers + self.mtp_heads
        dense_moe = d * e.n_experts * 3 * e.d_ff_expert
        active_moe = d * (e.top_k * 3 * e.d_ff_expert
                          + e.n_shared * 3 * self.d_ff)
        return self.param_count() - L * (dense_moe
                                         + d * e.n_shared * 3 * self.d_ff
                                         - active_moe)

    def model_flops_per_token(self) -> float:
        """6 * N_active (dense fwd+bwd rule-of-thumb, §Roofline)."""
        return 6.0 * self.active_param_count()
