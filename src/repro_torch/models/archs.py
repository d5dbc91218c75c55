"""Registry of the 10 assigned architectures (exact public configs).

Port of ``repro.models.archs``, a copy. Each entry also exists as
``repro_torch/configs/<id>.py``; those modules import from here so there
is a single source of truth.
"""

from __future__ import annotations

from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       SSMConfig)

ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# — dense —
YI_34B = _reg(ArchConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab=64000, rope_theta=5_000_000.0,
))  # [arXiv:2403.04652; hf] llama-arch GQA

CODEQWEN_7B = _reg(ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
    rope_theta=1_000_000.0,
))  # [hf:Qwen/CodeQwen1.5-7B] qwen1.5-arch (MHA, QKV bias)

H2O_DANUBE3_4B = _reg(ArchConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
    sliding_window=4096,
))  # [arXiv:2401.16818] llama+mistral mix, SWA

PHI4_MINI = _reg(ArchConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064, tie_embeddings=True,
))  # [arXiv:2412.08905; hf] RoPE SwiGLU GQA, 200k vocab

# — ssm —
MAMBA2_130M = _reg(ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
))  # [arXiv:2405.21060] SSD, attention-free

# — moe —
PHI35_MOE = _reg(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
))  # [hf:microsoft/Phi-3.5-MoE-instruct] 16e top-2

DEEPSEEK_V3 = _reg(ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=2048, vocab=129280,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp_heads=1,
))  # [arXiv:2412.19437; hf] MLA, 1 shared + 256 routed top-8, MTP

# — hybrid —
HYMBA_1_5B = _reg(ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
    sliding_window=1024, swa_every=16,   # 3 global layers: 0, 16, (last)
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256),
))  # [arXiv:2411.13676; hf] parallel attn+mamba heads

# — audio —
MUSICGEN_MEDIUM = _reg(ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, frontend="audio",
))  # [arXiv:2306.05284; hf] decoder-only over EnCodec tokens (frontend stub)

# — vlm —
QWEN2_VL_2B = _reg(ArchConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, mrope=True, qkv_bias=True,
    rope_theta=1_000_000.0, frontend="vision",
))  # [arXiv:2409.12191; hf] M-RoPE, vision frontend stub


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ArchConfig, n_layers: int = 2, d_model: int = 128,
                   vocab: int = 512) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    import dataclasses
    hd = 32
    n_heads = max(d_model // hd, 4)
    n_kv = max(n_heads // max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1), 1) \
        if cfg.n_kv_heads else 0
    kw = dict(
        name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=n_kv, head_dim=hd if cfg.n_heads else None,
        d_ff=d_model * 3 if cfg.d_ff else 0, vocab=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None,
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=d_model * 2,
                              n_shared=cfg.moe.n_shared)
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                              rope_head_dim=16, nope_head_dim=32,
                              v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=32, expand=2, chunk=32)
    return dataclasses.replace(cfg, **kw)
