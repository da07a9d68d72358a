"""The assigned architecture pool (10 archs) + the paper's own eval arch.

Sources are cited per entry ([arXiv / hf]); approximations relative to the
published configs are recorded in ``notes`` and DESIGN.md §4.
"""
from __future__ import annotations

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


granite_20b = _reg(ArchConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
    mlp_type="gelu", pattern=("attn",), tie_embeddings=False,
    notes="llama-arch code model, MQA kv=1 [arXiv:2405.04324]",
))

phi3_medium_14b = _reg(ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab_size=100352,
    mlp_type="swiglu", pattern=("attn",),
    notes="RoPE SwiGLU GQA [arXiv:2404.14219]; 40 heads pad to 48 on "
          "model=16 TP (GSPMD)",
))

nemotron_4_15b = _reg(ArchConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab_size=256000,
    mlp_type="sqrelu", pattern=("attn",), tie_embeddings=False,
    rope_theta=10000.0,
    notes="GQA, squared-ReLU MLP [arXiv:2402.16819]",
))

gemma2_9b = _reg(ArchConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, d_ff=14336, vocab_size=256000,
    head_dim=256, mlp_type="geglu", pattern=("local", "attn"),
    local_window=4096, attn_softcap=50.0, logit_softcap=30.0,
    post_norms=True, embed_scale=True,
    notes="local/global alternating, softcaps [arXiv:2408.00118]",
))

recurrentgemma_2b = _reg(ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, mlp_type="geglu", pattern=("rglru", "rglru", "local"),
    local_window=2048, embed_scale=True, sub_quadratic=True,
    notes="RG-LRU + local attention 2:1 [arXiv:2402.19427]; 26 layers = "
          "8 full (r,r,l) units + 2 tail rglru layers",
))

chameleon_34b = _reg(ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab_size=65536,
    mlp_type="swiglu", pattern=("attn",), qk_norm=True,
    tie_embeddings=False,
    notes="early-fusion VLM: VQ image tokens share the vocab; the VQ "
          "tokenizer frontend is a stub (ids in input_specs) "
          "[arXiv:2405.09818]",
))

llama4_scout_17b = _reg(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048,
    mlp_type="swiglu", pattern=("local", "local", "local", "nope"),
    local_window=8192, n_experts=16, top_k=1, moe_d_ff=8192,
    n_shared_experts=1, qk_norm=True,
    notes="MoE 16e top-1 + shared expert; iRoPE chunked-local 3:1 with "
          "NoPE global layers (chunked attention approximated as sliding "
          "window 8192) [hf:meta-llama/Llama-4-Scout-17B-16E]",
))

moonshot_v1_16b = _reg(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840,
    mlp_type="swiglu", pattern=("attn",), n_experts=64, top_k=6,
    moe_d_ff=1408, n_shared_experts=2,
    notes="moonlight/deepseek-v3-style 64e top-6 + 2 shared experts "
          "[hf:moonshotai/Moonlight-16B-A3B]",
))

xlstm_350m = _reg(ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    pattern=("slstm", "mlstm"), sub_quadratic=True, tie_embeddings=False,
    notes="alternating sLSTM/mLSTM blocks, no separate MLP (cells carry "
          "their own projections) [arXiv:2405.04517]",
))

whisper_base = _reg(ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    mlp_type="gelu", pattern=("attn",), encoder_decoder=True,
    n_encoder_layers=6, encoder_frames=1500, tie_embeddings=False,
    notes="enc-dec; conv/mel frontend is a stub — input_specs provides "
          "precomputed frame embeddings (B, 1500, d) [arXiv:2212.04356]",
))

# the paper's own smallest eval model (Qwen3-8B-FP8), used by examples
qwen3_8b = _reg(ArchConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12288, vocab_size=151936,
    mlp_type="swiglu", pattern=("attn",), qk_norm=True,
    notes="paper Table 1 row: Qwen3-8B-FP8 [arXiv:2505.09388]",
))

ASSIGNED = [
    "granite-20b", "phi3-medium-14b", "nemotron-4-15b", "gemma2-9b",
    "recurrentgemma-2b", "chameleon-34b", "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b", "xlstm-350m", "whisper-base",
]


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return list(_REGISTRY)
