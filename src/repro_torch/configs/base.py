"""Architecture and shape configuration (copies of the reference's
``ArchConfig`` and ``ShapeConfig``).

Every architecture is a frozen ``ArchConfig``; the four workload shapes of
the dry run (``launch/dryrun.py``) are ``ShapeConfig``s; ``registry.
get(name)`` resolves ``--arch`` ids. The port serves every decoder-only
pattern of the registry (``models.model.check_supported``); the
encoder-decoder (whisper-base) is refused.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # blocks / activations
    mlp_type: str = "swiglu"         # swiglu|gelu|geglu|sqrelu
    qk_norm: bool = False
    post_norms: bool = False         # gemma2-style post-block norms
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scaling
    # per-layer temporal-mixer pattern, cycled over layers:
    #   attn | local | nope (global, no rope) | rglru | slstm | mlstm
    pattern: tuple = ("attn",)
    local_window: int = 4096
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500       # stub frontend sequence length
    # misc
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    sub_quadratic: bool = False      # eligible for long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def unit(self) -> int:
        """Layers per scan unit (one repetition of the pattern)."""
        return len(self.pattern)

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % self.unit]

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        n = V * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "local", "nope"):
                n += d * hd * (Hq + 2 * Hkv) + Hq * hd * d
            elif kind == "rglru":
                n += 5 * d * d + 4 * d  # in/gate/a/x/out projections
            elif kind == "slstm":
                n += 4 * d * d + (d // max(self.n_heads, 1)) * 4 * d + d * d
            elif kind == "mlstm":
                di = 2 * d
                n += d * 2 * di + 3 * di * di + di * d
            if self.n_experts:
                n += d * self.n_experts  # gate
                n += self.n_experts * 3 * d * self.moe_d_ff
                if self.n_shared_experts:
                    n += 3 * d * (self.moe_d_ff * self.n_shared_experts)
            elif ff:
                mults = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                n += mults * d * ff
        if self.encoder_decoder:
            for _ in range(self.n_encoder_layers):
                n += 4 * d * self.hd * self.n_heads + (
                    (3 if self.mlp_type in ("swiglu", "geglu") else 2)
                    * d * ff)
                n += 4 * d * self.hd * self.n_heads  # cross attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        per_layer_all = self.n_experts * 3 * self.d_model * self.moe_d_ff
        per_layer_act = self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - self.n_layers * (per_layer_all - per_layer_act)



@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the long_500k sub-quadratic rule."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full/global attention is quadratic at 524288 and the "
                       "KV cache would exceed HBM; see DESIGN.md §4")
    return True, ""

def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests."""
    unit = cfg.unit
    d = 64
    n_heads = max(2, min(4, cfg.n_heads))
    kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % kv:
        kv -= 1
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=unit * 2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d // n_heads if cfg.head_dim == 0 else 32,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        local_window=32,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        capacity_factor=8.0,  # avoid drop asymmetry in consistency tests
        n_shared_experts=min(cfg.n_shared_experts, 1),
        n_encoder_layers=2 if cfg.encoder_decoder else 0,
        encoder_frames=16 if cfg.encoder_decoder else 1500,
        dtype="float32",
    )
