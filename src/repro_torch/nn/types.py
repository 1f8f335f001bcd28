"""Architecture configuration types (counterpart of ``repro/nn/types.py``).

Every supported architecture is a single :class:`ArchConfig`; the file
``repro_torch/configs/<id>.py`` instantiates it with the published
numbers.  ``reduced()`` returns a tiny same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_configs", "applicable_shapes"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False
    dense_ff: int = 0
    capacity_factor: float = 1.25
    # --- recurrence (ssm / hybrid) ---
    head_dim: int = 0           # derived when 0
    rwkv_head_dim: int = 64
    rglru_width: int = 0
    local_window: int = 0
    attn_every: int = 0
    # --- enc-dec / modality stubs ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500
    n_patches: int = 0
    # --- numerics / training ---
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    param_dtype: str = "float32"       # master weights
    opt_state_dtype: str = "float32"
    remat: bool = True
    subquadratic: bool = False

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if not self.attn_every else 3),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=max(1, min(self.n_kv_heads,
                                  min(self.n_heads, 4) if self.n_heads else 1)),
            d_ff=128,
            dense_ff=64 if self.dense_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 2),
            head_dim=16 if (self.head_dim or not self.n_heads) else 0,
            rwkv_head_dim=16,
            rglru_width=64 if self.rglru_width else 0,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=24,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            remat=False,
            opt_state_dtype="float32",
        )

    def params_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D): the
        reference's formula, which counts V x d once and no biases."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        if self.n_heads:
            attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
                + self.n_heads * hd * d
        else:
            attn = 0
        if self.family == "ssm":   # rwkv6: r,k,v,g,w,o + channel mix
            attn = 5 * d * d + d * d
            ffn = 2 * d * f
        elif self.n_experts:
            ffn = (self.n_experts + self.n_shared_experts) * 3 * d * f
            if self.moe_dense_residual:
                ffn += 3 * d * self.dense_ff
            ffn += d * self.n_experts  # router
        else:
            ffn = 3 * d * f
        if self.family == "hybrid":
            # RG-LRU layers replace attention with gated recurrence
            attn = 2 * d * self.rglru_width + 2 * self.rglru_width
        per_layer = attn + ffn + 2 * d
        total = self.n_layers * per_layer + V * d + d
        if self.is_encdec:
            total += self.n_enc_layers * per_layer
        return int(total)

    def active_params_count(self) -> int:
        """N_active for MoE MODEL_FLOPS: only top_k of the routed experts
        count."""
        if not self.n_experts:
            return self.params_count()
        d, f = self.d_model, self.d_ff
        routed_all = self.n_experts * 3 * d * f
        routed_active = self.top_k * 3 * d * f
        return self.params_count() \
            - self.n_layers * (routed_all - routed_active)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib
    for mod in ["qwen2_5_3b", "internlm2_1_8b", "qwen1_5_4b", "qwen2_0_5b",
                "arctic_480b", "qwen2_moe_a2_7b", "llava_next_34b",
                "rwkv6_3b", "whisper_base", "recurrentgemma_9b"]:
        importlib.import_module(f"repro_torch.configs.{mod}")


def applicable_shapes(cfg: ArchConfig) -> list:
    """The shape grid's skip rule: ``long_500k`` only for subquadratic
    attention (full attention is O(L^2) at 512k positions)."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.subquadratic]
