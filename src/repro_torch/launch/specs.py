"""Input, cache and parameter stand-ins for every (arch x shape) cell
(counterpart of ``repro/launch/specs.py``).

Each stand-in is a tensor on the meta device: its shape and dtype are the
reference's ``ShapeDtypeStruct``'s, and nothing is allocated.  Modality
front ends are stubs in both packages: VLM cells get precomputed patch
embeddings (B, P, 1024), audio cells precomputed frame embeddings
(B, n_frames, d_model), both in the model's dtype.

    batch = input_specs(cfg, SHAPES["train_4k"])   # {"frames", "tokens",
                                                   #  "labels"} for audio
    cache = cache_struct(cfg, SHAPES["decode_32k"])
    params = param_structs(cfg)
"""
from __future__ import annotations

import torch

from repro_torch.nn.model import Model
from repro_torch.nn.types import ArchConfig, ShapeSpec

__all__ = ["input_specs", "cache_struct", "param_structs"]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *, with_labels=None):
    """The batch dict of one cell as meta tensors.

    train   -> the train batch: tokens and labels, after the modality stub
    prefill -> the prompt batch (no labels)
    decode  -> {"tokens": (B, 1)}; the cache comes from ``cache_struct``.

    A VLM's sequence holds its ``n_patches`` patches, so its tokens are
    ``seq_len - n_patches`` long; an audio model's tokens are ``seq_len``
    long beside its ``n_frames`` frames."""
    B, S = shape.global_batch, shape.seq_len
    if with_labels is None:
        with_labels = shape.kind == "train"
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32)}
    dtype = getattr(torch, cfg.dtype)
    batch = {}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _spec((B, cfg.n_patches, 1024), dtype)
        S -= cfg.n_patches
    elif cfg.family == "audio":
        batch["frames"] = _spec((B, cfg.n_frames, cfg.d_model), dtype)
    batch["tokens"] = _spec((B, S), torch.int32)
    if with_labels:
        batch["labels"] = _spec((B, S), torch.int32)
    return batch


def cache_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The decode cache of this cell, ``Model.init_cache(global_batch,
    seq_len)``'s tree, as meta tensors."""
    return Model(cfg, device="meta").init_cache(shape.global_batch,
                                                shape.seq_len)


def param_structs(cfg: ArchConfig) -> dict:
    """``Model.init``'s tree as meta tensors: the parameters' shapes and
    dtypes, none drawn."""
    return Model(cfg, device="meta").init(0)
