"""llava-next-34b [vlm]: a 60-layer decoder over projected patch
embeddings and tokens.  [hf:llava-hf/llava-v1.6-*; unverified]

The vision tower is a stub: the model takes precomputed patch embeddings
(B, 2880, 1024), LLaVA-NeXT's anyres tiling of 5 tiles x 576 patches,
projects them into d_model with ``vision_proj`` and puts them in front of
the token embeddings.  56 / 8 heads of 128.
"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    n_patches=2880,
))
