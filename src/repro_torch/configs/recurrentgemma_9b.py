"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427; unverified]

38 layers = 12 units of (RG-LRU, RG-LRU, local-attn) + 2 RG-LRU tail
layers.  Local window 2048 bounds attention.
"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    rglru_width=4096, local_window=2048, attn_every=3,
    subquadratic=True,
))
