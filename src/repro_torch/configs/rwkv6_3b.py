"""rwkv6-3b [ssm] "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

Sub-quadratic: the recurrent state is O(1) in context.  32 layers of a
time mix (the WKV recurrence over 40 heads of 64) and a channel mix.
"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536,
    rwkv_head_dim=64, subquadratic=True,
))
