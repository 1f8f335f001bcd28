"""qwen1.5-4b [dense]: MHA (kv=20), QKV bias. [hf:Qwen/Qwen1.5-*; hf]"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, qkv_bias=True,
))
