"""qwen2-0.5b [dense]: GQA (kv=2), QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True,
))
