"""qwen2-moe-a2.7b [moe]: 60 routed top-4 + 4 shared experts, MHA (kv=16).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, qkv_bias=True,
    n_experts=60, top_k=4, n_shared_experts=4,
))
