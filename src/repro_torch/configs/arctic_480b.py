"""arctic-480b [moe]: 128 experts top-2 + dense residual, GQA (kv=8).
[hf:Snowflake/snowflake-arctic-base; hf]

The dense-residual FFN runs in parallel with the routed MoE every layer
(Arctic's "dense-MoE hybrid").  At 35 layers of 14.07 B parameters the
model does not fit one 80 GB card, so the port runs it cut in depth.
"""
from repro_torch.nn.types import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2,
    moe_dense_residual=True, dense_ff=4864,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
))
