"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] —
128 experts top-2 with a dense residual MLP in parallel."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    attention="gqa",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864),
    param_dtype="bfloat16",   # >100B: fp32 replicas cannot fit the mesh HBM
    source="hf:Snowflake/snowflake-arctic-base",
)
