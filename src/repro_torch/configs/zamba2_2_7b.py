"""Zamba2 2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    attention="gqa",
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, chunk_size=64),
    hybrid=HybridConfig(shared_attn_every=6, shared_block_d_ff=10_240),
    source="arXiv:2411.15242",
)
