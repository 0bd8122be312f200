"""Qwen1.5 4B [hf:Qwen/Qwen1.5-0.5B family] — QKV bias, full MHA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    attention="gqa",
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
