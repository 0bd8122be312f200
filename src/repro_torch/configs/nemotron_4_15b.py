"""Nemotron-4 15B [arXiv:2402.16819] — GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    attention="gqa",
    mlp="relu2",
    source="arXiv:2402.16819",
)
