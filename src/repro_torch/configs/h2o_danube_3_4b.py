"""H2O Danube3 4B [arXiv:2401.16818] — llama+mistral mix, sliding-window attn."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    attention="gqa",
    sliding_window=4096,
    source="arXiv:2401.16818",
)
