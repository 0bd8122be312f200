"""DeepSeek-Coder 33B [arXiv:2401.14196] — llama-architecture GQA decoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    attention="gqa",
    source="arXiv:2401.14196",
)
