"""Llama-3.2-Vision 11B [hf:meta-llama/Llama-3.2-11B-Vision] —
cross-attn image layers every 5; ViT frontend stubbed (patch embeddings)."""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    attention="gqa",
    vision=VisionConfig(cross_attn_every=5, n_patches=1601, d_vision=1280),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
