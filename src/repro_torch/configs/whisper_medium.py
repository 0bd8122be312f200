"""Whisper medium [arXiv:2212.04356] — enc-dec; conv/mel frontend stubbed
(input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,                    # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    attention="gqa",
    mlp="gelu",
    encoder=EncoderConfig(n_layers=24, n_frames=1500, max_decoder_len=448),
    source="arXiv:2212.04356",
)
