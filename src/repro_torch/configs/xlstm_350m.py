"""xLSTM 350M [arXiv:2405.04517] — mLSTM blocks with sLSTM every 8th."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                         # mLSTM blocks carry their own up-proj
    vocab_size=50_304,
    attention="none",
    ssm=SSMConfig(kind="xlstm", slstm_every=8, mlstm_proj_factor=2.0,
                  chunk_size=256),
    source="arXiv:2405.04517",
)
