"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                      # routed-expert FFN width
    vocab_size=129_280,
    head_dim=128,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_dense_layers=3,
                  d_ff_dense=18_432),
    mtp_depth=1,
    param_dtype="bfloat16",   # >100B: fp32 replicas cannot fit the mesh HBM
    source="arXiv:2412.19437",
)
