"""Configurations, copied field for field from ``repro/configs/base.py``
and ``repro/harness/experiments.py`` so a config means the same thing in
both packages: ``ModelConfig`` (a transformer of the model zoo, with the
nested dataclasses it refers to), ``InputShape`` (one of the dry run's
four input shapes, ``INPUT_SHAPES``), ``FLConfig`` (the server round) and
``ExperimentConfig`` (one harness run)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    num_shared_experts: int = 0
    dense_residual_d_ff: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"              # "mamba2" | "xlstm"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk_size: int = 256
    slstm_every: int = 0
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334


@dataclass(frozen=True)
class HybridConfig:
    shared_attn_every: int = 6
    shared_block_d_ff: int = 10240


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 24
    n_frames: int = 1500
    max_decoder_len: int = 448


@dataclass(frozen=True)
class VisionConfig:
    cross_attn_every: int = 5
    n_patches: int = 1601
    d_vision: int = 1280


@dataclass(frozen=True)
class ModelConfig:
    """One architecture of the transformer zoo, as the reference defines
    it: every family of it (the dense and MoE decoders, zamba2's hybrid,
    xLSTM, whisper's encoder-decoder and the vision decoder) runs in
    ``repro_torch.models.transformer``."""
    name: str
    arch_type: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    attention: str = "gqa"            # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 => full attention
    mlp: str = "swiglu"               # swiglu | relu2 | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp_depth: int = 0
    remat: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    source: str = ""                  # citation
    dtype: str = "bfloat16"           # compute
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory is bounded in context length (long_500k
        legal)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 and self.encoder is None

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts, small
        vocab; the same cut as the reference's."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads < self.n_heads:      # keep GQA where possible
            n_kv = max(1, n_heads // 2)
        kw: dict = dict(
            n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else 0,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            mtp_depth=min(self.mtp_depth, 1),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                d_ff_dense=(min(self.moe.d_ff_dense, 256)
                            if self.moe.d_ff_dense else 0),
                dense_residual_d_ff=(min(self.moe.dense_residual_d_ff, 256)
                                     if self.moe.dense_residual_d_ff else 0),
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), chunk_size=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, shared_attn_every=1,
                shared_block_d_ff=min(self.hybrid.shared_block_d_ff, 256))
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(
                self.encoder, n_layers=2, n_frames=16, max_decoder_len=64)
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(
                self.vision, cross_attn_every=2, n_patches=16, d_vision=64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

INPUT_SHAPE_BY_NAME = {s.name: s for s in INPUT_SHAPES}


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round configuration (paper Section II/III)."""
    num_clients: int = 16
    kappa_max: int = 5                # κ: max local SGD steps
    local_lr: float = 0.1             # η
    global_lr: float = 1.0            # η̃
    chi: float = 1.0                  # χ score shift control (eq. 21)
    algorithm: str = "osafl"          # osafl|fedavg|fedprox|fednova|afa_cd|feddisco
    fedprox_mu: float = 0.9
    fednova_slowdown: float = 0.1
    feddisco_a: float = 0.2
    feddisco_b: float = 0.1
    score_sketch_dim: int = 0         # 0 = exact scores (paper); >0 = sketched
    stale_scores: bool = False        # weight round t with round t-1 scores
    engine: str = "loop"              # loop | stacked
    score_backend: str = "kernel"     # kernel (CUDA scored_reduce) |
                                      # reference (plain torch, kernels/ref.py)
    request_backend: str = "python"   # recorded here; applied by the harness
    round_backend: str = "dispatch"   # recorded here; applied by the harness
    cohort_size: int = 0              # C: sparse slot pool (0 = dense)
    participation: float = 1.0        # round-active fraction of the pool
    num_clusters: int = 0             # K: hierarchical edge clusters (0 = flat)
    scenario: str = ""                # recorded here; applied by the harness
    resource_backend: str = "x64"     # x64 (float64 solve) | f32 (log domain)
    literal_init_buffer: bool = False # Algorithm 2's literal d[u]=w^t/eta for
                                      # never-participated clients


@dataclass
class ExperimentConfig:
    """One harness run (``repro_torch.harness.run``). Every field and default
    of the reference's ``ExperimentConfig``, plus ``score_sketch_dim``, the
    ``FLConfig`` knob that the reference's harness does not pass on (its
    sketched runs build the servers by hand, ``benchmarks/
    ablation_scores.py``); ``harness/compat.py`` says which values the port
    runs so far."""
    model: str = "fcn"
    dataset: int = 1                  # 1 | 2
    num_clients: int = 12
    rounds: int = 25
    capacity: tuple = (80, 160)       # D_u range (reduced from paper 320-640)
    arrivals: int = 8                 # E_u (paper: ceil(32 p_u))
    local_lr: float = 0.1
    global_lr: float = 16.0
    batch: int = 16
    topk: int = 1                     # K (request-model randomness)
    seed: int = 0
    use_resource_opt: bool = True
    engine: str = "auto"              # auto|loop|stacked|pod|centralized
    pod_engine: str = "exact_tp"
    request_backend: str = "python"   # python | stacked
    round_backend: str = "dispatch"   # dispatch | fused
    resource_backend: str = "x64"     # x64 | f32
    rounds_per_dispatch: int = 1
    cohort_size: int = 0
    participation: float = 1.0
    num_clusters: int = 0
    cell_radius_m: float = 600.0
    scenario: str = ""
    score_sketch_dim: int = 0         # >0: OSAFL scores on k-dim sketches

    def validate(self, alg: str = "osafl", mesh=None):
        """Check this config against ``repro_torch.harness.compat.RULES``
        and return the resolved plan; raises ``ExperimentConfigError``."""
        from repro_torch.harness.compat import resolve
        return resolve(alg, self, mesh=mesh)
