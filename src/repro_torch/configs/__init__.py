"""Configurations and the architecture registry (``repro/configs``).

``get_config(name)`` returns the config of every architecture id of the
reference: the dense GQA decoders (full or sliding-window attention), the
MoE decoders (arctic-480b; deepseek-v3-671b with MLA and MTP), the
recurrent families (zamba2-2.7b, Mamba2 with a shared attention block;
xlstm-350m, mLSTM and sLSTM blocks), the audio encoder-decoder
(whisper-medium, over precomputed frame embeddings) and the vision decoder
(llama-3.2-vision-11b, gated cross-attention over patch embeddings), which
``repro_torch.models.transformer`` runs, and the paper's four models'
pseudo-configs (``paper-*``, run by ``repro_torch.models.small``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPE_BY_NAME, INPUT_SHAPES,
                                      ExperimentConfig, FLConfig,
                                      HybridConfig, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, SSMConfig)

ARCH_IDS = (
    "deepseek-v3-671b", "arctic-480b", "h2o-danube-3-4b", "nemotron-4-15b",
    "zamba2-2.7b", "whisper-medium", "qwen1.5-4b", "llama-3.2-vision-11b",
    "xlstm-350m", "deepseek-coder-33b",
    "paper-fcn", "paper-cnn", "paper-squeezenet", "paper-lstm",
)

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen1.5-4b": "qwen1_5_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-350m": "xlstm_350m",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "paper-fcn": "paper_models",
    "paper-cnn": "paper_models",
    "paper-squeezenet": "paper_models",
    "paper-lstm": "paper_models",
}

TRANSFORMER_ARCHS = tuple(a for a in ARCH_IDS if not a.startswith("paper-"))


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if name.startswith("paper-"):
        return mod.CONFIGS[name]
    return mod.CONFIG


__all__ = ["ARCH_IDS", "TRANSFORMER_ARCHS", "get_config", "ExperimentConfig",
           "FLConfig", "HybridConfig", "MLAConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "InputShape", "INPUT_SHAPES",
           "INPUT_SHAPE_BY_NAME"]
