from repro_torch.configs.base import ExperimentConfig, FLConfig

__all__ = ["ExperimentConfig", "FLConfig"]
