from repro_torch.models.small import (init_small, params_from_numpy,
                                      small_forward, small_loss)

__all__ = ["init_small", "params_from_numpy", "small_forward", "small_loss"]
