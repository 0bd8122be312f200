from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_model, loss_fn, param_count)
from repro_torch.models.small import (init_small, params_from_numpy,
                                      small_forward, small_loss)

__all__ = ["decode_step", "forward", "init_cache", "init_model", "loss_fn",
           "param_count", "init_small", "params_from_numpy", "small_forward",
           "small_loss"]
