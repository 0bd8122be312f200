from repro_torch.data.online import (binomial_arrivals_batched, dataset_layout,
                                     draw_arrival_batch, pad_arrival_batch)
from repro_torch.data.video_caching import (D1_DIM, Catalog, RequestStream,
                                            UserModel, make_population)

__all__ = ["Catalog", "RequestStream", "UserModel", "make_population",
           "D1_DIM", "binomial_arrivals_batched", "dataset_layout",
           "draw_arrival_batch", "pad_arrival_batch"]
