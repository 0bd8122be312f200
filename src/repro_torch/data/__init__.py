from repro_torch.data.online import (binomial_arrivals_batched, dataset_layout,
                                     draw_arrival_batch, load_streams_state,
                                     pad_arrival_batch, streams_state_dict)
from repro_torch.data.video_caching import (D1_DIM, Catalog, RequestStream,
                                            UserModel, make_population)
from repro_torch.data.video_caching_stacked import StackedRequestStream

__all__ = ["Catalog", "RequestStream", "UserModel", "make_population",
           "D1_DIM", "StackedRequestStream", "binomial_arrivals_batched",
           "dataset_layout", "draw_arrival_batch", "load_streams_state",
           "pad_arrival_batch", "streams_state_dict"]
