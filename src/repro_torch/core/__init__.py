"""Server, client, buffer and resource layers of the port, the pod engines
and the transformer zoo's serving steps (``pod.py``), with the reference's
re-exports (``repro/core/__init__.py``)."""
from repro_torch.core.osafl import ClientUpdate, OSAFLServer, StackedOSAFLServer
from repro_torch.core.baselines import make_server
from repro_torch.core.client import local_train, make_vmapped_local_train
from repro_torch.core.buffer import OnlineBuffer, binomial_arrivals
from repro_torch.core.buffer_stacked import StackedOnlineBuffer
from repro_torch.core.flatten import FlatCodec, make_codec
from repro_torch.core.resource_stacked import (ClientSystemBatch,
                                               optimize_clients_batched,
                                               optimize_round_batched,
                                               sample_channels, stack_clients)

__all__ = ["ClientUpdate", "OSAFLServer", "StackedOSAFLServer", "make_server",
           "local_train", "make_vmapped_local_train", "OnlineBuffer",
           "binomial_arrivals", "StackedOnlineBuffer", "FlatCodec",
           "make_codec", "ClientSystemBatch", "optimize_clients_batched",
           "optimize_round_batched", "sample_channels", "stack_clients"]
