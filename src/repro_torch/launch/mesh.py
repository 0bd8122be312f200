"""Device meshes of the port (``repro/launch/mesh.py``).

``make_host_mesh()`` is the reference's "mesh over whatever devices
exist": one client row per rank of the default ``torch.distributed``
process group, axes ``('data', 'model')``, shape (R, 1), and one row on
one device when no group is running. It is a plain object with the
reference's ``axis_names``, ``devices`` and ``shape``, so
``core/shmap.client_rows`` reads it and a ``"pod"`` snapshot records
``mesh_axes`` ``["data", "model"]`` and ``mesh_shape`` ``[R, 1]``, as the
reference's mesh writes them. Each rank knows its own ``row`` and device.

Start R ranks with ``torchrun --nproc-per-node R`` (each then calls
``torch.distributed.init_process_group``) or with
``torch.multiprocessing.spawn``; any backend serves (NCCL across cards,
gloo on the CPU or for ranks that share a card). Tensor parallelism over a
``'model'`` axis and the production meshes are ROADMAP.md A7.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.shmap import grouped


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """``devices``: an object array of shape (client rows, model) holding
    ``torch.device``s, or ``None`` for "the device the run is given" (and,
    under a process group, for the other ranks' devices, which this
    process does not know). ``row`` is this process's client row."""
    devices: np.ndarray
    axis_names: tuple = ("data", "model")
    row: int = 0

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """This process's device (``None``: the run's)."""
        if self.devices.size != self.devices.shape[0]:
            raise ValueError(f"a mesh of shape {self.shape} has more than "
                             "one device a row")
        return self.devices.flat[self.row]


def make_host_mesh(model_parallel: int = 1, device=None) -> HostMesh:
    """One client row per rank of the default process group, axes
    ``('data', 'model')``, shape (R, 1); with no group, one row, shape
    (1, 1). Under a group this rank's device is ``device`` or, when it is
    ``None``, ``cuda:LOCAL_RANK`` (the rank where ``LOCAL_RANK`` is not
    set); with no group ``device=None`` leaves the device to the run,
    where ``None`` means the CUDA device (``repro_torch.harness.run(...,
    device=)``)."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism over a "
            "'model' axis is not ported (ROADMAP.md A7); the port's mesh "
            "lays client rows over ranks, one model column")
    if not grouped():
        out = np.empty((1, 1), dtype=object)
        out.fill(None if device is None else torch.device(device))
        return HostMesh(out)
    import torch.distributed as dist
    rows, row = dist.get_world_size(), dist.get_rank()
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", row)))
    out = np.full((rows, 1), None, dtype=object)
    out[row, 0] = torch.device(device)
    return HostMesh(out, row=row)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) or (2, 16, 16) TPU mesh, clients over the
    rows and the model over 16 columns."""
    raise NotImplementedError(
        "make_production_mesh lays the model over a 'model' axis of 16 "
        "devices, which is not ported (ROADMAP.md A7); client rows run on "
        "make_host_mesh(), one per torch.distributed rank")
