"""Device meshes of the port (``repro/launch/mesh.py``), one card's form.

``make_host_mesh()`` is the reference's smoke-test mesh on one card: one
client row on one device, axes ``('data', 'model')``, shape (1, 1). It is
a plain object with the reference's ``axis_names``, ``devices`` and
``shape``, so ``core/shmap.client_rows`` reads it and a ``"pod"`` snapshot
records ``mesh_axes`` ``["data", "model"]`` and ``mesh_shape`` ``[1, 1]``,
as the reference's 1 x 1 mesh writes them. It holds no process group:
tensor parallelism over a ``'model'`` axis and client rows across cards
come with ``torch.distributed`` (ROADMAP.md A6, A7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """``devices``: an object array of shape (client rows, model) holding
    ``torch.device``s, or ``None`` for "the device the run is given"."""
    devices: np.ndarray
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """The one device of a one-device mesh (``None``: the run's)."""
        if self.devices.size != 1:
            raise ValueError(f"a mesh of {self.devices.size} devices has no "
                             "single device")
        return self.devices.flat[0]


def _devices(shape: tuple, device) -> np.ndarray:
    out = np.empty(shape, dtype=object)
    out.fill(None if device is None else torch.device(device))
    return out


def make_host_mesh(model_parallel: int = 1, device=None) -> HostMesh:
    """One client row on one device: axes ``('data', 'model')``, shape
    (1, 1). ``device=None`` leaves the device to the run, where ``None``
    means the CUDA device (``repro_torch.harness.run(..., device=)``); a
    device given here is the run's unless the run names another."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the port's mesh is one card, "
            "one client row and no tensor-parallel axis; a 'model' axis "
            "across cards comes with torch.distributed (ROADMAP.md A6, A7)")
    return HostMesh(_devices((1, 1), device))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) or (2, 16, 16) TPU mesh, which one card
    cannot hold."""
    raise NotImplementedError(
        "make_production_mesh lays clients and the model over 256 or 512 "
        "devices; the port runs on one card, one client row "
        "(make_host_mesh). Meshes across cards come with torch.distributed "
        "(ROADMAP.md A6, A7)")
