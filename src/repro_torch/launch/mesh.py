"""Device meshes of the port (``repro/launch/mesh.py``).

A mesh is a plain object with the reference's ``axis_names``, ``devices``
and ``shape``, so ``core/shmap.client_rows`` reads it and a ``"pod"``
snapshot records ``mesh_axes`` and ``mesh_shape`` as the reference's mesh
writes them. Each process is one device of it, one rank of the default
``torch.distributed`` process group, laid out row-major: rank = row * M +
column over the client rows (``'pod'``, ``'data'``) and the M columns of
the ``'model'`` axis. Each rank knows its own ``row``, ``col`` and device.

``make_host_mesh(model_parallel=M)`` is the reference's "mesh over
whatever devices exist": ``('data', 'model')`` of shape (R, M) over a
group of R * M ranks, and one row on one device when no group is running
(M = 1 only). ``make_production_mesh`` is the reference's (16, 16) mesh
over ``('data', 'model')`` or its (2, 16, 16) over ``('pod', 'data',
'model')``, over a group of 256 or 512 ranks (the dry run makes one on
PyTorch's ``fake`` backend, ``launch/dryrun.py``). With M > 1 the mesh
carries this rank's column and row subgroups (``shmap.make_groups``): the
client-row collectives run down its column, the model-axis ones along its
row, and ``models/transformer.py`` splits the dense decoders' parameters
over the columns (``launch/sharding.py``'s rules).

Start the ranks with ``torchrun --nproc-per-node R*M`` (each then calls
``torch.distributed.init_process_group``) or with
``torch.multiprocessing.spawn``; any backend serves (NCCL across cards,
gloo on the CPU or for ranks that share a card).
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.core.shmap import grouped, make_groups


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """``devices``: an object array of the mesh's shape holding
    ``torch.device``s, or ``None`` for "the device the run is given" (and,
    under a process group, for the other ranks' devices, which this
    process does not know). ``row`` is this process's client row, ``col``
    its model column; ``groups`` its (column, row) process subgroups where
    the mesh has more than one model column."""
    devices: np.ndarray
    axis_names: tuple = ("data", "model")
    row: int = 0
    col: int = 0
    groups: tuple = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def rank(self) -> int:
        """This process's rank in the row-major layout."""
        return self.row * self.shape.get("model", 1) + self.col

    @property
    def device(self):
        """This process's device (``None``: the run's)."""
        return self.devices.flat[self.rank]


def make_mesh(shape: tuple, axis_names: tuple, device=None) -> HostMesh:
    """The mesh of ``shape`` over ``axis_names`` (the reference's
    ``jax.make_mesh``) over the running group, which must have exactly as
    many ranks as the mesh has devices (``ValueError`` otherwise); a last
    axis ``'model'`` is the model columns, every other axis client rows."""
    need = math.prod(shape)
    if not grouped():
        raise ValueError(
            f"a mesh of shape {dict(zip(axis_names, shape))} runs as {need} "
            "processes, one per device, in a torch.distributed process "
            "group (torchrun, or torch.multiprocessing.spawn and "
            "init_process_group); none is running")
    import torch.distributed as dist
    ranks, rank = dist.get_world_size(), dist.get_rank()
    if ranks != need:
        raise ValueError(
            f"a mesh of shape {dict(zip(axis_names, shape))} runs as {need} "
            "processes, one per device, in a torch.distributed process "
            f"group; this process's group has {ranks} rank(s)")
    cols = shape[-1] if axis_names[-1] == "model" else 1
    row, col = divmod(rank, cols)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    devices = np.full(shape, None, dtype=object)
    devices.flat[rank] = torch.device(device)
    groups = make_groups(need // cols, cols) if cols > 1 else None
    return HostMesh(devices, tuple(axis_names), row=row, col=col,
                    groups=groups)


def make_host_mesh(model_parallel: int = 1, device=None) -> HostMesh:
    """``('data', 'model')`` of shape (R, M), M = ``model_parallel``, over
    the default process group of R * M ranks (``ValueError`` when its size
    is not a multiple of M); with no group and M = 1, one row, shape (1,
    1). Under a group this rank's device is ``device`` or, when it is
    ``None``, ``cuda:LOCAL_RANK`` (the rank where ``LOCAL_RANK`` is not
    set); with no group ``device=None`` leaves the device to the run,
    where ``None`` means the CUDA device (``repro_torch.harness.run(...,
    device=)``)."""
    M = int(model_parallel)
    if M < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if not grouped() and M == 1:
        out = np.empty((1, 1), dtype=object)
        out.fill(None if device is None else torch.device(device))
        return HostMesh(out)
    import torch.distributed as dist
    ranks = dist.get_world_size() if grouped() else 1
    if ranks % M:
        raise ValueError(
            f"model_parallel={M} lays the ranks out as R x {M}: it needs a "
            f"torch.distributed process group of a multiple of {M} ranks, "
            f"one per (row, column); this process has {ranks}")
    return make_mesh((ranks // M, M), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> HostMesh:
    """The reference's production mesh: (16, 16) over ``('data',
    'model')``, or (2, 16, 16) over ``('pod', 'data', 'model')`` with
    ``multi_pod``, over a process group of 256 or 512 ranks
    (``ValueError`` otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
