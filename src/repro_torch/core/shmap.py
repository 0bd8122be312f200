"""The client-axis conventions of a mesh (``repro/core/shmap.py``), one
card's part.

Cohort rows map onto the ``('pod', 'data')`` client axes of a mesh:

  * ``client_axes(mesh)``: the subset of ('pod', 'data') present on a mesh;
    every ``(U, ...)`` cohort array is split over exactly these axes.
  * ``client_rows(mesh)``: the number of shards the client dimension is cut
    into (U must be a multiple; each shard holds U / rows whole clients).

A mesh is anything with ``axis_names`` and a ``shape`` mapping each name
to its size: the port's one-card mesh (``launch/mesh.make_host_mesh``)
or the reference's. The reference's ``shard_map``, ``use_mesh`` and
``client_sharding`` place arrays on the devices of a mesh; on one card,
one client row, there is nothing to place, and across cards they come
with ``torch.distributed`` (ROADMAP.md A6).
"""
from __future__ import annotations


def client_axes(mesh) -> tuple:
    """The mesh axes the client (cohort) dimension is split over."""
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def client_rows(mesh) -> int:
    """Number of client-axis shards (devices along the client axes)."""
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n
