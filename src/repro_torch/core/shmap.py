"""The client-axis conventions of a mesh (``repro/core/shmap.py``), as
``torch.distributed`` runs them: one process per client row.

Cohort rows map onto the ``('pod', 'data')`` client axes of a mesh:

  * ``client_axes(mesh)``: the subset of ('pod', 'data') present on a mesh;
    every ``(U, ...)`` cohort array is split over exactly these axes.
  * ``client_rows(mesh)``: the number of shards the client dimension is cut
    into (U must be a multiple; each shard holds U / rows whole clients).
  * ``client_sharding(mesh, ndim)``: this process's block of a ``(U, ...)``
    cohort array, as a row range (``ClientSharding.bounds``).

A mesh is anything with ``axis_names`` and a ``shape`` mapping each name
to its size: the port's host mesh (``launch/mesh.make_host_mesh``) or the
reference's. On R > 1 rows each row is one rank of the default process
group, which the caller starts (``torchrun``, or
``torch.multiprocessing.spawn`` with ``init_process_group``) with any
backend: NCCL across cards, gloo on the CPU or for ranks sharing a card.

``row_take`` brings rows owned by different ranks (the sparse cohort's
per-user tables, split over the ranks by user) to every rank in one
``all_gather``.

Every cross-row reduction here runs in a fixed order: ``row_sum`` gathers
each rank's partial (the list form of ``all_gather``) and adds them in
rank order, so gloo and NCCL sum alike and reruns repeat bit for bit. On
one row with no process group each collective is the identity; in a
group of one rank it is an ``all_gather`` of one part, the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


def client_axes(mesh) -> tuple:
    """The mesh axes the client (cohort) dimension is split over."""
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def client_rows(mesh) -> int:
    """Number of client-axis shards (devices along the client axes)."""
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n


def grouped() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def client_row(mesh) -> int:
    """This process's client row: the mesh's ``row`` where it has one,
    else the rank in the default process group (0 with none)."""
    row = getattr(mesh, "row", None)
    if row is not None:
        return int(row)
    return dist.get_rank() if grouped() else 0


def check_ranks(mesh) -> None:
    """A mesh of R > 1 client rows needs a process group of R ranks, one
    per row; raises ``ValueError`` otherwise."""
    rows = client_rows(mesh)
    ranks = dist.get_world_size() if grouped() else 1
    if rows > 1 and ranks != rows:
        raise ValueError(
            f"a mesh of {rows} client rows runs as {rows} processes, one "
            "per row, in a torch.distributed process group (torchrun, or "
            "torch.multiprocessing.spawn and init_process_group); this "
            f"process's group has {ranks} rank(s)")


@dataclasses.dataclass(frozen=True)
class ClientSharding:
    """The client-row layout of a ``(U, ...)`` cohort array: ``rows``
    blocks of U / rows whole clients, this process holding block ``row``;
    every trailing dimension is whole on every row."""
    rows: int
    row: int
    ndim: int = 1

    def bounds(self, U: int) -> tuple:
        """This row's ``(lo, hi)`` of a U-client dimension."""
        U = int(U)
        if U % self.rows:
            raise ValueError(
                f"cohort size {U} is not divisible by the mesh's "
                f"{self.rows} client rows; each shard must own whole "
                "clients")
        n = U // self.rows
        return self.row * n, (self.row + 1) * n

    def block(self, x):
        """This row's rows of ``x``, a ``(U, ...)`` array (a view)."""
        if x.ndim != self.ndim:
            raise ValueError(f"a {self.ndim}-d cohort array was expected, "
                             f"got shape {tuple(x.shape)}")
        lo, hi = self.bounds(x.shape[0])
        return x[lo:hi]


def client_sharding(mesh, ndim: int = 1) -> ClientSharding:
    """This process's block of a ``(U, ...)``-leading cohort array of
    ``ndim`` dimensions: the leading (client) dimension split over the
    mesh's client axes, every trailing dimension whole. One definition
    shared by the sharded FIFO buffer (``core/buffer_stacked.py``), the
    servers' contribution buffers and the pod steps."""
    if not client_axes(mesh):
        raise ValueError(
            f"mesh {mesh} has no client axis (expected 'pod' or 'data' "
            f"in {mesh.axis_names})")
    return ClientSharding(client_rows(mesh), client_row(mesh), int(ndim))


def use_mesh(mesh):
    """The reference's ambient-mesh context. Here every rank runs its own
    program on its own rows and each function is handed its mesh, so
    there is no ambient mesh to set: a context that does nothing."""
    return contextlib.nullcontext(mesh)


def shard_map(f, *, mesh, in_specs=None, out_specs=None, axis_names=None):
    """The reference's ``shard_map``. It runs ``f`` on each shard's block
    of its row-split inputs; here each rank already holds its block (the
    buffer's storage rows, its slots and kappas), so ``f`` is called as
    it is, on this rank's blocks, and its cross-row sums are the
    collectives of this module. Returns ``f``."""
    del mesh, in_specs, out_specs, axis_names
    return f


# ---------------------------------------------------------------------------
# collectives over the client rows (the default process group)
# ---------------------------------------------------------------------------

def _parts(x: torch.Tensor, mesh) -> list:
    """Every rank's ``x``, in rank order (``all_gather``), or None with no
    mesh or no process group."""
    if mesh is None or not grouped():
        return None
    flat = x.reshape(-1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return [p.reshape(x.shape) for p in parts]


def row_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the client rows of each rank's ``x``, added in rank
    order (every rank gets the same bits)."""
    parts = _parts(x, mesh)
    if parts is None:
        return x
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def row_cat(x: torch.Tensor, mesh) -> torch.Tensor:
    """Each rank's rows of a ``(U / R, ...)`` block, concatenated in rank
    order into the whole ``(U, ...)`` array."""
    parts = _parts(x, mesh)
    return x if parts is None else torch.cat(parts, dim=0)


def row_take(x: torch.Tensor, owner, mesh) -> torch.Tensor:
    """Rows that live on different ranks, brought to every rank with one
    ``all_gather``: ``x`` is (n, ...) with row i filled by the rank
    ``owner[i]`` (each rank fills the rows it owns, anything elsewhere);
    returns row i of rank ``owner[i]``'s ``x``, the same bits on every
    rank. ``x`` itself with no mesh or no process group."""
    parts = _parts(x, mesh)
    if parts is None:
        return x
    owner = torch.as_tensor(owner, dtype=torch.long, device=x.device)
    stacked = torch.stack(parts)
    return stacked[owner, torch.arange(x.shape[0], device=x.device)]


def row_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum over the client rows of each rank's ``x``."""
    parts = _parts(x, mesh)
    return x if parts is None else torch.stack(parts).amax(dim=0)


def row_min(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise minimum over the client rows of each rank's ``x``."""
    parts = _parts(x, mesh)
    return x if parts is None else torch.stack(parts).amin(dim=0)


def row_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over all U clients of a ``(U, ...)`` array whose rows the
    ranks hold in equal blocks, each rank passing its block ``x``: on one
    row ``torch.mean(x, 0)`` as it is; across R rows the rank-ordered sum
    of each rank's column sums, over U."""
    R = 1 if mesh is None else client_rows(mesh)
    if R == 1:
        return row_sum(torch.mean(x, dim=0), mesh)
    return row_sum(torch.sum(x, dim=0), mesh) / (x.shape[0] * R)
