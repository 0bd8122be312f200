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

A mesh with a ``'model'`` axis of M > 1 columns (``launch/mesh``) lays
its R x M ranks out row-major: rank = row * M + column. The client-row
collectives above then run over the R ranks of this rank's model column
(each column is a whole replica of the client rows), and the model-axis
collectives over the M ranks of this rank's row: ``model_sum`` (in rank
order, as ``row_sum``) and ``model_cat``. ``model_axis(mesh)`` gives the
tensor-parallel layers their axis, with the four autograd crossings of a
Megatron-style layer: ``copy_in`` (identity forward, ``model_sum``
backward), ``reduce_out`` (``model_sum`` forward, identity backward),
``gather`` (``model_cat`` forward, this rank's slice backward) and
``split`` (this rank's slice forward, ``model_cat`` backward). Both kinds
of subgroup are made once per mesh (``dist.new_group``, by
``make_groups``); a mesh of one column uses the default group as before.

``record_collectives()`` logs every collective of this module (its kind,
axis and the bytes it gathers) while it is open: the dry run reads its
collective traffic from it.
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


def model_columns(mesh) -> int:
    """The mesh's ``'model'`` axis size (1 without one or without a
    mesh)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get("model", 1))


def check_ranks(mesh) -> None:
    """A mesh of R client rows and M model columns, R * M > 1, needs a
    process group of R * M ranks, one per (row, column); raises
    ``ValueError`` otherwise."""
    rows, cols = client_rows(mesh), model_columns(mesh)
    ranks = _mesh_ranks(mesh)
    if rows * cols > 1 and ranks != rows * cols:
        raise ValueError(
            f"a mesh of {rows} client rows and {cols} model column(s) runs "
            f"as {rows * cols} processes, one per (row, column), in a "
            "torch.distributed process group (torchrun, or "
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
# collectives over the client rows (the ranks of this rank's model column)
# ---------------------------------------------------------------------------

def make_groups(rows: int, cols: int) -> tuple:
    """This rank's (column group, row group) of an R x M layout laid out
    row-major over the default group's ranks: the column group holds the
    R ranks of its model column, the row group the M ranks of its client
    row. Every rank makes every group, in the same order, as
    ``dist.new_group`` requires."""
    rank = dist.get_rank()
    col_group = row_group = None
    for c in range(cols):
        g = dist.new_group(list(range(c, rows * cols, cols)))
        if rank % cols == c:
            col_group = g
    for r in range(rows):
        g = dist.new_group(list(range(r * cols, (r + 1) * cols)))
        if rank // cols == r:
            row_group = g
    return col_group, row_group


def _groups(mesh) -> tuple:
    """(column group, row group) of the mesh; (None, None) where it has
    one model column (the default group then holds the rows). A mesh may
    also be laid over a subgroup of the ranks: ``(its rows' group,
    None)`` for one column."""
    return getattr(mesh, "groups", None) or (None, None)


def _mesh_ranks(mesh) -> int:
    """The ranks the mesh runs on: its own groups' where it has them,
    else the default group's (1 with none)."""
    if not grouped():
        return 1
    col_group, row_group = _groups(mesh)
    if col_group is None:
        return dist.get_world_size()
    return dist.get_world_size(col_group) * (
        1 if row_group is None else dist.get_world_size(row_group))


_LOGS: list = []


@contextlib.contextmanager
def record_collectives():
    """Log each collective of this module while open: yields a list that
    fills with ``{"kind", "axis", "bytes"}``, ``bytes`` those a rank
    receives (the gathered parts), ``kind`` the reference's name for what
    the call computes ("all-reduce" for the rank-ordered sums,
    "all-gather" for the concatenations and gathers)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _note(kind: str, axis: str, parts: list) -> None:
    for log in _LOGS:
        log.append({"kind": kind, "axis": axis,
                    "bytes": sum(p.numel() * p.element_size()
                                 for p in parts)})


def _gather(x: torch.Tensor, group, kind: str, axis: str) -> list:
    """Every rank's ``x`` in ``group``, in rank order (``all_gather``)."""
    flat = x.reshape(-1).contiguous()
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    _note(kind, axis, parts)
    return [p.reshape(x.shape) for p in parts]


def _parts(x: torch.Tensor, mesh, kind: str = "all-gather") -> list:
    """Every rank's ``x`` along the client rows (the ranks of this rank's
    model column), in rank order, or None with no mesh or no process
    group."""
    if mesh is None or not grouped():
        return None
    return _gather(x, _groups(mesh)[0], kind, "rows")


def row_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the client rows of each rank's ``x``, added in rank
    order (every rank gets the same bits)."""
    parts = _parts(x, mesh, "all-reduce")
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
    parts = _parts(x, mesh, "all-reduce")
    return x if parts is None else torch.stack(parts).amax(dim=0)


def row_min(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise minimum over the client rows of each rank's ``x``."""
    parts = _parts(x, mesh, "all-reduce")
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


# ---------------------------------------------------------------------------
# collectives over the model axis (the M ranks of one client row)
# ---------------------------------------------------------------------------

def _sum(parts: list) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class ModelAxis:
    """The ``'model'`` axis of a mesh as this rank sees it: ``size``
    columns, this rank's ``index`` and the ``group`` of its row's ranks.
    Plain collectives (``sum``, ``cat``, ``max``) and the autograd
    crossings of a tensor-parallel layer (``copy_in``, ``reduce_out``,
    ``gather``, ``split``, and the summing ``gather_in``)."""

    def __init__(self, size: int, index: int, group):
        self.size, self.index, self.group = int(size), int(index), group

    def parts(self, x: torch.Tensor, kind: str) -> list:
        return _gather(x, self.group, kind, "model")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every column's ``x``, added in rank order."""
        return _sum(self.parts(x, "all-reduce"))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self.parts(x, "all-reduce")).amax(dim=0)

    def cat(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every column's ``x`` concatenated along ``dim`` in rank
        order."""
        return torch.cat(self.parts(x, "all-gather"), dim=dim)

    def slice(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This column's equal part of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not split over "
                             f"{self.size} model columns")
        w = n // self.size
        return x.narrow(dim, self.index * w, w)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Into the model region: ``x`` as it is, its gradient summed over
        the columns."""
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """Out of the model region: the columns' partial ``x`` summed, the
        gradient passed on as it is."""
        return _ReduceOut.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The columns' parts concatenated; the gradient's own part
        back."""
        return _Gather.apply(x, self, dim)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This column's part of an ``x`` every column holds whole; the
        columns' gradients concatenated back."""
        return _Split.apply(x, self, dim)

    def gather_in(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The columns' parts concatenated into the model region, where
        each column goes on to use its own part of the whole (a packed
        projection cut across its segments): the gradient is summed over
        the columns before this column's part is taken (``copy_in`` after
        ``gather``)."""
        return self.copy_in(self.gather(x, dim))


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum(g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.cat(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.slice(g, ctx.dim).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.slice(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.cat(g, ctx.dim), None, None


def model_axis(mesh):
    """The mesh's ``ModelAxis`` for this rank, or None where the mesh has
    one model column (or there is no mesh): every layer then runs whole,
    with no collective."""
    cols = model_columns(mesh)
    if cols == 1:
        return None
    if not grouped():
        raise ValueError(f"a mesh of {cols} model columns runs as one "
                         "torch.distributed rank a column")
    return ModelAxis(cols, mesh.col, _groups(mesh)[1])


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over this row's model columns of each rank's ``x``, added
    in rank order (every column gets the same bits); ``x`` with one
    column."""
    axis = model_axis(mesh)
    return x if axis is None else axis.sum(x)


def model_cat(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Each column's ``x`` concatenated along ``dim`` in rank order; ``x``
    with one column."""
    axis = model_axis(mesh)
    return x if axis is None else axis.cat(x, dim)
