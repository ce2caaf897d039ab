"""The (data, model) mesh over the ranks of a ``torch.distributed`` group and
the placements of batches and parameters on it (counterpart of
artspeech_tpu/parallel/mesh.py).

The port runs one process per rank (``python -m torch.distributed.run``); a
rank's device is ``cuda:LOCAL_RANK`` on the card. The mesh lays the group's
ranks out row-major as a (data, model) grid, as JAX reshapes its devices:

- ``data`` axis: each data row holds a contiguous slice of the batch's rows
  (JAX's ``P("data")``); gradients and loss sums are all-reduced over the
  ranks that share a model coordinate (``Mesh.data_group``).
- ``model`` axis: the ranks of one data row hold the same rows; the stacked
  (Nart, ...) parameters of the ArtSpeech heads (``models/heads.py``) and the
  (C, ...) / (C, C-1, ...) channel stacks of the transformer's decoder
  (``models/transformer.py``) split over them, each rank computing its own
  heads or channels, the activations gathered over ``Mesh.model_group``
  where every channel is needed (``parallel/collectives.py``).

Without an initialised process group every mesh is the one-rank mesh with no
groups, and every collective of ``parallel/collectives.py`` is the identity.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> Tuple[int, int]:
    """(world size, this process's rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of global ranks and this rank's place in it.

    ``group`` spans the grid, ``data_group`` the ranks of this rank's model
    column (the gradient all-reduce), ``model_group`` those of its data row
    (the heads' gather); each is None without a process group.
    """

    grid: np.ndarray  # (data, model) global ranks
    rank: int
    device: torch.device
    group: object = None
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: int(self.grid.shape[0]), MODEL_AXIS: int(self.grid.shape[1])}

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def coords(self) -> Optional[Tuple[int, int]]:
        """(data index, model index) of this rank, None if it is not in the grid."""
        where = np.argwhere(self.grid == self.rank)
        return None if len(where) == 0 else (int(where[0][0]), int(where[0][1]))

    @property
    def data_index(self) -> int:
        return self._coords()[0]

    @property
    def model_index(self) -> int:
        return self._coords()[1]

    def _coords(self) -> Tuple[int, int]:
        coords = self.coords
        if coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.grid.tolist()}")
        return coords


def _new_group(members, n_world: int):
    """A process group of ``members``; the default group when they are all
    ranks. Every rank must call it, in the same order, for every group."""
    members = [int(r) for r in members]
    if members == list(range(n_world)):
        return dist.group.WORLD
    group = dist.new_group(members)
    return group if dist.get_rank() in members else None


def make_mesh(ranks: Optional[Sequence[int]] = None, model_parallel: int = 1,
              device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over ``ranks`` (all ranks of the group by
    default), laid out row-major. Raises ``ValueError`` when their count is
    not a multiple of ``model_parallel``. With a process group, every rank of
    it must call this with the same arguments (``dist.new_group`` is
    collective)."""
    n_world, rank = world()
    ranks = list(range(n_world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    grid = np.asarray(ranks, dtype=np.int64).reshape(n // model_parallel, model_parallel)
    dev = _rank_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(grid=grid, rank=rank, device=dev)
    group = _new_group(ranks, n_world)
    data_group = model_group = None
    for column in grid.T:
        g = _new_group(column, n_world)
        if rank in column:
            data_group = g
    for row in grid:
        g = _new_group(row, n_world)
        if rank in row:
            model_group = g
    return Mesh(grid=grid, rank=rank, device=dev, group=group, data_group=data_group,
                model_group=model_group)


def data_parallel_mesh(batch_size: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """The default training mesh: data parallelism over the group's ranks.
    With ``batch_size`` the data axis takes the largest rank count that
    divides it (JAX's rule), so one rank is the one-rank mesh; loaders built
    with ``pad_to_multiple=`` the world size make every rank take part."""
    n, _ = world()
    if batch_size:
        bs = int(batch_size)
        n = next((d for d in range(n, 0, -1) if bs % d == 0), 1)
    return make_mesh(range(n), model_parallel=1, device=device)


@dataclass(frozen=True, eq=False)
class Sharding:
    """A placement on a mesh: the leading axis split over ``axis``
    (``DATA_AXIS`` or ``MODEL_AXIS``), or replicated (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str] = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of a leading axis of ``n``."""
        if self.axis is None:
            return slice(0, n)
        index = self.mesh.data_index if self.axis == DATA_AXIS else self.mesh.model_index
        return part_rows(n, index, self.mesh.shape[self.axis])


def part_rows(n: int, index: int, size: int) -> slice:
    """The ``index``-th of ``size`` contiguous parts of an axis of ``n``;
    raises ``ValueError`` when ``size`` does not divide ``n``."""
    if n % size:
        raise ValueError(f"axis {n} does not split into {size} parts")
    step = n // size
    return slice(index * step, (index + 1) * step)


def keep_model_slice_(params, index: int, size: int, optimizer=None) -> None:
    """Keep, in place, the ``index``-th of ``size`` contiguous slices of
    every parameter's leading axis and, given the ``optimizer``, of each
    moment it holds for one (AdamW's ``exp_avg`` / ``exp_avg_sq``; its step
    count is a scalar and stays). The parameters stay the objects the
    optimizer holds. A stacked module's ``shard_model_axis`` calls it with
    its model rank's coordinate (``parallel/distributed.distribute_state``)."""
    with torch.no_grad():
        for p in params:
            rows = part_rows(p.shape[0], index, size)
            moments = {} if optimizer is None else optimizer.state.get(p, {})
            for key, value in moments.items():
                if torch.is_tensor(value) and value.shape == p.shape:
                    moments[key] = value[rows].clone()
            p.data = p.data[rows].clone()


def batch_sharding(mesh: Mesh) -> Sharding:
    """The batch's leading axis over ``data`` (JAX's ``P("data")``)."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _leaves(params, prefix: str = ""):
    if isinstance(params, torch.nn.Module):
        yield from params.named_parameters()
    elif isinstance(params, dict):
        for key, value in params.items():
            yield from _leaves(value, f"{prefix}{key}/" if isinstance(value, dict) else
                               f"{prefix}{key}")
    else:
        yield prefix, params


def params_shardings(params, mesh: Mesh) -> Dict[str, Sharding]:
    """A placement per parameter, by JAX's heuristic: one with ``ndim >= 2``
    whose leading axis is at least the model-axis size and a multiple of it
    shards that axis over ``model``; every other one is replicated.

    ``params``: a module (names from ``named_parameters``) or a dict of
    arrays or tensors, nested dicts named by their ``/``-joined keys.
    """
    model_size = mesh.shape[MODEL_AXIS]

    def spec_for(x) -> Sharding:
        shape = tuple(getattr(x, "shape", ()))
        if model_size > 1 and len(shape) >= 2 and shape[0] >= model_size \
                and shape[0] % model_size == 0:
            return Sharding(mesh, MODEL_AXIS)
        return Sharding(mesh, None)

    return {name: spec_for(x) for name, x in _leaves(params)}


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """A host batch dict as tensors on the rank's device, each array's
    leading axis cut to this rank's rows over ``data`` (replicated over
    ``model``)."""
    sharding = batch_sharding(mesh)
    out = {}
    for key, value in batch.items():
        value = torch.as_tensor(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) \
            else torch.as_tensor(value)
        out[key] = value[sharding.rows(value.shape[0])].to(mesh.device)
    return out
