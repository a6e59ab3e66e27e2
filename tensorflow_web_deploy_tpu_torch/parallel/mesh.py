"""Device meshes (counterpart of the JAX package's ``parallel/mesh.py``):
the serving mesh and the training mesh.

The reference builds a ``jax.sharding.Mesh`` over the slice's chips and
lets XLA shard each batch along its ``('data', 'model')`` axes. The port has
no compiler to do that: a mesh is an ordered tuple of ``torch.device``\\ s,
and the engine splits a batch's rows over a replica's devices itself
(``serving/engine.py``). A group of devices serves batches in multiples of
its size, as a sharded batch does in the reference.

On the CPU a mesh is a list of CPU entries (``torch.device("cpu", i)``):
each entry gets its own copy of the weights, so that routing, row splits,
drain and hot swap run for real, as the reference's tests run on its
virtual 8-device CPU mesh.

The training mesh (:func:`train_mesh`, :class:`RankMesh`) is the
reference's ``('data', 'model')`` grid laid over the ranks of the process
group, one device a rank (``parallel/distributed.py``): rank
``d·model + m`` holds data replica ``d``, model shard ``m``. The batch
shards over ``'data'`` alone; :func:`shard_params_tp` and
``train/trainer.py::partition_variables`` say which weights shard their
output dimension over ``'model'``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .distributed import maybe_initialize, rank_device


def build_mesh(devices=None) -> tuple[torch.device, ...]:
    """The mesh over ``devices`` (any ``torch.device`` spellings), in order;
    ``None``: every visible CUDA device. Raises ValueError on an empty or
    repeated device list and RuntimeError when no card is visible."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or CPU devices for a mesh) "
                "to run on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len(set(mesh)) != len(mesh):
        raise ValueError(f"repeated device in mesh {[str(d) for d in mesh]}")
    return mesh


def cpu_mesh(n: int) -> tuple[torch.device, ...]:
    """``n`` CPU entries, ``cpu:0`` … ``cpu:{n-1}`` (tests and CPU drives)."""
    return build_mesh([torch.device("cpu", i) for i in range(n)])


def mesh_for(device=None) -> tuple[torch.device, ...]:
    """The mesh an entry point serves on: every visible CUDA device for
    ``None`` or ``"cuda"``, else the one device named (``"cpu"``,
    ``"cuda:1"``)."""
    if device is None or str(device) == "cuda":
        return build_mesh()
    dev = torch.device(device)
    return build_mesh([resolve_device(dev)])


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This rank's place in the ``('data', 'model')`` grid: the axes'
    sizes, its global rank, its device, and the two groups it belongs to
    (``data_group``: the ranks of its model shard across the data
    replicas; ``model_group``: the ranks of its data replica)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` (a multiple of
        :func:`batch_multiple`): its data replica's contiguous share."""
        n = batch // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)


def train_mesh(model_axis: int = 1, device=None) -> RankMesh:
    """The ``('data', 'model')`` mesh over every rank of the process group
    (joined first through ``distributed.maybe_initialize(device)``), with
    ``model_axis`` ranks on ``'model'``. Raises the reference's ValueError
    when ``model_axis`` does not divide the ranks, and RuntimeError with no
    process group to join. Every rank must call it, in the same order."""
    if not maybe_initialize(device):
        raise RuntimeError(
            "a training mesh spans the ranks of a process group: set TPU_SERVE_COORDINATOR, "
            "TPU_SERVE_PROCESS_ID and TPU_SERVE_NUM_PROCESSES, or start under torchrun")
    n, rank = dist.get_world_size(), dist.get_rank()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    d = n // model_axis
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(model_axis):
        g = dist.new_group([i * model_axis + m for i in range(d)])
        if rank % model_axis == m:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * model_axis + m for m in range(model_axis)])
        if rank // model_axis == i:
            model_group = g
    return RankMesh(d, model_axis, rank, rank_device(device, rank), data_group, model_group)


def batch_multiple(mesh: RankMesh) -> int:
    """Smallest global batch that shards evenly over the mesh: the data
    axis's size (the batch shards over ``'data'`` alone)."""
    return mesh.data


def shard_params_tp(mesh: RankMesh, params: dict, matmul_names: set[str]) -> dict[str, int | None]:
    """Which weights shard over ``'model'``: each 2-D matmul weight named
    in ``matmul_names`` on its output dimension (dim 0 of torch's [out,
    in]), everything else replicated (None). With ``model == 1`` nothing
    shards."""
    return {name: 0 if (mesh.model > 1 and name in matmul_names
                        and getattr(v, "ndim", 0) == 2) else None
            for name, v in params.items()}
