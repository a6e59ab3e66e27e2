"""Device meshes (counterpart of the JAX package's ``parallel/mesh.py``).

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
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device


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
