"""Joining the ranks of a multi-process run (counterpart of the JAX
package's ``parallel/distributed.py``).

The reference runs one SPMD program per host and joins the hosts with
``jax.distributed.initialize()``. The port runs one process per device,
joined by ``torch.distributed``: NCCL between CUDA devices, gloo between
CPU ranks, never one in place of the other. :func:`maybe_initialize` is
the bootstrap every training entry point calls before its first device
use. Without the environment below it does nothing, so a one-device run
pays nothing.

Triggers, checked in order:

- ``TPU_SERVE_COORDINATOR`` (host:port) with ``TPU_SERVE_PROCESS_ID`` and
  ``TPU_SERVE_NUM_PROCESSES``: the reference's explicit bootstrap. Rank 0
  serves the rendezvous store at the coordinator's address
  (``init_method="tcp://<coordinator>"``).
- torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (``init_method="env://"``), where the reference self-discovers a TPU
  pod (``MEGASCALE_COORDINATOR_ADDRESS``, ``TPU_WORKER_HOSTNAMES``).

A rank's device is ``cuda:<LOCAL_RANK>``: torchrun's ``LOCAL_RANK``, or
else the rank modulo the visible cards. A caller that asks for the CPU
gets ``cpu`` and gloo.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

log = logging.getLogger("tpu_serve.distributed")

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device: torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def local_rank(rank: int) -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else
    ``rank`` modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """The device a rank trains on: ``cuda:<local rank>`` for ``None`` or
    ``"cuda"``, the CPU when asked for it, else the device named. Asking for
    CUDA without a card raises."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")
        r = rank if rank is not None else (dist.get_rank() if dist.is_initialized() else 0)
        return torch.device("cuda", local_rank(r))
    return resolve_device(device)


def _bootstrap() -> tuple[str, int, int, str] | None:
    """(init_method, rank, world size, trigger) from the environment, or
    None without one."""
    coord = os.environ.get("TPU_SERVE_COORDINATOR")
    if coord:
        missing = [v for v in ("TPU_SERVE_NUM_PROCESSES", "TPU_SERVE_PROCESS_ID")
                   if v not in os.environ]
        if missing:
            raise RuntimeError(
                "TPU_SERVE_COORDINATOR is set, so multi-host bootstrap also "
                f"needs {' and '.join(missing)} in the environment"
            )
        return (f"tcp://{coord}", int(os.environ["TPU_SERVE_PROCESS_ID"]),
                int(os.environ["TPU_SERVE_NUM_PROCESSES"]), coord)
    if all(v in os.environ for v in TORCHRUN_VARS):
        return ("env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    return None


def maybe_initialize(device=None, timeout_s: float = 600.0) -> bool:
    """Join the process group when the environment asks for it.

    ``device`` picks the backend (``"cpu"``: gloo; ``None``/``"cuda"``:
    NCCL, each rank on its own card, made current). Idempotent: a process
    already in a group returns True at once. Returns False, doing nothing,
    without the environment."""
    if dist.is_initialized():
        return True
    boot = _bootstrap()
    if boot is None:
        return False
    init_method, rank, world, via = boot
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    log.info("joined process group: rank %d/%d via %s (%s)", rank, world, via,
             dist.get_backend())
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()
