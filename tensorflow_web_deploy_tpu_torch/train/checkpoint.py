"""Checkpoints of the training path (counterpart of the JAX package's
``train/checkpoint.py``), in the port's own format in place of orbax.

A checkpoint directory holds one subdirectory per saved step,
``<dir>/<step>/state.pt``: the train state as plain containers of CPU
tensors (an optimizer as its ``state_dict()``), written with
``torch.save`` into a temporary directory that is renamed into place, so
a crash never leaves a step that :meth:`Checkpointer.latest_step` picks
up. It is read back with ``torch.load(weights_only=True)``, which builds
tensors and plain containers only.

A checkpoint does not depend on the mesh that wrote it. On a
``('data', 'model')`` mesh (``parallel/mesh.py::RankMesh``) ``save``
gathers every weight sharded over ``'model'``, and its optimizer moments,
whole; global rank 0 alone writes them, and the ranks meet at a barrier
once the step is in place. ``restore`` with a mesh maps the file
(``torch.load(mmap=True)``) and copies each rank's own slice. So a state
saved at 2 × 2 restores at 1 × 1, 4 × 1 or 1 × 2, and back.

The serving export (params and batch stats alone, in the JAX package's
flat layout) is ``models/adapter.py``'s: ``write_serving_export`` and
``restore_serving_export``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .trainer import gather_leaf, shard_dim

STATE_FILE = "state.pt"


def _to_host(tree):
    """A snapshot of ``tree`` that later in-place updates cannot reach:
    tensors and numpy arrays copied into CPU tensors, an object with
    ``state_dict`` (an optimizer) as its state dict."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if hasattr(tree, "state_dict"):
        return _to_host(tree.state_dict())
    return tree


def _moment_dims(opt) -> list[int | None]:
    """The sharded dimension of each of the optimizer's parameters, in its
    ``state_dict()``'s index order."""
    return [shard_dim(p) for group in opt.param_groups for p in group["params"]]


def _gathered(state, mesh):
    """``state`` with each leaf sharded over ``'model'`` gathered whole:
    the sharded params and their optimizer moments, the optimizer as its
    ``state_dict()``."""
    params = {k: gather_leaf(v, shard_dim(v), mesh) if shard_dim(v) is not None else v
              for k, v in state["params"].items()}
    sd = state["opt_state"].state_dict()
    dims = _moment_dims(state["opt_state"])
    moments = {i: {k: gather_leaf(v, dims[i], mesh)
                   if dims[i] is not None and torch.is_tensor(v) and v.dim() > 0 else v
                   for k, v in entry.items()}
               for i, entry in sd["state"].items()}
    return {**state, "params": params, "opt_state": {**sd, "state": moments}}


def _fill(like, saved, path: str = "state"):
    """``saved`` in the structure of ``like``: a tensor leaf of ``like`` is
    overwritten in place (so a model's parameters take the values), an
    optimizer loads its state dict, a numpy leaf or a number is replaced.
    Keys and shapes must match."""
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint {path}: keys {sorted(saved)[:4]}…, "
                             f"want {sorted(like)[:4]}…")
        return {k: _fill(v, saved[k], f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, (torch.Tensor, np.ndarray)):
        if tuple(like.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint {path}: shape {tuple(saved.shape)}, "
                             f"want {tuple(like.shape)}")
        if isinstance(like, np.ndarray):
            return saved.numpy().astype(like.dtype)
        with torch.no_grad():
            like.copy_(saved)
        return like
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(saved)
        return like
    return saved


class Checkpointer:
    """Save and restore one train state under ``directory``.

    ``save`` snapshots the state on the caller's thread and writes (and
    fsyncs) it on a thread of its own (``wait`` joins it and raises what it raised), as
    orbax's manager saves asynchronously; a step already on disk is not
    written again, and past ``max_to_keep`` the oldest steps go.
    ``create=False`` on a missing directory raises ``FileNotFoundError``
    (a restore-only caller must not make an empty tree on a typo'd path).
    """

    def __init__(self, directory: str, max_to_keep: int = 3, create: bool = True):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            if not create:
                raise FileNotFoundError(f"no checkpoint directory at {directory}")
            self.directory.mkdir(parents=True, exist_ok=True)  # ranks may race here
        self.max_to_keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False  # a mesh save's ranks meet once its step is in place

    def steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, mesh=None) -> None:
        """Snapshot ``state`` as step ``step`` and write it on a thread.
        With ``mesh`` every rank calls it: the sharded leaves are gathered
        whole over ``'model'``, rank 0 writes, and :meth:`wait` ends at a
        barrier of all ranks."""
        self.wait()
        if step in self.steps():
            return
        if mesh is not None:
            state = _gathered(state, mesh)
            self._barrier = True
            if mesh.rank != 0:
                return
        tree = _to_host(state)
        self._writer = threading.Thread(target=self._write, args=(step, tree),
                                        name=f"checkpoint-{step}")
        self._writer.start()

    def _write(self, step: int, tree) -> None:
        try:
            tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory))
            with open(tmp / STATE_FILE, "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())  # on disk before the rename makes it a step
            os.replace(tmp, self.directory / str(step))
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        except BaseException as e:  # raised on the caller's thread by wait()
            self._error = e

    def wait(self) -> None:
        """Join the pending write and raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, state_like, mesh=None):
        """The newest checkpoint in the structure of ``state_like`` (a
        freshly built state works), or None when there is none. Tensor
        leaves of ``state_like`` are overwritten in place and its optimizer
        loads its state, so the returned state drives the same model. With
        ``mesh`` (``state_like`` made on it) each rank maps the file and
        copies its own slice of every sharded leaf."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self.directory / str(step) / STATE_FILE, map_location="cpu",
                           weights_only=True, mmap=mesh is not None)
        if mesh is not None:
            saved = _own_slices(saved, state_like, mesh)
        return _fill(state_like, saved)

    def close(self) -> None:
        self.wait()



def _own_slices(saved: dict, state_like: dict, mesh) -> dict:
    """``saved`` (whole leaves, mapped from the file) with this rank's
    slice of each leaf that ``state_like`` holds sharded over ``'model'``;
    the optimizer's tensors are copies, so none stays backed by the file."""

    def own(t: torch.Tensor, dim: int | None, local: torch.Tensor) -> torch.Tensor:
        if dim is None:
            return t.clone()
        n = local.shape[dim]
        if t.shape[dim] != n * mesh.model:
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} does not split into "
                             f"{mesh.model} slices of {n}")
        return t.narrow(dim, mesh.model_index * n, n).clone()

    out = dict(saved)
    out["params"] = {k: own(v, shard_dim(state_like["params"][k]), state_like["params"][k])
                     if k in state_like["params"] and shard_dim(state_like["params"][k]) is not None
                     else v for k, v in saved["params"].items()}
    opt = state_like["opt_state"]
    dims = _moment_dims(opt)
    live = [p for group in opt.param_groups for p in group["params"]]
    moments = {}
    for i, entry in saved["opt_state"]["state"].items():
        dim = dims[i] if i < len(dims) else None
        moments[i] = {k: own(v, dim if v.dim() > 0 else None, live[i])
                      if torch.is_tensor(v) else v
                      for k, v in entry.items()}
    out["opt_state"] = {**saved["opt_state"], "state": moments}
    return out
