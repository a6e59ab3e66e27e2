"""The train step (counterpart of the JAX package's ``train/trainer.py``),
on one device or over the ranks of a ``('data', 'model')`` mesh.

The state is a dict, as in the reference: ``params`` and ``batch_stats``
(the model's parameters and BN running statistics by state-dict name —
the model's own tensors, updated in place), ``opt_state`` (the
``torch.optim`` optimizer, which holds its moments) and ``step``. The
step is the reference's: BN on batch statistics (the running ones move),
mean softmax cross-entropy on integer labels, the optimizer's update, and
the argmax accuracy of the logits it computed. It runs on the device of
the state's parameters and never moves to another.

With a mesh (``parallel/mesh.py::RankMesh``, one process a device) the
reference's GSPMD program is written out by hand:

- The batch shards over ``'data'``: each rank steps on its rows.
- :func:`partition_variables` picks the weights that shard their output
  dimension over ``'model'`` (the reference's rule, :func:`_leaf_spec`),
  and :func:`shard_model` keeps each rank's slice. A sharded layer
  computes its own output channels from the whole input (a depthwise
  layer from its channel slice of it), and the slices are gathered over
  ``'model'`` before the BatchNorm; its input gradient is summed over
  ``'model'`` (``parallel/collectives.py``). Everything after a gather
  runs alike on the ranks of a data replica.
- BatchNorm averages its mean and E[x²] over ``'data'`` with autograd, so
  it normalizes by the global batch's statistics and every rank's running
  statistics move alike.
- Each rank's loss is the mean over its rows. After the backward one
  bucketed all-reduce over ``'data'`` sums every gradient (a sharded one
  is this rank's slice), the loss and the hits, and the gradients are
  scaled by 1/D: the gradient of the global batch's mean loss. The
  optimizer then updates the rank's own tensors, its moments beside them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.adapter import from_jax_params
from ..models.common import BatchNorm, ConvBNCell, DepthwiseConvBN
from ..parallel.collectives import all_reduce_sum, gather_channels, sum_grad
from ..utils.device import resolve_device

SHARD_DIM = "model_shard_dim"  # set on a parameter sharded over 'model': the dim


def adamw(lr: float):
    """``optax.adamw(lr)``'s defaults as a ``torch.optim.AdamW`` factory:
    b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 (torch's default is
    1e-2) on every parameter, as optax decays every leaf with
    ``mask=None``."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def sgd(lr: float):
    """``optax.sgd(lr)``: plain gradient descent."""
    return functools.partial(torch.optim.SGD, lr=lr)


def _leaf_spec(leaf, model_size: int) -> int | None:
    """The reference's partition rule by leaf shape, on the port's layout
    (output dimension first): the dimension sharded over ``'model'``, or
    None (replicated).

    - 2-D dense weights [out, in]: output features, when they split evenly.
    - 4-D conv kernels [out, in/groups, kh, kw], depthwise [C, 1, kh, kw]
      included: output channels, when they split into ≥ 2 shards of ≥ 64.
    - Everything else (biases, BN, scalars, optimizer counts): replicated.

    The flax kernels (HWIO, [in, out]) keep the output last, so the rule
    picks the same leaves there; an optimizer moment, shaped as its
    weight, follows it."""
    shape = tuple(getattr(leaf, "shape", ()))
    if model_size <= 1 or not shape:
        return None
    if len(shape) == 2 and shape[0] % model_size == 0:
        return 0
    if len(shape) == 4 and shape[0] % model_size == 0 and shape[0] // model_size >= 64:
        return 0
    return None


def partition_variables(tree, mesh):
    """The tree of :func:`_leaf_spec` of every tensor (or array) leaf of
    ``tree`` over ``mesh``'s model axis, in ``tree``'s structure; any
    other leaf is None."""
    if isinstance(tree, dict):
        return {k: partition_variables(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(partition_variables(v, mesh) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return _leaf_spec(tree, mesh.model)
    return None


def partition_state(state: dict, mesh) -> dict:
    """:func:`partition_variables` of an unsharded train state, its
    optimizer as its ``state_dict()`` (each moment follows its weight)."""
    opt = state["opt_state"]
    return partition_variables({**state, "opt_state": opt.state_dict()
                                if hasattr(opt, "state_dict") else opt}, mesh)


def shard_dim(p: torch.Tensor) -> int | None:
    """The dimension ``p`` is sharded on over ``'model'``, or None."""
    return getattr(p, SHARD_DIM, None)


class _ColumnLinear(nn.Linear):
    """The dense head with this rank's rows of output features: the slices
    gathered over ``'model'``, then the (replicated) bias added."""

    model_group = None

    def forward(self, x):
        g = self.model_group
        y = gather_channels(F.linear(sum_grad(x, g), self.weight), g)
        return y if self.bias is None else y + self.bias


def _enter_hook(group, channels: slice | None):
    def hook(module, args):
        x = sum_grad(args[0], group)
        return (x if channels is None else x[:, channels],) + args[1:]
    return hook


def _gather_hook(group):
    def hook(module, args):
        return (gather_channels(args[0], group),) + args[1:]
    return hook


def _global_moments(mean, ex2, group, n: int):
    both = all_reduce_sum(torch.stack([mean, ex2]), group) / n
    return both[0], both[1]


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's slice of every weight :func:`partition_variables`
    shards (marked with its dimension, :func:`shard_dim`) and wire the
    layers that own them; with a data axis, put every BatchNorm on the
    global batch's moments. In place; every rank of the mesh calls it."""
    params = dict(model.named_parameters())
    for name, dim in partition_variables(params, mesh).items():
        if dim is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        full = params[name]
        n = full.shape[dim] // mesh.model
        own = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        p = nn.Parameter(full.detach().narrow(dim, own.start, n).clone())
        setattr(p, SHARD_DIM, dim)
        setattr(owner, leaf, p)
        cell = model.get_submodule(owner_name.rpartition(".")[0]) if "." in owner_name else model
        if isinstance(owner, nn.Linear) and leaf == "weight":
            owner.__class__ = _ColumnLinear  # as torch.nn.utils.parametrize re-classes
            owner.model_group = mesh.model_group
        elif isinstance(cell, ConvBNCell) and owner is getattr(cell, cell.conv_attr):
            dw = isinstance(cell, DepthwiseConvBN)
            cell.register_forward_pre_hook(_enter_hook(mesh.model_group, own if dw else None))
            cell.bn.register_forward_pre_hook(_gather_hook(mesh.model_group))
        else:
            raise ValueError(f"no sharded form for {name} ({type(owner).__name__})")
    if mesh.data > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.sync = functools.partial(_global_moments, group=mesh.data_group, n=mesh.data)
    return model


def full_state_dict(model: nn.Module, mesh) -> dict[str, torch.Tensor]:
    """The model's state dict with every sharded weight gathered whole over
    ``'model'`` (a collective: every rank of the mesh calls it)."""
    sharded = {n: shard_dim(p) for n, p in model.named_parameters() if shard_dim(p) is not None}
    return {k: gather_leaf(v, sharded[k], mesh) if k in sharded else v
            for k, v in model.state_dict().items()}


def gather_leaf(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's slice of a leaf sharded on ``dim`` over ``'model'`` →
    the whole leaf, on every rank of the model group."""
    if mesh.model == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim)


def create_train_state(model: nn.Module, params_flat: dict[str, np.ndarray] | None,
                       optimizer, device="cuda", mesh=None) -> dict:
    """Load ``params_flat`` (the JAX package's flat layout; None keeps the
    model's weights) into ``model``, move it to ``device`` (the card unless
    the caller asks for the CPU; no card raises) in its own dtype, and pack
    the state. ``optimizer`` makes the optimizer from the parameters
    (:func:`adamw`, :func:`sgd`). With ``mesh`` the model moves to the
    mesh's device and is sharded (:func:`shard_model`) first, so the state
    and the optimizer hold this rank's slices."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if params_flat is not None:
        model.load_state_dict(from_jax_params(params_flat))
    model.to(dev)
    if mesh is not None:
        shard_model(model, mesh)
    params = dict(model.named_parameters())
    return {
        "params": params,
        "batch_stats": {k: v for k, v in model.named_buffers()
                        if k.endswith((".bn.mean", ".bn.var"))},
        "opt_state": optimizer(list(params.values())),
        "step": 0,
    }


def _reduce_over_data(params, loss: torch.Tensor, hits: torch.Tensor, mesh) -> tuple:
    """One all-reduce over ``'data'`` of every gradient, the loss and the
    hits; the gradients scaled by 1/D in place. Returns the global loss and
    accuracy, and the bucket's bytes."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    bucket = torch.cat([g.reshape(-1) for g in grads]
                       + [loss.reshape(1).to(grads[0].dtype),
                          hits.sum().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=mesh.data_group)
    offset = 0
    for g in grads:
        g.copy_(bucket[offset:offset + g.numel()].view_as(g) / mesh.data)
        offset += g.numel()
    return (bucket[-2] / mesh.data, bucket[-1] / (hits.numel() * mesh.data),
            bucket.numel() * bucket.element_size())


def make_train_step(model: nn.Module, mesh=None):
    """step(state, x [B, H, W, 3] NHWC, y [B] int) -> (state, {"loss",
    "accuracy"}): one update of the classifier ``model`` in train mode. ``x`` and ``y``
    (numpy or tensors) go to the parameters' device and dtype; the state is
    updated in place and returned (the reference's step donates it). The
    metrics are 0-d tensors on the device, read only when logged.

    With ``mesh`` (a state made by ``create_train_state(..., mesh=mesh)``)
    ``x`` and ``y`` are this rank's rows (``mesh.rows``) and the metrics
    are the global batch's; ``step.bucket_bytes`` is the size of the last
    step's all-reduce."""

    def step(state: dict, x, y) -> tuple[dict, dict]:
        p = next(iter(state["params"].values()))
        x = torch.as_tensor(x, device=p.device, dtype=p.dtype)
        y = torch.as_tensor(y, device=p.device, dtype=torch.long)
        model.train()
        logits = model(x.permute(0, 3, 1, 2))
        loss = F.cross_entropy(logits, y)
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            hits = (logits.argmax(-1) == y).to(loss.dtype)
            if mesh is None:
                loss, accuracy = loss.detach(), hits.mean()
            else:
                loss, accuracy, step.bucket_bytes = _reduce_over_data(
                    state["params"].values(), loss.detach(), hits, mesh)
        opt.step()
        state["step"] += 1
        return state, {"loss": loss, "accuracy": accuracy}

    step.bucket_bytes = 0
    return step
