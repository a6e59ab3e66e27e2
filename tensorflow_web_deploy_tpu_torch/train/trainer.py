"""The train step (counterpart of the JAX package's ``train/trainer.py``)
on one device.

The state is a dict, as in the reference: ``params`` and ``batch_stats``
(the model's parameters and BN running statistics by state-dict name —
the model's own tensors, updated in place), ``opt_state`` (the
``torch.optim`` optimizer, which holds its moments) and ``step``. The
step is the reference's: BN on batch statistics (the running ones move),
mean softmax cross-entropy on integer labels, the optimizer's update, and
the argmax accuracy of the logits it computed. It runs on the device of
the state's parameters and never moves to another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.adapter import from_jax_params
from ..utils.device import resolve_device


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


def create_train_state(model: nn.Module, params_flat: dict[str, np.ndarray] | None,
                       optimizer, device="cuda") -> dict:
    """Load ``params_flat`` (the JAX package's flat layout; None keeps the
    model's weights) into ``model``, move it to ``device`` (the card unless
    the caller asks for the CPU; no card raises) in its own dtype, and pack
    the state. ``optimizer`` makes the optimizer from the parameters
    (:func:`adamw`, :func:`sgd`)."""
    dev = resolve_device(device)
    if params_flat is not None:
        model.load_state_dict(from_jax_params(params_flat))
    model.to(dev)
    params = dict(model.named_parameters())
    return {
        "params": params,
        "batch_stats": {k: v for k, v in model.named_buffers()
                        if k.endswith((".bn.mean", ".bn.var"))},
        "opt_state": optimizer(list(params.values())),
        "step": 0,
    }


def make_train_step(model: nn.Module):
    """step(state, x [B, H, W, 3] NHWC, y [B] int) -> (state, {"loss",
    "accuracy"}): one update of the classifier ``model`` in train mode. ``x`` and ``y``
    (numpy or tensors) go to the parameters' device and dtype; the state is
    updated in place and returned (the reference's step donates it). The
    metrics are 0-d tensors on the device, read only when logged."""

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
        opt.step()
        state["step"] += 1
        with torch.no_grad():
            accuracy = (logits.argmax(-1) == y).to(loss.dtype).mean()
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return step
