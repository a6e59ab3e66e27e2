"""Training (counterpart of the JAX package's ``train/``): the zoo's
classifiers are fine-tuned with the port's own modules, on one device or
over the ranks of a ``('data', 'model')`` mesh, and the result is served
with ``server --model native:<name> --ckpt <export>``.
"""

from .trainer import (
    adamw,
    create_train_state,
    full_state_dict,
    make_train_step,
    partition_state,
    partition_variables,
    sgd,
    shard_model,
)

__all__ = ["adamw", "create_train_state", "full_state_dict", "make_train_step",
           "partition_state", "partition_variables", "sgd", "shard_model"]
