"""Training on one device (counterpart of the JAX package's ``train/``):
the zoo's classifiers are fine-tuned with the port's own modules and the
result is served with ``server --model native:<name> --ckpt <export>``.

The reference's GSPMD sharding rules (``partition_variables``,
``partition_state``) have no counterpart: the port trains on one card.
"""

from .trainer import adamw, create_train_state, make_train_step, sgd

__all__ = ["adamw", "create_train_state", "make_train_step", "sgd"]
