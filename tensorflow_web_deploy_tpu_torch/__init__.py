"""PyTorch/CUDA port of ``tensorflow_web_deploy_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference and is never imported
here: this package keeps its own copy of everything it needs (configs,
labels, host image helpers). The layout mirrors the reference —
``ops/``, ``models/``, ``serving/``, ``utils/`` — so each module's
counterpart is found under the same path. Hand-written CUDA kernels live
in ``csrc/`` and are built at first use by ``ops/_build.py``.
"""
