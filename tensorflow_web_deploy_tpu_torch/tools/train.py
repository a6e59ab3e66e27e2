#!/usr/bin/env python
"""Fine-tune a zoo model on one device or over ranks and export it for serving.

The port's counterpart of the repo's ``tools/train.py``, flag for flag and
line for line in what it logs: ``train/trainer.py`` (the train step, BN on
batch statistics, AdamW with optax's defaults), ``train/checkpoint.py``
(save and resume) and, with ``--export``, a serving export ({params,
batch_stats} only, no optimizer state) that ``python -m
tensorflow_web_deploy_tpu_torch.server --model native:<name> --ckpt
<export>`` serves. It runs on the card (``--device cuda``, the default)
unless asked for the CPU, and raises without a card.

Data: ``--data DIR`` with one subdirectory per class of jpeg/png images;
without it, a deterministic synthetic set. Labels map to sorted
subdirectory names. Batches are the reference tool's, array for array: a
pure function of (seed, step), so a resumed run continues the stream.

Started as several processes (one a device) with ``TPU_SERVE_COORDINATOR``,
``TPU_SERVE_PROCESS_ID`` and ``TPU_SERVE_NUM_PROCESSES``, or under
torchrun, the ranks join one process group (``parallel/distributed.py``:
NCCL on the cards, gloo with ``--device cpu``) and train on a
``('data', 'model')`` mesh of ``--model-axis`` ranks a data replica.
``--batch`` is the global batch, a multiple of the data axis; each rank
steps on its data replica's rows of it. Rank 0 alone logs and writes the
checkpoints (gathered whole, so any mesh resumes them) and the export.

Usage:
    python -m tensorflow_web_deploy_tpu_torch.tools.train --model mobilenet_v2 \\
        --width 0.5 --classes 10 --data photos/ --steps 500 --batch 64 --ckpt-dir runs/m1
    python -m tensorflow_web_deploy_tpu_torch.server --model native:mobilenet_v2 \\
        --ckpt runs/m1/export --zoo-width 0.5 --zoo-classes 10
    torchrun --nproc-per-node 4 -m tensorflow_web_deploy_tpu_torch.tools.train \\
        --model mobilenet_v2 --batch 64 --model-axis 2 --ckpt-dir runs/m2
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mobilenet_v2", help="zoo model name")
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--classes", type=int, default=None)
    p.add_argument("--input-size", type=int, default=96,
                   help="training resolution (square)")
    p.add_argument("--data", default=None,
                   help="dir of class-subdirs of images; default: synthetic")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--model-axis", type=int, default=1,
                   help="ranks a data replica spans (the mesh's 'model' axis)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (enables save + resume)")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--export", action="store_true", default=True,
                   help="write <ckpt-dir>/export for serving (default on)")
    p.add_argument("--no-export", dest="export", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N, or cpu")
    return p.parse_args(argv)


def _batch_rng(seed: int, step: int) -> np.random.RandomState:
    """Per-step RNG: batches are a pure function of (seed, step), so a
    resumed run continues the stream exactly where the interrupted run left
    off instead of retraining on the head of the stream."""
    return np.random.RandomState((seed * 1000003 + step) % (2**32))


class FolderData:
    """class-per-subdir image folder → shuffled (x, y) batches."""

    def __init__(self, root: str, size: int, batch: int, seed: int):
        from PIL import Image  # noqa: F401  (validated here, used per batch)

        self.root = Path(root)
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not self.classes:
            sys.exit(f"no class subdirectories in {root}")
        self.items = [
            (p, i)
            for i, c in enumerate(self.classes)
            for p in sorted((self.root / c).iterdir())
            if p.suffix.lower() in (".jpg", ".jpeg", ".png")
        ]
        if not self.items:
            sys.exit(f"no images under {root}")
        self.size, self.batch, self.seed = size, batch, seed
        self.num_classes = len(self.classes)

    def batch_at(self, step: int):
        from PIL import Image

        idx = _batch_rng(self.seed, step).randint(0, len(self.items), self.batch)
        xs, ys = [], []
        for i in idx:
            path, label = self.items[i]
            img = Image.open(path).convert("RGB").resize((self.size, self.size))
            xs.append(np.asarray(img, np.float32) / 127.5 - 1.0)
            ys.append(label)
        return np.stack(xs), np.asarray(ys, np.int32)


class SyntheticData:
    """Deterministic separable blobs — loss must go down on them."""

    def __init__(self, num_classes: int, size: int, batch: int, seed: int):
        self.num_classes = num_classes
        self.size, self.batch, self.seed = size, batch, seed
        self.means = np.linspace(-0.8, 0.8, num_classes)
        self.classes = [f"class_{i}" for i in range(num_classes)]

    def batch_at(self, step: int):
        rng = _batch_rng(self.seed, step)
        y = rng.randint(0, self.num_classes, self.batch)
        x = (
            self.means[y][:, None, None, None]
            + rng.randn(self.batch, self.size, self.size, 3) * 0.3
        ).astype(np.float32)
        return x, y.astype(np.int32)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch.distributed as dist

    from ..parallel import distributed

    owned = not dist.is_initialized()
    try:
        return _train(args)
    finally:
        if owned:
            distributed.shutdown()


def _train(args) -> int:
    import torch.distributed as dist

    from .. import models
    from ..models.adapter import init_variables, to_jax_params, write_serving_export
    from ..parallel import batch_multiple, distributed, train_mesh
    from ..train import adamw, create_train_state, make_train_step
    from ..train.checkpoint import Checkpointer
    from ..train.trainer import full_state_dict

    spec_task = models.get(args.model).task
    if spec_task != "classify":
        # Fail fast, before data enumeration or device init: the train
        # step's loss is softmax cross-entropy over logits; a detector
        # would silently "train" on its box tensor.
        sys.exit(f"--model {args.model} is a {spec_task} model; "
                 "the trainer supports classify zoo models")

    mesh = None
    if distributed.maybe_initialize(args.device):
        mesh = train_mesh(args.model_axis, args.device)
        if args.batch % batch_multiple(mesh):
            sys.exit(f"--batch {args.batch} is not a multiple of the data axis ({mesh.data}: "
                     f"{mesh.data * mesh.model} ranks, --model-axis {mesh.model})")
    elif args.model_axis != 1:
        sys.exit(f"--model-axis {args.model_axis}: a model axis spans ranks; start the tool "
                 "as one process a device, under torchrun or with TPU_SERVE_COORDINATOR, "
                 "TPU_SERVE_PROCESS_ID and TPU_SERVE_NUM_PROCESSES")
    lead = mesh is None or mesh.rank == 0

    def log(line: str) -> None:
        if lead:
            print(line, flush=True)

    if args.data:
        data = FolderData(args.data, args.input_size, args.batch, args.seed)
        num_classes = data.num_classes
        if args.classes and args.classes != num_classes:
            sys.exit(f"--classes {args.classes} != {num_classes} dirs in --data")
    else:
        num_classes = args.classes or 10
        data = SyntheticData(num_classes, args.input_size, args.batch, args.seed)
    rows = mesh.rows(args.batch) if mesh is not None else slice(None)

    spec = models.get(args.model)
    model, _ = init_variables(spec, num_classes=num_classes, width=args.width, seed=args.seed)
    state = create_train_state(model, None, adamw(args.lr), device=args.device, mesh=mesh)
    step_fn = make_train_step(model, mesh=mesh)
    where = (f"device {next(model.parameters()).device}" if mesh is None else
             f"mesh {mesh.shape} over {mesh.data * mesh.model} ranks ({dist.get_backend()}, "
             f"{mesh.device.type})")
    log(f"{where}; {args.model} width={args.width} classes={num_classes} batch={args.batch}")

    ck = Checkpointer(str(Path(args.ckpt_dir).resolve())) if args.ckpt_dir else None
    if ck is not None:
        restored = ck.restore(state, mesh)
        if restored is not None:
            state = restored
            log(f"resumed from step {int(state['step'])}")

    start = int(state["step"])
    t0 = time.perf_counter()
    last_logged = start
    for step in range(start, args.steps):
        x, y = data.batch_at(step)
        state, metrics = step_fn(state, x[rows], y[rows])
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss, acc = float(metrics["loss"]), float(metrics["accuracy"])  # waits for the step
            dt = time.perf_counter() - t0
            n_steps = step + 1 - last_logged  # interval may be short (resume/tail)
            log(f"step {step + 1}/{args.steps} loss={loss:.4f} acc={acc:.3f} "
                f"({n_steps * args.batch / dt:.1f} img/s)")
            t0 = time.perf_counter()
            last_logged = step + 1
        if ck is not None and (step + 1) % args.save_every == 0:
            ck.save(step + 1, state, mesh)

    if ck is not None:
        ck.save(args.steps, state, mesh)
        ck.wait()
        if args.export:
            export_dir = str(Path(args.ckpt_dir).resolve() / "export")
            # a collective on a mesh: every rank gathers, rank 0 writes
            params = to_jax_params(model if mesh is None else full_state_dict(model, mesh))
            if lead:
                # Class names ride with the export so the server's /predict
                # labels mean what the training data meant.
                write_serving_export(export_dir, params, data.classes)
            log(f"serving export: {export_dir} "
                f"(serve with --model native:{args.model} --ckpt {export_dir})")
        ck.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
