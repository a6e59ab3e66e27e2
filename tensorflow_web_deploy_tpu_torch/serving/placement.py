"""Placement: which devices a model version serves on, and how
(counterpart of the JAX package's ``serving/placement.py``).

- ``shard`` (the default): one dispatch stream whose batches split their
  rows evenly over every device of the mesh.
- ``replicate`` ×N: the mesh's devices split into N disjoint groups in
  order; each group holds a full copy of the weights and runs an
  independent dispatch stream with its own executables. The batcher routes
  each sealed batch to one group.

Spec syntax (the suffix of ``--model name,...``):

    replicas=N      N independent replicas (the mesh size must divide by N)
    shard=batch     the default, spelled out

A :class:`Placement` is immutable: it holds the per-replica device groups;
the engine builds a replica per group (``serving/engine.py``), the batcher
routes over them (``serving/batcher.py``) and the registry reports each
version's placement (``GET /models``). The refusals and their texts are the
reference's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Placement:
    """Strategy and per-replica device groups of one model version;
    ``replicas == len(meshes)``, and "shard" has one group, the whole mesh."""

    strategy: str
    meshes: tuple

    @property
    def replicas(self) -> int:
        return len(self.meshes)

    @property
    def spec(self) -> str:
        """The normalized spec (what /models and /stats show)."""
        if self.strategy == "replicate":
            return f"replicas={self.replicas}"
        return "shard=batch"

    def summary(self) -> dict:
        """JSON-ready description for /models, /stats and logs."""
        return {
            "strategy": self.strategy,
            "spec": self.spec,
            "replicas": self.replicas,
            "devices_per_replica": len(self.meshes[0]),
            # a device's index (0 when unset): the reference lists device ids
            "devices": [[d.index or 0 for d in m] for m in self.meshes],
        }


def parse_placement(spec: str | None, mesh) -> Placement:
    """Resolve a placement spec against a mesh (a tuple of devices).

    ``spec`` is None (shard over the whole mesh), ``"shard=batch"`` or
    ``"replicas=N"``. Raises ValueError on a malformed spec or an N the mesh
    cannot honor: placement is operator config, and a typo must fail the
    load, not quietly serve on one device."""
    mesh = tuple(mesh)
    if not spec or spec == "shard=batch":
        return Placement("shard", (mesh,))
    if spec.startswith("shard="):
        raise ValueError(f"unknown shard axis in placement {spec!r} (only shard=batch)")
    if spec.startswith("replicas="):
        raw = spec[len("replicas="):]
        try:
            n = int(raw)
        except ValueError:
            raise ValueError(f"placement replicas={raw!r} is not an integer") from None
        if n < 1:
            raise ValueError(f"placement needs replicas >= 1, got {n}")
        if n > len(mesh):
            raise ValueError(f"placement replicas={n} exceeds the {len(mesh)}-device mesh")
        if len(mesh) % n:
            raise ValueError(f"{len(mesh)} devices do not split evenly into {n} replicas")
        if n == 1:
            # one replica over every device is the shard strategy: one spelling
            return Placement("shard", (mesh,))
        per = len(mesh) // n
        return Placement("replicate", tuple(mesh[i * per:(i + 1) * per] for i in range(n)))
    raise ValueError(f"unknown placement {spec!r} (want replicas=N or shard=batch)")
