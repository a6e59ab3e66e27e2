"""The port's multi-process bootstrap (``parallel/distributed.py``), its
training mesh and partition rule, against the JAX package's
``parallel/distributed.py``, ``parallel/mesh.py`` and
``train/trainer.py``: the environment contract (nothing without it, the
reference's text for a missing variable, idempotent, the backend from the
device), torchrun's variables, two real processes joined through
``TPU_SERVE_COORDINATOR`` (the counterpart of ``test_multihost.py``), and
the leaves the rule shards, leaf for leaf against the reference's.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec as P

from tensorflow_web_deploy_tpu import models as jax_models
from tensorflow_web_deploy_tpu.models.adapter import init_variables as jax_init
from tensorflow_web_deploy_tpu.parallel import distributed as jax_distributed
from tensorflow_web_deploy_tpu.parallel import mesh as jax_mesh
from tensorflow_web_deploy_tpu.train import partition_variables as jax_partition
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import _flax_key
from tensorflow_web_deploy_tpu_torch.parallel import RankMesh, batch_multiple, shard_params_tp
from tensorflow_web_deploy_tpu_torch.parallel import distributed
from tensorflow_web_deploy_tpu_torch.train import (
    adamw,
    create_train_state,
    make_train_step,
    partition_state,
    partition_variables,
)

REPO = Path(__file__).resolve().parent.parent
BOOT_VARS = ("TPU_SERVE_COORDINATOR", "TPU_SERVE_PROCESS_ID", "TPU_SERVE_NUM_PROCESSES",
             "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
             "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def clean_env(monkeypatch):
    for v in BOOT_VARS:
        monkeypatch.delenv(v, raising=False)
    yield monkeypatch
    distributed.shutdown()


def worker(tmp_path, script: str) -> str:
    """``script`` written to a file under ``tmp_path``; its path."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    return str(path)


def run_ranks(argv: list, n: int, timeout: float = 300.0) -> list[str]:
    """``python <argv>`` as ``n`` processes joined through
    ``TPU_SERVE_COORDINATOR`` on a free port, one thread each; their
    outputs, every one exited 0. The children are killed if any fails or
    outlasts ``timeout``."""
    port = free_port()
    procs = []
    try:
        for i in range(n):
            env = {k: v for k, v in os.environ.items() if k not in BOOT_VARS}
            env.update(TPU_SERVE_COORDINATOR=f"127.0.0.1:{port}", TPU_SERVE_PROCESS_ID=str(i),
                       TPU_SERVE_NUM_PROCESSES=str(n), OMP_NUM_THREADS="1",
                       PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
            procs.append(subprocess.Popen([sys.executable, *map(str, argv)], env=env,
                                          cwd=str(REPO), stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = []
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {i} failed:\n{err[-3000:]}"
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


# ------------------------------------------------------- the env contract


def test_nothing_happens_without_the_environment(clean_env):
    assert distributed.maybe_initialize("cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="a training mesh spans the ranks"):
        from tensorflow_web_deploy_tpu_torch.parallel import train_mesh

        train_mesh(1, "cpu")


@pytest.mark.parametrize("given", [(), ("TPU_SERVE_PROCESS_ID",), ("TPU_SERVE_NUM_PROCESSES",)])
def test_a_missing_variable_raises_the_references_text(clean_env, given):
    clean_env.setenv("TPU_SERVE_COORDINATOR", "127.0.0.1:1")
    for v in given:
        clean_env.setenv(v, "0")
    with pytest.raises(RuntimeError) as ref:
        jax_distributed.maybe_initialize()
    with pytest.raises(RuntimeError) as got:
        distributed.maybe_initialize("cpu")
    assert str(got.value) == str(ref.value)
    assert "needs" in str(got.value) and not dist.is_initialized()


def test_the_coordinator_joins_gloo_once(clean_env):
    clean_env.setenv("TPU_SERVE_COORDINATOR", f"127.0.0.1:{free_port()}")
    clean_env.setenv("TPU_SERVE_PROCESS_ID", "0")
    clean_env.setenv("TPU_SERVE_NUM_PROCESSES", "1")
    assert distributed.maybe_initialize("cpu") is True
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    group = dist.group.WORLD
    assert distributed.maybe_initialize("cpu") is True  # idempotent: the same group
    assert dist.group.WORLD is group
    distributed.shutdown()
    assert not dist.is_initialized()


def test_torchruns_variables_join(clean_env):
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", str(free_port()))
    assert distributed.maybe_initialize("cpu") is True
    assert dist.get_rank() == 0 and dist.get_backend() == "gloo"


def test_the_backend_follows_the_device_and_never_falls_back(clean_env):
    assert distributed.backend_for(torch.device("cuda", 0)) == "nccl"
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    clean_env.setenv("LOCAL_RANK", "2")
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.rank_device(None, 5) == torch.device("cuda", 2)
    assert distributed.rank_device("cuda:1", 5) == torch.device("cuda", 1)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    clean_env.setenv("TPU_SERVE_COORDINATOR", f"127.0.0.1:{free_port()}")
    clean_env.setenv("TPU_SERVE_PROCESS_ID", "0")
    clean_env.setenv("TPU_SERVE_NUM_PROCESSES", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize()  # the card by default: no gloo in its place
    assert not dist.is_initialized()


# ------------------------------------------------ two real processes


_TWO_HOSTS = """
import numpy as np, torch
torch.set_num_threads(1)
from tensorflow_web_deploy_tpu_torch.models import get
from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables
from tensorflow_web_deploy_tpu_torch.parallel import train_mesh
from tensorflow_web_deploy_tpu_torch.parallel.collectives import all_reduce_sum
from tensorflow_web_deploy_tpu_torch.parallel.distributed import shutdown
from tensorflow_web_deploy_tpu_torch.train import create_train_state, make_train_step, sgd

mesh = train_mesh(1, "cpu")  # bootstraps from the environment: data 2 x model 1
pid = mesh.rank
assert mesh.shape == {"data": 2, "model": 1}, mesh.shape

# 1. a collective across the processes: each contributes its own value
total = float(all_reduce_sum(torch.full((4,), float(pid + 1)), mesh.data_group).sum())
assert total == 12.0, total

# 2. the sharded step: the batch split across the processes, then the
# weights split across them (data 1 x model 2)
rs = np.random.RandomState(7)  # the same data on both; each feeds its rows
x_all = rs.rand(8, 32, 32, 3).astype(np.float32)
y_all = rs.randint(0, 4, 8).astype(np.int32)
losses = []
for m in (mesh, train_mesh(2, "cpu")):
    module, flat = init_variables(get("mobilenet_v2"), num_classes=4, width=0.25, seed=0)
    state = create_train_state(module, flat, sgd(1e-2), device="cpu", mesh=m)
    state, metrics = make_train_step(module, mesh=m)(state, x_all[m.rows(8)], y_all[m.rows(8)])
    losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[-1]), losses
shutdown()
print(f"MULTIHOST_OK pid={pid} total={total} loss={losses[0]:.9f} loss_tp={losses[1]:.9f}",
      flush=True)
"""


def test_two_process_mesh_and_train_step(tmp_path):
    outs = run_ranks([worker(tmp_path, _TWO_HOSTS)], 2)
    assert all("MULTIHOST_OK" in o for o in outs), outs
    # the same losses on both: the collectives really crossed the processes
    for key in ("loss=", "loss_tp="):
        got = {o.split(key)[1].split()[0] for o in outs}
        assert len(got) == 1, f"the processes disagree on {key} {got}"


# ------------------------------------------------------ the partition rule


def _rank_mesh(model: int) -> RankMesh:
    return RankMesh(data=8 // model, model=model, rank=0, device=torch.device("cpu"),
                    data_group=None, model_group=None)


def _jax_dim(spec: P) -> int | None:
    """The reference's spec as the port's output dimension (its last axis)."""
    assert spec in (P(), P(None, "model"), P(None, None, None, "model")), spec
    return None if spec == P() else 0


@pytest.mark.parametrize("width", [0.25, 0.5])
@pytest.mark.parametrize("model", [2, 4])
def test_partition_rule_selects_the_references_leaves(width, model):
    _, variables = jax_init(jax_models.get("mobilenet_v2"), num_classes=4, width=width, seed=0)
    jmesh = jax_mesh.build_mesh(jax.devices()[:8], model_axis=model)
    want = {"params/" + "/".join(k): _jax_dim(s.spec) for k, s in
            flatten_dict(jax_partition(variables["params"], jmesh)).items()}
    module = torch_get("mobilenet_v2").build(num_classes=4, width=width)
    got = {_flax_key(k): v for k, v in
           partition_variables(dict(module.named_parameters()), _rank_mesh(model)).items()}
    assert got == want
    sharded = {k for k, v in got.items() if v is not None}
    assert "params/head/conv/kernel" in sharded and "params/logits/kernel" in sharded
    # at width 0.25 over 4 shards no depthwise layer splits into ≥ 64
    assert any("/dw/dwconv/kernel" in k for k in sharded) == ((width, model) != (0.25, 4))
    assert not any("/bn/" in k for k in sharded)


def test_optimizer_moments_follow_their_weights():
    module = torch_get("mobilenet_v2").build(num_classes=4, width=0.5)
    state = create_train_state(module, None, adamw(1e-3), device="cpu")
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    state, _ = make_train_step(module)(state, x, np.array([0, 1]))
    specs = partition_state(state, _rank_mesh(2))
    by_index = list(specs["params"].values())
    assert any(d is not None for d in by_index)
    for i, entry in specs["opt_state"]["state"].items():
        assert entry["exp_avg"] == entry["exp_avg_sq"] == by_index[i]
        assert entry["step"] is None
    assert all(v is None for v in specs["batch_stats"].values()) and specs["step"] is None


def test_shard_params_tp_and_batch_multiple_are_the_references():
    _, variables = jax_init(jax_models.get("mobilenet_v2"), num_classes=4, width=0.25, seed=0)
    params = {"/".join(k): v for k, v in flatten_dict(variables["params"]).items()}
    jmesh = jax_mesh.build_mesh(jax.devices()[:8], model_axis=2)
    ref = jax_mesh.shard_params_tp(jmesh, params, {"logits/kernel", "head/conv/kernel"})
    module = torch_get("mobilenet_v2").build(num_classes=4, width=0.25)
    port = shard_params_tp(_rank_mesh(2), dict(module.named_parameters()),
                           {"logits.weight", "head.conv.weight"})
    assert {_flax_key(k)[len("params/"):]: v for k, v in port.items()} == \
        {k: _jax_dim(s.spec) for k, s in ref.items()}
    assert batch_multiple(_rank_mesh(2)) == 4  # the data axis: 8 ranks / model 2
