"""The PyTorch/CUDA port stands alone: no module of
``tensorflow_web_deploy_tpu_torch`` and not ``chip_smoke.py`` imports JAX,
flax or the JAX package, no file of the port names a path inside the JAX
package (its native decoder compiles its own ``decode.c``), and its entry
points run on the card unless the caller asks for the CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tensorflow_web_deploy_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorflow_web_deploy_tpu")


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_imports_in_the_port_or_chip_smoke():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imported_modules(f) if _forbidden(m))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


# a path or module inside the JAX package; the port's own name goes on with "_torch"
JAX_PATH = re.compile(r"tensorflow_web_deploy_tpu(?!_torch)[/.\\]")


def test_no_port_file_names_a_path_in_the_jax_package():
    files = [f for f in sorted(PORT.rglob("*"))
             if f.is_file() and f.suffix in (".py", ".c", ".cu", ".h") and ".build" not in f.parts]
    assert {f.suffix for f in files} >= {".py", ".c", ".cu"}
    bad = {str(f.relative_to(ROOT)): JAX_PATH.findall(f.read_text()) for f in files}
    assert not {f: m for f, m in bad.items() if m}
    assert JAX_PATH.search("tensorflow_web_deploy_tpu/native/decode.c")  # the check bites

    from tensorflow_web_deploy_tpu_torch import native

    assert native._SRC == PORT / "native" / "decode.c" and native._SRC.exists()
    assert native.BUILD_DIR == PORT / ".build"


def test_port_runs_without_loading_jax():
    code = (
        "import sys, numpy as np\n"
        "from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine\n"
        "from tensorflow_web_deploy_tpu_torch.server import start_server\n"
        "from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig\n"
        "cfg = ServerConfig(model=ModelConfig(name='inception_v3', zoo_width=0.25,\n"
        "    zoo_classes=4, input_size=(75, 75), dtype='f32'), canvas_buckets=(32,),\n"
        "    max_batch=2, wire_format='yuv420', resize='kernel', warmup=False)\n"
        "eng = InferenceEngine(cfg, device='cpu')\n"
        "eng.run_batch(np.zeros((1, 48, 32), np.uint8), np.full((1, 2), 32, np.int32))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'tensorflow_web_deploy_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# the response cache and overload control: each is a numpy-only or pure
# Python module in the JAX package, of which the port keeps its own copy
OWN_COPIES = ("serving/respcache.py", "serving/overload.py", "serving/chaos.py",
              "utils/metrics.py")


@pytest.mark.parametrize("rel", OWN_COPIES)
def test_the_ports_own_copies_import_nothing_of_the_jax_package(rel):
    path = PORT / rel
    assert path.exists() and path in set(PORT.rglob("*.py"))  # the scans above cover it
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    assert not JAX_PATH.findall(path.read_text())
    mod = "tensorflow_web_deploy_tpu_torch." + rel[:-3].replace("/", ".")
    code = (f"import sys, importlib\nimportlib.import_module({mod!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'tensorflow_web_deploy_tpu')]\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig
    from tensorflow_web_deploy_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServerConfig(model=ModelConfig(name="inception_v3", zoo_width=0.25, zoo_classes=4,
                                         input_size=(75, 75)), canvas_buckets=(32,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    code = (
        "import sys, torch, runpy\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
