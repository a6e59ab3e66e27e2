"""The port's kernel build cache (``serving/aotcache.py`` through
``ops/_build.py``) on the CPU, with a fake build standing in for nvcc: the
digest equals the JAX package's ``aotcache.key_digest``, and a miss, a
hit, a bad checksum, a key mismatch, a truncated library, a library that
cannot be loaded and an interrupted store each move the right counter and
end in a loaded library, rebuilt where the entry was unusable."""

import json
import os
import shutil

import pytest

from tensorflow_web_deploy_tpu.serving import aotcache as jaot
from tensorflow_web_deploy_tpu_torch.ops import _build
from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args
from tensorflow_web_deploy_tpu_torch.serving import aotcache as taot


def _shared_object() -> str:
    """A real shared library of this interpreter, for ctypes to load."""
    import importlib

    for name in ("_bisect", "_json", "_ctypes"):
        path = getattr(importlib.import_module(name), "__file__", None)
        if path and path.endswith(".so"):
            return path
    raise RuntimeError("no extension module of this interpreter is a shared library")


SO = _shared_object()


def _key(tag: str) -> dict:
    return {"format": taot.FORMAT_VERSION, "kind": "kernel", "source": f"csrc/{tag}.cu",
            "source_sha256": "0" * 64, "nvcc_flags": list(_build.NVCC_FLAGS),
            "nvcc": "Cuda compilation tools, release 12.8, V12.8.93", "arch": "sm_90a",
            "capability": [9, 0], "torch": "2.11.0+cu128", "torch_cuda": "12.8"}


@pytest.mark.parametrize("key", [
    {},
    {"b": 2, "a": [1, 2.5, None, True], "kind": "kernel"},
    {"nested": {"z": "é", "y": [[]]}, "n": -3},
    _key("unpack_ragged"),
])
def test_key_digest_matches_the_reference(key):
    assert taot.key_digest(key) == jaot.key_digest(key)
    assert len(taot.key_digest(key)) == 32


def test_from_config_and_the_flag(tmp_path):
    class Cfg:
        aot_cache_dir = None

    cfg = Cfg()
    assert taot.AotCache.from_config(cfg).dir == str(taot.DEFAULT_DIR)
    assert taot.DEFAULT_DIR == _build.BUILD_DIR
    for off in ("0", ""):
        cfg.aot_cache_dir = off
        assert taot.AotCache.from_config(cfg) is None
    cfg.aot_cache_dir = str(tmp_path / "c")
    assert taot.AotCache.from_config(cfg).dir == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()
    st = taot.stats(None)
    assert not st["enabled"] and st["dir"] is None and set(st) >= {
        "hits_total", "misses_total", "writes_total", "corrupt_total", "bytes_written_total",
        "compile_seconds_total", "deserialize_seconds_total"}
    args = parse_args(["--aot-cache-dir", "0"])
    assert config_from_args(args).aot_cache_dir == "0"
    assert config_from_args(parse_args([])).aot_cache_dir is None


@pytest.fixture
def fake_nvcc(monkeypatch):
    """``_build`` with a fake compiler (copies a real shared library) and a
    key that needs no card; counts the builds."""
    builds = []

    def compile_(name, out):
        builds.append(name)
        shutil.copyfile(SO, out)

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "kernel_key", _key)
    return builds


def _delta(before: dict) -> dict:
    now = taot.stats()
    return {k: now[k] - before[k] for k in ("hits_total", "misses_total", "writes_total",
                                            "corrupt_total")}


def _meta(cache: taot.AotCache, key: dict):
    return cache.library_path(key).with_suffix(".json")


def test_miss_then_hit(tmp_path, fake_nvcc):
    cache = taot.AotCache(tmp_path)
    before = taot.stats()
    assert _build._load_or_build("k_miss", cache) is not None
    assert fake_nvcc == ["k_miss"] and cache.entry_count() == 1
    assert _delta(before) == {"hits_total": 0, "misses_total": 1, "writes_total": 1,
                              "corrupt_total": 0}
    meta = json.loads(_meta(cache, _key("k_miss")).read_text())
    assert meta["key"] == _key("k_miss") and meta["bytes"] == os.path.getsize(SO)
    before = taot.stats()
    assert _build._load_or_build("k_miss", cache) is not None
    assert fake_nvcc == ["k_miss"]  # no build
    assert _delta(before) == {"hits_total": 1, "misses_total": 0, "writes_total": 0,
                              "corrupt_total": 0}
    assert taot.stats(cache)["enabled"] and taot.stats(cache)["dir"] == str(tmp_path)


def _flip_byte(cache, key):
    p = cache.library_path(key)
    body = bytearray(p.read_bytes())
    body[len(body) // 2] ^= 0xFF
    p.write_bytes(bytes(body))


def _truncate(cache, key):
    p = cache.library_path(key)
    p.write_bytes(p.read_bytes()[:1000])


def _other_key(cache, key):
    m = _meta(cache, key)
    meta = json.loads(m.read_text())
    meta["key"]["source_sha256"] = "f" * 64
    m.write_text(json.dumps(meta))


def _unloadable(cache, key):
    """A library whose checksum matches its JSON but ctypes cannot load."""
    junk = cache.library_path(key).with_name("junk.bin")
    junk.write_bytes(b"not an ELF shared object" * 100)
    assert cache.store(key, junk)


@pytest.mark.parametrize("damage", [_flip_byte, _truncate, _other_key, _unloadable],
                         ids=["bad-checksum", "truncated", "key-mismatch", "unloadable"])
def test_a_corrupt_entry_is_rebuilt(tmp_path, fake_nvcc, damage):
    cache = taot.AotCache(tmp_path)
    name = f"k_{damage.__name__}"
    key = _key(name)
    assert cache.store(key, SO)  # a whole entry, not loaded in this process yet
    damage(cache, key)
    before = taot.stats()
    assert cache.load(key) is None  # never raises
    assert _delta(before)["corrupt_total"] == 1
    before = taot.stats()
    assert _build._load_or_build(name, cache) is not None
    assert fake_nvcc == [name]  # rebuilt, never answered by a plain version
    assert _delta(before) == {"hits_total": 0, "misses_total": 0, "writes_total": 1,
                              "corrupt_total": 1}
    before = taot.stats()
    assert cache.load(key) is not None
    assert _delta(before)["hits_total"] == 1


def test_an_interrupted_store_is_a_miss(tmp_path, fake_nvcc, monkeypatch):
    cache = taot.AotCache(tmp_path)
    key = _key("k_interrupted")
    real = taot._write_atomic

    def crash_on_json(path, data):
        if path.suffix == ".json":
            raise OSError("disk full")
        real(path, data)

    monkeypatch.setattr(taot, "_write_atomic", crash_on_json)
    before = taot.stats()
    assert _build._load_or_build("k_interrupted", cache) is not None  # loaded all the same
    assert _delta(before)["writes_total"] == 0
    # the library landed, its JSON did not; no temporary file is left
    assert cache.library_path(key).exists() and not _meta(cache, key).exists()
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp-")]
    monkeypatch.setattr(taot, "_write_atomic", real)
    before = taot.stats()
    assert _build._load_or_build("k_interrupted", cache) is not None
    assert fake_nvcc == ["k_interrupted"] * 2
    assert _delta(before) == {"hits_total": 0, "misses_total": 1, "writes_total": 1,
                              "corrupt_total": 0}


def test_no_cache_builds_into_a_temporary_directory(tmp_path, fake_nvcc, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    before = taot.stats()
    assert _build.load("k_nocache", cache=None) is not None
    assert _build.load("k_nocache", cache=None) is not None  # the process's memo
    assert fake_nvcc == ["k_nocache"]
    assert _delta(before) == {"hits_total": 0, "misses_total": 0, "writes_total": 0,
                              "corrupt_total": 0}
    assert taot.stats()["compile_seconds_total"] >= before["compile_seconds_total"]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    def broken(name, out):
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu")

    monkeypatch.setattr(_build, "_compile", broken)
    monkeypatch.setattr(_build, "kernel_key", _key)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._load_or_build("k_broken", taot.AotCache(tmp_path))
    assert taot.AotCache(tmp_path).entry_count() == 0
