"""The port's slot-leased batcher (``serving/batcher.py``) on the CPU.

Against the JAX package's ``Batcher``: one scripted sequence of leases,
commits and releases gives the same batches in both (keys, row counts,
hole positions, answers), and the adaptive window's controller gives the
same windows for the same backlog (abs 1e-12). Then the slot behaviour the
reference's own tests pin (``tests/test_batcher.py``, ``test_staging.py``):
a lease's row is slab memory, a JPEG costs one host copy, released and
expired slots become holes, an all-hole builder is discarded, leasing
blocks at the slot cap or fails fast with ``BacklogFull``, and a failed
dispatch fails only its own futures and gives its slab back.

The engines here are fakes over the real slabs of each package: every row
answers its first byte and its valid size.
"""

import io
import threading
import time

import numpy as np
import pytest
from PIL import Image

from tensorflow_web_deploy_tpu.serving import batcher as jbatcher
from tensorflow_web_deploy_tpu.serving import engine as jengine
from tensorflow_web_deploy_tpu_torch import native
from tensorflow_web_deploy_tpu_torch.serving.batcher import (
    Batcher,
    BacklogFull,
    LeaseExpired,
    ShuttingDown,
)
from tensorflow_web_deploy_tpu_torch.serving.engine import RaggedSlab, StagingSlab

MAX_BATCH = 4
BUCKETS = (1, 2, 4)


def _bucket(n):
    return next(b for b in BUCKETS if n <= b)


def _answers(n, firsts, hws):
    """(scores, indices) per row: the row's first byte and h·1000 + w, or
    -1 for a hole."""
    scores = np.array([[f, -1 if hw is None else hw[0] * 1000 + hw[1]]
                       for f, hw in zip(firsts, hws)], np.float32).reshape(n, 2)
    return scores, np.arange(n, dtype=np.int32)[:, None]


class PortEngine:
    """The port engine's staging API over its real slabs in host memory.
    ``delay_s`` slows each fetch; ``fail`` makes dispatch raise."""

    max_batch = MAX_BATCH
    batch_buckets = BUCKETS
    ragged = True

    def __init__(self, delay_s=0.0, fail=False):
        self.delay_s, self.fail = delay_s, fail
        self.dispatched = []  # (key, n, [hw or None per row])
        self.returned = []  # slabs back in the pool
        self.slabs = []

    def pick_batch_bucket(self, n):
        return _bucket(n)

    def _arm(self, slab):
        slab.arm(self.returned.append)
        self.slabs.append(slab)
        return slab

    def acquire_staging(self, s):
        return self._arm(StagingSlab(s, (s, s, 3), MAX_BATCH, pinned=False))

    def acquire_ragged(self, s):
        return self._arm(RaggedSlab(s, MAX_BATCH, pinned=False))

    def release_staging(self, slab):
        slab.finish()

    def _record(self, key, slab, n, firsts, hws):
        self.dispatched.append((key, n, hws))
        slab.finish()
        if self.fail:
            raise RuntimeError("dispatch failed")
        return _answers(n, firsts, hws)

    def dispatch_staged(self, slab, n):
        hws = [tuple(int(v) for v in slab.trailer[i].view(">u2")) for i in range(n)]
        hws = [None if hw == (1, 1) else hw for hw in hws]
        firsts = [int(slab.canvases[i].reshape(-1)[0]) for i in range(n)]
        return self._record(slab.key, slab, n, firsts, hws)

    def dispatch_ragged(self, slab, n):
        slab.truncate(n)
        hws = [tuple(int(v) for v in m[1:3]) if m[3] else None for m in slab.meta[:n]]
        firsts = [int(slab.host[m[0]]) for m in slab.meta[:n]]
        return self._record(slab.key, slab, n, firsts, hws)

    def fetch_outputs(self, handle):
        time.sleep(self.delay_s)
        return handle


class RefEngine:
    """The same over the JAX package's slabs, with its staging API."""

    max_batch = MAX_BATCH
    batch_buckets = BUCKETS
    ragged = True
    supports_slot_lease = True

    def __init__(self):
        self.dispatched = []

    def pick_batch_bucket(self, n):
        return _bucket(n)

    def acquire_staging(self, n, row_shape):
        slab = jengine.StagingSlab(tuple(row_shape), _bucket(n), packed=True)
        slab.arm(lambda _: None)
        return slab

    def acquire_ragged(self, n, s):
        slab = jengine.RaggedSlab(s, _bucket(n))
        slab.arm(lambda _: None)
        return slab

    def release_staging(self, slab):
        slab.finish_fetch()

    def dispatch_staged(self, slab, n):
        slab.pad_from(n)
        hws = [tuple(int(v) for v in slab.trailer[i].view(">u2")) for i in range(n)]
        hws = [None if hw == (1, 1) else hw for hw in hws]
        firsts = [int(slab.canvases[i].reshape(-1)[0]) for i in range(n)]
        self.dispatched.append((("classic", slab.canvases.shape[2]), n, hws))
        return slab, _answers(n, firsts, hws)

    def dispatch_ragged(self, slab, n, spans=()):
        # the reference pads a hole as a valid 1×1 image
        hws = [tuple(int(v) for v in m[1:3]) if m[3] else None for m in slab.meta[:n]]
        hws = [None if hw in (None, (1, 1)) else hw for hw in hws]
        firsts = [int(slab.buf[m[0]]) for m in slab.meta[:n]]
        self.dispatched.append((("ragged", slab.canvas_s), n, hws))
        return slab, _answers(n, firsts, hws)

    def fetch_outputs(self, handle):
        slab, out = handle
        slab.finish_fetch()
        return out


def _fill(lease, tag):
    lease.row.reshape(-1)[:3] = tag


def _script(b):
    """One sequence of leases, commits and releases; returns the committed
    leases' futures by tag."""
    futures = {}
    classic = [b.lease((8, 8, 3)) for _ in range(2)]
    other = b.lease((16, 16, 3))
    classic += [b.lease((8, 8, 3)) for _ in range(2)]  # full: sealed by capacity
    for tag, lease, hw in ((11, classic[0], (5, 6)), (13, classic[2], (7, 8)),
                           (14, classic[3], (8, 8))):
        _fill(lease, tag)
        futures[tag] = lease.commit(hw)
    classic[1].release()
    ragged = [b.lease_ragged(need, 8) for need in (147, 147, 189, 189)]
    for tag, lease, hw in ((21, ragged[0], (7, 7)), (22, ragged[1], (7, 7)),
                           (24, ragged[3], (7, 9))):
        _fill(lease, tag)
        futures[tag] = lease.commit(hw)
    ragged[2].release()
    _fill(other, 31)
    futures[31] = other.commit((9, 10))
    futures[32] = b.submit(np.full((16, 16, 3), 32, np.uint8), (16, 12))
    b.lease((8, 8, 3)).release()  # a builder of holes only
    b.lease_ragged(30, 8).release()
    return futures


def test_batches_match_the_reference_batcher():
    kw = dict(max_batch=MAX_BATCH, max_delay_ms=60_000, adaptive_delay=False,
              pipeline_depth=8, lease_timeout_s=60)
    runs = []
    for eng, cls in ((PortEngine(), Batcher), (RefEngine(), jbatcher.Batcher)):
        b = cls(eng, **kw)
        b.start()
        futures = _script(b)
        b.stop()
        answers = {tag: f.result(timeout=10) for tag, f in futures.items()}
        batches = sorted(eng.dispatched, key=lambda d: (str(d[0]), d[1]))
        runs.append((batches, {t: (s.tolist(), i.tolist()) for t, (s, i) in answers.items()}))
    assert runs[0] == runs[1]
    batches, answers = runs[0]
    assert [(k, n, [hw is None for hw in hws]) for k, n, hws in batches] == [
        (("classic", 16), 2, [False, False]),
        (("classic", 8), 4, [False, True, False, False]),
        (("ragged", 8), 4, [False, False, True, False]),
    ]  # and the two builders of holes were discarded
    assert answers[13] == ([13.0, 7008.0], [2]) and answers[32] == ([32.0, 16012.0], [1])


def test_adaptive_window_matches_the_reference_controller():
    class Eng:
        max_batch = 32

    port = Batcher(Eng(), max_batch=32, max_delay_ms=5.0)
    ref = jbatcher.Batcher(Eng(), max_batch=32, max_delay_ms=5.0)
    assert port._delay_s == ref._delay_s == 0.0
    depths = [0, 1, 5, 31, 64, 64, 3, 0, 0, 12, 40, 2] + list(
        np.random.RandomState(0).randint(0, 80, 200))
    for d in depths:
        port._pending_slots = ref._pending_slots = int(d)
        assert abs(port._update_delay() - ref._update_delay()) <= 1e-12
        assert abs(port._delay_s - ref._delay_s) <= 1e-12
    pinned = Batcher(Eng(), max_batch=32, max_delay_ms=5.0, adaptive_delay=False)
    assert pinned._update_delay() == 0.005


def _jpeg(h, w, seed=0):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture
def batcher():
    eng = PortEngine()
    b = Batcher(eng, max_batch=MAX_BATCH, max_delay_ms=60_000, adaptive_delay=False,
                lease_timeout_s=60)
    b.start()
    yield b
    b.stop()


def test_lease_row_is_slab_memory(batcher):
    classic = batcher.lease((8, 8, 3))
    ragged = batcher.lease_ragged(40 * 3, 8)
    for lease in (classic, ragged):
        slab = lease.builder.slab
        assert np.shares_memory(lease.row, slab.host)
        assert np.shares_memory(lease.row, slab.buf.numpy())
    assert classic.row.size == 8 * 8 * 3 + 4  # canvas bytes, then the trailer
    classic.release()
    ragged.release()


def test_a_jpeg_costs_one_host_copy(batcher):
    if not native.available():
        pytest.skip(f"no native decoder: {native.status()['reason']}")
    data = _jpeg(20, 30)
    s, need, hw0, _ = native.plan_decode_packed(data, (32,))
    want = np.empty(need, np.uint8)
    assert native.decode_packed_into(data, want, s) == hw0
    lease = batcher.lease_ragged(need, s)
    slab = lease.builder.slab
    hw = native.decode_packed_into(data, lease.row, s)  # libjpeg writes the slab
    off = slab.meta[lease.index, 0]
    np.testing.assert_array_equal(slab.host[off : off + need], want)
    lease.commit(hw)
    # the classic wire: canvas and trailer straight into the pinned row
    row_lease = batcher.lease((32, 32, 3))
    assert native.decode_into_row(data, row_lease.row, 32, "rgb", trailer=True) == hw0
    assert tuple(row_lease.row[-4:].view(">u2")) == hw0
    row_lease.commit(hw0)
    assert batcher.stats()["host_copies"] == 2  # one per image
    batcher.submit(np.zeros((32, 32, 3), np.uint8), (4, 4))
    assert batcher.stats()["host_copies"] == 4  # decoded elsewhere: two


def test_released_slot_becomes_a_hole(batcher):
    eng = batcher.engine
    keep = [batcher.lease((8, 8, 3)) for _ in range(2)]
    gone = batcher.lease((8, 8, 3))
    last = batcher.lease((8, 8, 3))
    for tag, lease in ((1, keep[0]), (2, keep[1]), (4, last)):
        _fill(lease, tag)
        lease.commit((3, tag))
    gone.release()
    assert last.future.result(timeout=10)[0].tolist() == [4, 3004]
    assert eng.dispatched == [(("classic", 8), 4, [(3, 1), (3, 2), None, (3, 4)])]
    with pytest.raises(RuntimeError, match="released"):
        gone.future.result(timeout=1)
    assert batcher.stats()["holes"] == 1


def test_lease_timeout_expires_the_slot_and_the_batch_proceeds():
    eng = PortEngine()
    b = Batcher(eng, max_batch=2, max_delay_ms=1, lease_timeout_s=0.2).start()
    try:
        dead = b.lease_ragged(27, 8)  # its lessee never returns
        live = b.lease_ragged(27, 8)
        _fill(live, 7)
        t0 = time.monotonic()
        assert live.commit((3, 3)).result(timeout=10)[0].tolist() == [7, 3003]
        assert 0.15 < time.monotonic() - t0 < 5
        with pytest.raises(LeaseExpired):
            dead.future.result(timeout=1)
        assert eng.dispatched == [(("ragged", 8), 2, [None, (3, 3)])]
        slab = dead.builder.slab
        assert slab not in eng.returned  # the dead lessee may still write its row
        dead.commit((3, 3))  # it comes back late: nothing ships, the slab is freed
        assert slab in eng.returned and b.stats()["lease_timeouts"] == 1
    finally:
        b.stop()


def test_all_hole_builder_is_discarded():
    eng = PortEngine()
    b = Batcher(eng, max_batch=MAX_BATCH, max_delay_ms=1).start()
    try:
        leases = [b.lease((8, 8, 3)) for _ in range(3)]
        slab = leases[0].builder.slab
        for lease in leases:
            lease.release()
        deadline = time.monotonic() + 5
        while b.stats()["discarded"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.stats()["discarded"] == 1 and eng.dispatched == []
        assert slab in eng.returned
    finally:
        b.stop()


def test_leasing_blocks_at_the_slot_cap():
    eng = PortEngine()
    b = Batcher(eng, max_batch=2, max_delay_ms=60_000, adaptive_delay=False,
                pipeline_depth=1, lease_timeout_s=60).start()
    try:
        cap = 2 * max(2, 1)
        held = [b.lease_ragged(3, 8) for _ in range(cap)]
        got = []
        t = threading.Thread(target=lambda: got.append(b.lease_ragged(3, 8)))
        t.start()
        time.sleep(0.3)
        assert t.is_alive() and not got  # blocked: cap slots outstanding
        for lease in held[:2]:
            lease.commit((1, 1))  # a full builder seals, its slots leave the cap
        t.join(5)
        assert not t.is_alive() and len(got) == 1
        for lease in held[2:] + got:
            lease.release()
    finally:
        b.stop()


def test_backlog_full_fails_fast_with_a_retry_after():
    eng = PortEngine()
    b = Batcher(eng, max_batch=MAX_BATCH, max_delay_ms=60_000, adaptive_delay=False,
                max_queue=2, lease_timeout_s=60).start()
    try:
        held = [b.lease((8, 8, 3)) for _ in range(2)]
        t0 = time.monotonic()
        with pytest.raises(BacklogFull) as e:
            b.lease((8, 8, 3))
        assert time.monotonic() - t0 < 0.1 and 1.0 <= e.value.retry_after_s <= 30.0
        with pytest.raises(BacklogFull):
            b.submit(np.zeros((8, 8, 3), np.uint8), (8, 8))
        assert b.stats()["backlog_rejects"] == 2
        held[0].release()
        b.lease((8, 8, 3)).release()  # room again
        held[1].release()
    finally:
        b.stop()
    with pytest.raises(ShuttingDown):
        b.lease((8, 8, 3))
    with pytest.raises(ShuttingDown):
        b.submit(np.zeros((8, 8, 3), np.uint8), (8, 8)).result(timeout=1)


def test_failed_dispatch_fails_only_its_futures_and_recycles_the_slab():
    eng = PortEngine()
    b = Batcher(eng, max_batch=2, max_delay_ms=1).start()
    try:
        eng.fail = True
        bad = [b.submit(np.full((8, 8, 3), 5, np.uint8), (8, 8)) for _ in range(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="dispatch failed"):
                f.result(timeout=10)
        assert eng.slabs[0] in eng.returned
        eng.fail = False
        good = b.submit(np.full((16, 16, 3), 9, np.uint8), (16, 16))
        assert good.result(timeout=10)[0].tolist() == [9, 16016]
        assert b.stats()["inflight"] == 0
    finally:
        b.stop()
