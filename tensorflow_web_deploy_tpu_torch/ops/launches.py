"""Launch counters of the hand-written kernels' wrappers.

Each wrapper has a plain integer ``<wrapper>.launches`` and calls
:func:`count` where it launches its kernel, and nowhere else, so a run can
show that its path went through the kernel. Launch threads dispatch
batches at once, so the counters move under one lock.

A CUDA graph's capture runs the wrappers without running their kernels;
its replays run the kernels without the wrappers. So while a thread
captures (:func:`recording`), its launches go into the capture's record
instead, and every replay adds that record (:func:`add`): the counters
keep counting what the device ran.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from ..utils.locks import named_lock

_lock = named_lock("ops.launch_counter")
_local = threading.local()


def count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[wrapper] = record.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


@contextmanager
def recording():
    """Within the block, this thread's launches fill the yielded record
    ({wrapper: launches}) instead of the counters."""
    record: dict = {}
    _local.record = record
    try:
        yield record
    finally:
        _local.record = None


def add(record: dict) -> None:
    """Count a record's launches once more (one replay of its graph)."""
    with _lock:
        for wrapper, n in record.items():
            wrapper.launches += n
