"""Named lock primitives and the runtime lock-order witness.

Every lock and condition of the port is created through
:func:`named_lock` / :func:`named_condition` with a name declared in the
package's rank table, ``utils/lockorder.toml``. In normal operation the
factories return plain ``threading.Lock`` / ``threading.Condition``
objects: no overhead, no change of behaviour. With ``TWD_DEBUG_LOCKS=1``
in the environment (read once at import) they return witness-wrapped
primitives that record every acquisition in a per-thread stack of held
locks and check, at acquire time, that it respects the table's order:

- acquiring lock B while holding lock A requires ``rank(A) < rank(B)``:
  the ranks are the one global order every thread follows, so two threads
  can never take one pair of locks in opposite orders (the ABBA deadlock);
- acquiring a lock whose name is not declared is itself a violation (an
  undeclared lock is invisible to the static check and to this witness);
- ``Condition.wait`` / ``wait_for`` release and reacquire the underlying
  lock, so the witness drops the condition from the held stack for the
  wait and checks the order again on reacquisition.

A violation raises :class:`LockOrderViolation` at the acquisition site and
is appended to the witness's ``violations``, so that one swallowed by a
serving thread's failure-isolating ``except`` is still visible. The
witness also records the observed acquisition edges (``edges``), the
acquisitions per name (``acquire_counts``) and the most holders a name
had at once (``peak_concurrency``).

The table ships inside the package and is read with ``tomllib``. With
``TWD_DEBUG_LOCKS=1`` set, a table that cannot be read fails the import:
a process asked to watch its locks never serves unwatched. The static
half is ``python -m tools.twdlint --config
tensorflow_web_deploy_tpu_torch/utils/lockorder.toml``.
"""

from __future__ import annotations

import os
import threading
import tomllib
from contextlib import contextmanager
from pathlib import Path

LOCKORDER_TOML = Path(__file__).resolve().parent / "lockorder.toml"


class LockOrderViolation(RuntimeError):
    """A lock acquisition broke the declared order (or used an undeclared
    name) while the runtime witness was active."""


class LockWitness:
    """Per-process acquisition-order checker over named locks.

    ``ranks`` maps lock name → integer rank; a thread may only acquire
    locks in strictly increasing rank order. All mutable state is guarded
    by one internal plain lock (never a witness lock: the witness must not
    recurse into itself)."""

    def __init__(self, ranks: dict[str, int], strict: bool = True):
        self.ranks = dict(ranks)
        self.strict = strict
        self._tls = threading.local()
        self._state_lock = threading.Lock()
        self.violations: list[str] = []
        # observed (held name, acquired name) pairs: the dynamic graph
        self.edges: set[tuple[str, str]] = set()
        self.acquire_counts: dict[str, int] = {}
        self._active: dict[str, int] = {}  # name → live holders
        self.peak_concurrency: dict[str, int] = {}

    def _held(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def holds(self, name: str) -> bool:
        """Whether the calling thread's held stack contains ``name``."""
        return name in self._held()

    def check_acquire(self, name: str) -> None:
        """Validate an acquisition about to happen, and raise on a fault.
        Runs before the real acquire, so an order violation surfaces as an
        exception instead of a deadlock."""
        held = self._held()
        problems = []
        rank = self.ranks.get(name)
        if rank is None:
            problems.append(f"acquisition of undeclared lock '{name}' (not in lockorder.toml)")
        for h in held:
            hrank = self.ranks.get(h)
            if h == name:
                problems.append(f"re-acquisition of non-reentrant lock '{name}' while "
                                "already holding it (self-deadlock)")
            elif rank is not None and hrank is not None and hrank >= rank:
                problems.append(f"lock-order inversion: acquiring '{name}' (rank {rank}) "
                                f"while holding '{h}' (rank {hrank}); declared order "
                                "requires strictly increasing ranks")
        if problems:
            msg = f"[{threading.current_thread().name}] " + "; ".join(problems)
            with self._state_lock:
                self.violations.append(msg)
            if self.strict:
                raise LockOrderViolation(msg)

    def did_acquire(self, name: str) -> None:
        held = self._held()
        with self._state_lock:
            for h in held:
                self.edges.add((h, name))
            self.acquire_counts[name] = self.acquire_counts.get(name, 0) + 1
            n = self._active[name] = self._active.get(name, 0) + 1
            self.peak_concurrency[name] = max(self.peak_concurrency.get(name, 0), n)
        held.append(name)

    def did_release(self, name: str) -> None:
        held = self._held()
        # the most recent hold of the name: a plain lock may be released
        # out of LIFO order
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break
        with self._state_lock:
            self._active[name] = self._active.get(name, 1) - 1


class _WitnessLock:
    """``threading.Lock`` lookalike reporting to a :class:`LockWitness`."""

    def __init__(self, name: str, witness: LockWitness):
        self._name = name
        self._witness = witness
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness.check_acquire(self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.did_acquire(self._name)
        return got

    def release(self) -> None:
        # bookkeeping before the real release: once the inner lock is free
        # another thread may take it, and a late record would show two
        # holders of a mutex (peak_concurrency must never over-count)
        self._witness.did_release(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _WitnessCondition:
    """``threading.Condition`` lookalike over a witness-checked lock. A wait
    releases the lock, so the held stack drops it for the wait's whole
    duration: a thread parked in ``wait`` holds nothing."""

    def __init__(self, name: str, witness: LockWitness):
        self._name = name
        self._witness = witness
        self._inner = threading.Condition()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness.check_acquire(self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.did_acquire(self._name)
        return got

    def release(self) -> None:
        self._witness.did_release(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    @contextmanager
    def _dropped(self):
        # Bookkeeping only when the caller holds the condition: a wait
        # without acquire gets the inner RuntimeError with the held stack
        # untouched, and later acquisitions on the thread stay clean.
        held = self._witness.holds(self._name)
        if held:
            self._witness.did_release(self._name)
        try:
            yield
        finally:
            # reacquired by the inner condition: a waiter holding a
            # higher-ranked lock across the wait inverts here
            if held:
                self._witness.check_acquire(self._name)
                self._witness.did_acquire(self._name)

    def wait(self, timeout: float | None = None) -> bool:
        with self._dropped():
            return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        with self._dropped():
            return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def load_lock_ranks(path: Path | str | None = None) -> dict[str, int]:
    """Lock name → rank from a rank table (default: the package's). Raises
    on a missing or malformed table, a duplicate name or a shared rank:
    two locks of one rank would be silently unordered."""
    with open(path or LOCKORDER_TOML, "rb") as f:
        table = tomllib.load(f)
    ranks: dict[str, int] = {}
    by_rank: dict[int, str] = {}
    for entry in table.get("locks", []):
        name, rank = entry["name"], int(entry["rank"])
        if name in ranks:
            raise ValueError(f"duplicate lock name {name!r} in the rank table")
        if rank in by_rank:
            raise ValueError(f"locks {by_rank[rank]!r} and {name!r} share rank {rank}")
        ranks[name], by_rank[rank] = rank, name
    return ranks


# Read once at process start: the factories stay one branch on the hot
# path (a Span makes a lock per request).
_ENABLED = os.environ.get("TWD_DEBUG_LOCKS", "") not in ("", "0")
_witness: LockWitness | None = LockWitness(load_lock_ranks()) if _ENABLED else None


def witness_active() -> LockWitness | None:
    """The live witness, or None when the switch is off."""
    return _witness if _ENABLED else None


def named_lock(name: str):
    """A mutex declared as ``name`` in the rank table: a plain
    ``threading.Lock`` unless the witness is active."""
    if _ENABLED:
        return _WitnessLock(name, _witness)
    return threading.Lock()


def named_condition(name: str):
    """A condition variable declared as ``name`` in the rank table: a plain
    ``threading.Condition`` unless the witness is active."""
    if _ENABLED:
        return _WitnessCondition(name, _witness)
    return threading.Condition()


@contextmanager
def forced_witness(ranks: dict[str, int], strict: bool = True):
    """Activate a fresh witness with ``ranks`` for the block, whatever
    ``TWD_DEBUG_LOCKS`` says: locks created inside it are witnessed. The
    previous state comes back on exit."""
    global _ENABLED, _witness
    prev = (_ENABLED, _witness)
    w = LockWitness(ranks, strict=strict)
    _ENABLED, _witness = True, w
    try:
        yield w
    finally:
        _ENABLED, _witness = prev
