# Copy of src/repro/analysis/lockwatch.py (the JAX package's storage core); only the package name in imports differs.
"""Runtime lock-order watchdog (lockdep-lite).

Opt-in via ``REPRO_LOCKWATCH=1``. When enabled, :func:`make_lock` returns an
instrumented :class:`WatchedLock` that threads a per-thread acquisition stack
through every ``core/`` lock and feeds a process-global *name-based*
acquisition graph (one node per lock CLASS, e.g. ``PageCache._lock``, not per
instance — like the kernel's lockdep, one bad nesting anywhere proves the
discipline broken everywhere). On each blocking acquisition the watchdog:

* records an edge ``held → acquiring`` for every lock currently held,
* checks the declared partial order (:mod:`repro.analysis.lock_order`) and
  flags out-of-order edges immediately,
* runs an eager cycle check over the blocking-edge graph — an ABBA pattern is
  reported the moment the second ordering appears, even if the two nestings
  happened in different tests, on different threads, minutes apart, and never
  actually deadlocked.

Try-lock acquisitions (``blocking=False`` / ``timeout=0``) are recorded for
diagnostics but excluded from cycle detection: a trylock cannot deadlock, and
``ReplicaBalancer.rebalance`` leans on exactly that.

:func:`install_blocking_hooks` additionally patches ``Future.result``,
``Future.exception`` and ``Thread.join`` so that *waiting on other work while
holding a non-blocking-class lock* (the cross-pool join-under-lock bug family)
is reported with the offending lock names.

When ``REPRO_LOCKWATCH`` is unset, :func:`make_lock` returns a plain
``threading.Lock()`` — the identical object production code would have
constructed inline, so the disabled path is zero-overhead by construction
(``test_analysis.py`` asserts the class identity; the bench smoke row in the
PR description shows the measured overhead is noise).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import lock_order

ENV_VAR = "REPRO_LOCKWATCH"


def enabled() -> bool:
    """True when the watchdog is switched on for this process."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str  #: "lock-order" | "lock-cycle" | "join-under-lock" | ...
    message: str
    thread: str
    held: Tuple[str, ...]

    def __str__(self) -> str:
        held = " -> ".join(self.held) if self.held else "(none)"
        return f"[{self.rule}] {self.message} (thread={self.thread}, held: {held})"


class LockWatch:
    """The acquisition-graph recorder. One process-global instance backs
    :func:`make_lock`; tests build private instances to seed violations
    without polluting the global graph."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards the graph + violation list only
        self._tls = threading.local()
        #: blocking acquisition edges held -> {acquiring}; cycle-checked
        self.blocking_edges: Dict[str, Set[str]] = {}
        #: try-lock edges; diagnostics only, never deadlock
        self.try_edges: Dict[str, Set[str]] = {}
        self.violations: List[Violation] = []
        self.names_seen: Set[str] = set()

    # -- per-thread stack ---------------------------------------------------
    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held(self) -> Tuple[str, ...]:
        return tuple(self._stack())

    # -- event hooks (called by WatchedLock) --------------------------------
    def before_blocking_acquire(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            self._record(
                "lock-cycle",
                f"re-acquiring {name} already held by this thread "
                f"(non-reentrant: guaranteed self-deadlock)",
            )
            return
        if not stack:
            return
        for held in stack:
            reason = lock_order.order_violation(held, name)
            if reason is not None:
                self._record("lock-order", reason)
        with self._mu:
            new_edge = False
            for held in stack:
                targets = self.blocking_edges.setdefault(held, set())
                if name not in targets:
                    targets.add(name)
                    new_edge = True
            if new_edge:
                cycle = self._find_cycle_locked(name, stack)
        if new_edge and cycle is not None:
            self._record(
                "lock-cycle",
                "acquisition graph contains a cycle (potential deadlock): "
                + " -> ".join(cycle),
            )

    def _find_cycle_locked(
        self, start: str, held: List[str]
    ) -> Optional[List[str]]:
        """DFS from ``start`` over blocking edges; a path back to any held
        lock closes a cycle with the edges just added."""
        held_set = set(held)
        path: List[str] = [start]
        seen: Set[str] = set()

        def dfs(node: str) -> Optional[List[str]]:
            for nxt in self.blocking_edges.get(node, ()):
                if nxt in held_set:
                    return path + [nxt]
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                found = dfs(nxt)
                if found is not None:
                    return found
                path.pop()
            return None

        return dfs(start)

    def on_acquired(self, name: str, blocking: bool) -> None:
        if not blocking:
            stack = self._stack()
            with self._mu:
                for held in stack:
                    self.try_edges.setdefault(held, set()).add(name)
        self.names_seen.add(name)
        self._stack().append(name)

    def on_released(self, name: str) -> None:
        stack = self._stack()
        # pop the most recent occurrence: condition-variable wait releases
        # the aliased lock from mid-stack-looking positions legitimately
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- blocking-call check (used by the installed hooks) ------------------
    def check_blocking_call(self, what: str) -> None:
        offenders = [
            n for n in self._stack() if not lock_order.allows_blocking(n)
        ]
        if offenders:
            self._record(
                "join-under-lock",
                f"{what} while holding {', '.join(offenders)} — waiting on "
                f"other work under a non-blocking-class lock can deadlock "
                f"when that work needs the same lock",
            )

    def _record(self, rule: str, message: str) -> None:
        v = Violation(
            rule, message, threading.current_thread().name, self.held()
        )
        with self._mu:
            self.violations.append(v)

    # -- test-suite interface ------------------------------------------------
    def assert_clean(self, reset: bool = True) -> None:
        with self._mu:
            found, self.violations = self.violations, (
                [] if reset else self.violations
            )
        if found:
            raise AssertionError(
                "lockwatch recorded %d violation(s):\n%s"
                % (len(found), "\n".join(f"  {v}" for v in found))
            )


class WatchedLock:
    """Drop-in ``threading.Lock`` replacement reporting to a LockWatch.

    Exposes exactly the protocol ``threading.Condition`` needs from a raw
    lock — ``acquire(blocking, timeout)`` / ``release`` / ``locked`` — so
    conditions built over a WatchedLock keep the acquisition stack truthful
    across ``wait()`` (the release inside wait pops, the re-acquire pushes).
    """

    __slots__ = ("name", "_lock", "_watch")

    def __init__(self, name: str, watch: LockWatch) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        is_blocking = bool(blocking) and timeout != 0
        if is_blocking:
            self._watch.before_blocking_acquire(self.name)
            got = self._lock.acquire(True, timeout)
        else:
            got = self._lock.acquire(False)
        if got:
            self._watch.on_acquired(self.name, is_blocking)
        return got

    def release(self) -> None:
        self._lock.release()
        self._watch.on_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<WatchedLock {self.name} locked={self._lock.locked()}>"


# -- the process-global watch + factory -------------------------------------

_WATCH: Optional[LockWatch] = None
_WATCH_MU = threading.Lock()


def watch() -> LockWatch:
    """The process-global LockWatch (created on first use)."""
    global _WATCH
    if _WATCH is None:
        with _WATCH_MU:
            if _WATCH is None:
                _WATCH = LockWatch()
    return _WATCH


def make_lock(name: str) -> threading.Lock:
    """Lock factory every ``core/`` lock construction goes through.

    Disabled (default): returns a plain ``threading.Lock()`` — byte-for-byte
    the object the code would otherwise construct inline; zero overhead.
    Enabled: returns a :class:`WatchedLock` wired to the global watch. The
    ``name`` must appear in :data:`repro.analysis.lock_order.LOCKS`; an
    undeclared name is itself recorded as a violation.
    """
    if not enabled():
        return threading.Lock()
    w = watch()
    if lock_order.get(name) is None:
        w._record(
            "undeclared-lock",
            f"make_lock({name!r}): lock not declared in "
            f"analysis/lock_order.py — add it to the hierarchy",
        )
    return WatchedLock(name, w)


def make_condition(
    name: str, lock: Optional[object] = None
) -> threading.Condition:
    """Condition factory. With ``lock`` given, wraps it (the condition then
    aliases that lock's name in the acquisition graph — declare the alias in
    lock_order, e.g. ``VersionManager._published_cv``). Without, builds the
    condition over its own lock (watched under ``name`` when enabled)."""
    if not enabled():
        return threading.Condition(lock)
    if lock is None:
        w = watch()
        if lock_order.get(name) is None:
            w._record(
                "undeclared-lock",
                f"make_condition({name!r}): lock not declared in "
                f"analysis/lock_order.py — add it to the hierarchy",
            )
        lock = WatchedLock(name, w)
    return threading.Condition(lock)


# -- join-under-lock hooks ---------------------------------------------------

_HOOKS: Optional[Tuple[object, object, object]] = None


def install_blocking_hooks(target: Optional[LockWatch] = None) -> None:
    """Patch ``Future.result`` / ``Future.exception`` / ``Thread.join`` to
    report waits performed while holding a non-blocking-class lock. Calls
    that provably cannot block (future already done; ``join(timeout=0)``;
    dead thread) are exempt. Idempotent; undo with
    :func:`remove_blocking_hooks`."""
    global _HOOKS
    if _HOOKS is not None:
        return
    w = target if target is not None else watch()
    orig_result = Future.result
    orig_exception = Future.exception
    orig_join = threading.Thread.join

    def patched_result(self, timeout=None):
        if not self.done():
            w.check_blocking_call("Future.result()")
        return orig_result(self, timeout)

    def patched_exception(self, timeout=None):
        if not self.done():
            w.check_blocking_call("Future.exception()")
        return orig_exception(self, timeout)

    def patched_join(self, timeout=None):
        if timeout != 0 and self.is_alive():
            w.check_blocking_call(f"Thread.join({self.name})")
        return orig_join(self, timeout)

    Future.result = patched_result
    Future.exception = patched_exception
    threading.Thread.join = patched_join
    _HOOKS = (orig_result, orig_exception, orig_join)


def remove_blocking_hooks() -> None:
    global _HOOKS
    if _HOOKS is None:
        return
    orig_result, orig_exception, orig_join = _HOOKS
    Future.result = orig_result
    Future.exception = orig_exception
    threading.Thread.join = orig_join
    _HOOKS = None
