"""Runtime lock-order witness for the port (``repro/analysis/lock_witness.py``
with :data:`_WRAP_SPECS` naming ``repro_torch`` classes).

Installing it monkey-wraps the named locks of every serving object
constructed while it is active, records each thread's real acquisition
stack, and checks every acquisition against the declared partial order in
:mod:`repro_torch.analysis.lock_order` (the JAX package's lock names, so one
order covers both packages). Violations are *recorded*, not raised —
raising inside a serving thread would wedge the object mid-operation — and
the tests assert none at teardown.

Witness locks created in one session keep delegating after the session is
deactivated but stop recording, so daemon threads that outlive a test
cannot pollute a later test's session.
"""
from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import lock_order

# (module, class, init method) -> {attr: qualified lock name}
_WRAP_SPECS: Tuple[Tuple[str, str, str, Dict[str, str]], ...] = (
    ("repro_torch.serving.engine", "InferenceEngine", "__init__",
     {"_lock": "InferenceEngine._lock",
      "_pipe_lock": "InferenceEngine._pipe_lock"}),
    ("repro_torch.serving.engine", "ScoringPool", "__init__",
     {"_buf_lock": "ScoringPool._buf_lock"}),
    ("repro_torch.serving.shard_router", "ShardRouter", "__init__",
     {"_fleet_lock": "ShardRouter._fleet_lock"}),
    ("repro_torch.serving.shard_router", "ReplicaHealth", "__init__",
     {"_lock": "ReplicaHealth._lock"}),
    ("repro_torch.serving.update_pipe", "UpdatePipe", "__init__",
     {"_ingest_lock": "UpdatePipe._ingest_lock",
      "_pending_cv": "UpdatePipe._pending_cv",
      "_thread_lock": "UpdatePipe._thread_lock"}),
    ("repro_torch.serving.faults", "FaultPlan", "__post_init__",
     {"_lock": "FaultPlan._lock"}),
)


@dataclass(frozen=True)
class OrderViolation:
    thread: str
    held: str            # qualified name of the already-held lock
    held_line: str       # where it was taken (summary frame)
    acquiring: str       # qualified name being acquired
    stack: str           # acquisition stack of the offending acquire

    def __str__(self) -> str:
        return (f"[{self.thread}] acquires {self.acquiring} while holding "
                f"{self.held} (taken at {self.held_line}) — contradicts "
                f"analysis/lock_order.py\n{self.stack}")


class Session:
    """One installed witness: violation sink + per-thread held stacks."""

    def __init__(self) -> None:
        self.active = True
        self.violations: List[OrderViolation] = []
        self._mu = threading.Lock()
        self._tl = threading.local()

    def _held(self) -> List[Tuple[int, str, int, str]]:
        held = getattr(self._tl, "held", None)
        if held is None:
            held = self._tl.held = []
        return held

    def record(self, v: OrderViolation) -> None:
        with self._mu:
            self.violations.append(v)

    def on_acquired(self, qual: str, obj_id: int) -> None:
        rank = lock_order.rank_of(qual)
        held = self._held()
        if rank is not None:
            stack = "".join(traceback.format_stack(limit=8)[:-2])
            for (r, q, oid, site) in held:
                if r is None:
                    continue
                # equal rank on the *same* instance would self-deadlock and
                # never happens live; equal rank on a different instance is
                # an unordered-peer nesting — both are violations
                if r > rank or (r == rank and oid != obj_id):
                    self.record(OrderViolation(
                        thread=threading.current_thread().name,
                        held=q, held_line=site, acquiring=qual,
                        stack=stack))
        site = traceback.extract_stack(limit=4)[0]
        held.append((rank, qual, obj_id,
                     f"{site.filename}:{site.lineno}"))

    def on_released(self, qual: str, obj_id: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] == qual and held[i][2] == obj_id:
                del held[i]
                return


class WitnessLock:
    """Order-checking wrapper around a Lock/RLock/Condition instance."""

    def __init__(self, inner, qual: str, session: Session):
        self._inner = inner
        self._qual = qual
        self._session = session

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got and self._session.active:
            self._session.on_acquired(self._qual, id(self))
        return got

    def release(self, *args, **kwargs):
        if self._session.active:
            self._session.on_released(self._qual, id(self))
        return self._inner.release(*args, **kwargs)

    def __enter__(self):
        self._inner.__enter__()
        if self._session.active:
            self._session.on_acquired(self._qual, id(self))
        return self

    def __exit__(self, *exc):
        if self._session.active:
            self._session.on_released(self._qual, id(self))
        return self._inner.__exit__(*exc)

    def __getattr__(self, name):
        # Condition.wait/notify/wait_for and Lock.locked pass through; wait
        # releases and reacquires the *underlying* primitive, which is fine
        # — the thread is blocked, so its held-set cannot mis-order anything
        return getattr(self._inner, name)


def wrap(lock, qual: str, session: Session) -> WitnessLock:
    """Wrap one lock instance — the unit-test entry point."""
    return WitnessLock(lock, qual, session)


_PATCHED: List[Tuple[type, str, object]] = []
_CURRENT: Optional[Session] = None
_INSTALL_MU = threading.Lock()


def _wrapping_init(cls: type, method: str, attrs: Dict[str, str],
                   session: Session):
    orig = getattr(cls, method)

    def patched(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        if not session.active:
            return
        for attr, qual in attrs.items():
            cur = getattr(self, attr, None)
            if cur is not None and not isinstance(cur, WitnessLock):
                setattr(self, attr, WitnessLock(cur, qual, session))
    patched.__wrapped__ = orig
    return patched


def install() -> Session:
    """Patch the serving constructors so new objects get witness locks."""
    global _CURRENT
    with _INSTALL_MU:
        if _CURRENT is not None and _CURRENT.active:
            raise RuntimeError("lock witness already installed")
        session = Session()
        import importlib
        for mod_name, cls_name, method, attrs in _WRAP_SPECS:
            mod = importlib.import_module(mod_name)
            cls = getattr(mod, cls_name)
            _PATCHED.append((cls, method, cls.__dict__.get(method)))
            setattr(cls, method,
                    _wrapping_init(cls, method, attrs, session))
        _CURRENT = session
        return session


def uninstall(session: Session) -> None:
    """Restore the constructors and stop the session recording."""
    global _CURRENT
    with _INSTALL_MU:
        session.active = False
        while _PATCHED:
            cls, method, orig = _PATCHED.pop()
            if orig is None:
                delattr(cls, method)
            else:
                setattr(cls, method, orig)
        if _CURRENT is session:
            _CURRENT = None
