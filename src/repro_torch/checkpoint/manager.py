"""Checkpoint policy and non-blocking manager for ``Federation.run`` (port
of ``repro.checkpoint.manager``).

The strategy builds its ``state_dict``; :func:`~repro_torch.checkpoint.state.snapshot`
copies it to the host on the round loop, and a daemon writer thread
serializes and publishes the step directory atomically while the next round
trains.  ``wait()`` drains the queue and re-raises any background failure.

Layout, one directory per retained step::

    <dir>/round_00000003/manifest.json   # skeleton + metadata
    <dir>/round_00000003/arrays.npz      # tensor payload

``CheckpointPolicy`` sets the cadence (``every_k_rounds``) and retention
(``keep_last_n``; 0 keeps everything).  ``load_checkpoint`` picks the newest
loadable step, so a run that died mid-publish resumes from the step before.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Optional

from repro_torch.checkpoint import state as state_mod

STEP_RE = re.compile(r"^round_(\d{8})$")


def resume_key(cfg) -> str:
    """Configuration fingerprint a resume must match: everything but
    ``training.rounds`` (extending a run is the point of resuming), the
    ``checkpoint`` block and the engine's trace path."""
    d = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    d = json.loads(json.dumps(d, default=str))  # deep, JSON-safe copy
    d.get("training", {}).pop("rounds", None)
    d.pop("checkpoint", None)
    d.get("engine", {}).pop("trace", None)
    blob = json.dumps(d, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """When to checkpoint and how many steps to retain."""

    every_k_rounds: int = 1
    keep_last_n: int = 0   # 0 = keep everything

    def __post_init__(self):
        if self.every_k_rounds < 1:
            raise ValueError("every_k_rounds must be >= 1")
        if self.keep_last_n < 0:
            raise ValueError("keep_last_n must be >= 0")

    def should_save(self, rnd: int) -> bool:
        """True when completed round ``rnd`` (0-based) ends a k-block."""
        return (rnd + 1) % self.every_k_rounds == 0


class CheckpointManager:
    """Writes retained, atomic federation-state checkpoints for one run.

    ``background=True`` (the default) publishes from a daemon writer thread;
    the round loop pays for the host snapshot only.  A failed write surfaces
    on the next ``on_round`` or ``wait``.
    """

    def __init__(self, directory: str, policy: Optional[CheckpointPolicy] = None, *,
                 background: bool = True):
        self.directory = str(directory)
        self.policy = policy if policy is not None else CheckpointPolicy()
        self.background = background
        #: callable returning extra state folded into every checkpoint (the
        #: event logs' byte offsets); set by ``Federation.run``
        self.telemetry_probe: Optional[Callable[[], dict]] = None
        self.saved_rounds: list[int] = []
        os.makedirs(self.directory, exist_ok=True)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def step_dir(self, rnd: int) -> str:
        return os.path.join(self.directory, f"round_{rnd:08d}")

    def on_round(self, strategy, ctx, rnd: int) -> None:
        """Per-round hook: save if the policy says so.  Strategies call it
        after the round's event is emitted, so a checkpoint at round r
        implies history rows 0..r reached every sink."""
        self._raise_pending()
        if self.policy.should_save(rnd):
            self.save(strategy, ctx, rnd)

    def save(self, strategy, ctx, rnd: int) -> str:
        """Snapshot the federation state after round ``rnd`` and publish it
        (in the background unless ``background=False``)."""
        fedstate = {"strategy": strategy.name, "round": int(rnd),
                    "state": strategy.state_dict(ctx)}
        if self.telemetry_probe is not None:
            fedstate["telemetry"] = self.telemetry_probe()
        metadata = {"round": int(rnd), "strategy": strategy.name,
                    "resume_key": resume_key(ctx.cfg)}
        snap = state_mod.snapshot(fedstate)  # host copies, decoupled from the run
        if self.background:
            self._ensure_worker()
            self._queue.put((snap, metadata, rnd))
        else:
            self._write(snap, metadata, rnd)
        self.saved_rounds.append(int(rnd))
        return self.step_dir(rnd)

    def wait(self) -> None:
        """Block until every queued write is published; re-raise failures."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def _ensure_worker(self) -> None:
        if self._worker is None:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._loop, name="ckpt-writer", daemon=True)
            self._worker.start()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                self._write(*item)
            except BaseException as e:  # kept and re-raised on the round loop
                with self._lock:
                    self._error = e
            finally:
                self._queue.task_done()

    def _write(self, snap, metadata: dict, rnd: int) -> None:
        state_mod.write_snapshot(self.step_dir(rnd), snap, metadata=metadata)
        self._retain()

    def _retain(self) -> None:
        n = self.policy.keep_last_n
        if n <= 0:
            return
        for _, path in list_steps(self.directory)[:-n]:
            shutil.rmtree(path, ignore_errors=True)

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err


def list_steps(directory: str) -> list[tuple[int, str]]:
    """Complete step directories under ``directory`` as sorted (round, path)."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    steps = []
    for name in entries:
        m = STEP_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.exists(os.path.join(path, state_mod.MANIFEST)):
            steps.append((int(m.group(1)), path))
    return sorted(steps)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest retained step directory, or None."""
    steps = list_steps(directory)
    return steps[-1][1] if steps else None


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Load ``(fedstate, metadata)`` from a step directory, or from a
    manager directory, newest loadable step first: a run killed mid-publish
    may leave its newest step torn, and the resume lands on the one before."""
    if os.path.exists(os.path.join(path, state_mod.MANIFEST)):
        return state_mod.load_state(path)
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path!r}")
    last_err: Optional[Exception] = None
    for _, step in reversed(steps):
        try:
            return state_mod.load_state(step)
        except ValueError as e:
            last_err = e
    raise ValueError(f"no loadable checkpoint under {path!r} "
                     f"({len(steps)} step dir(s), all corrupt)") from last_err
