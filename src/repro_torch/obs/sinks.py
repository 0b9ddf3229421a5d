"""Durable event log: the typed telemetry stream as crash-safe JSONL (port of
``repro.obs.sinks``).

:class:`JsonlSink` is a telemetry sink that appends one JSON object per
event, tagged with the event's type, and flushes every line as it is
written, so a crashed run keeps every completed event; :func:`read_events`
parses the log back into typed events and drops only a torn final line.
A checkpoint records the sink's byte offset (:meth:`JsonlSink.tell`); a
resume opens the log in append mode and cuts it back to that offset
(:meth:`JsonlSink.truncate_to`) before the re-run rounds append.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, TextIO

from repro_torch.api.telemetry import FlushEvent, MixEvent, RoundEvent

#: the event types a log line may carry, keyed by their tag
EVENT_TYPES: dict[str, type] = {
    "RoundEvent": RoundEvent,
    "FlushEvent": FlushEvent,
    "MixEvent": MixEvent,
}


class JsonlSink:
    """Streams the events to ``path``, one JSON line each; ``append=True``
    opens the log for appending (the resume mode) instead of truncating."""

    def __init__(self, path: str, *, fsync: bool = False, append: bool = False):
        self.path = path
        self.fsync = fsync
        self.append = append
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f: Optional[TextIO] = open(path, "a" if append else "w")
        if append:
            self._f.seek(0, os.SEEK_END)

    def _open(self) -> TextIO:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        return self._f

    def tell(self) -> int:
        """Current end-of-log byte offset."""
        f = self._open()
        f.flush()
        return f.tell()

    def truncate_to(self, offset: int) -> None:
        """Cut the log back to ``offset`` bytes (resume from a checkpoint)."""
        f = self._open()
        f.flush()
        size = os.path.getsize(self.path)
        if offset > size:
            raise ValueError(f"cannot truncate {self.path!r} to {offset}: file is shorter "
                             f"({size} bytes); wrong log for this checkpoint?")
        f.truncate(offset)
        f.seek(offset)

    def emit(self, event: RoundEvent) -> None:
        f = self._open()
        row = {"event": type(event).__name__, **dataclasses.asdict(event)}
        row["selected"] = list(event.selected)
        f.write(json.dumps(row) + "\n")
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> list[RoundEvent]:
    """Parse a :class:`JsonlSink` log back into typed events.  An unknown
    tag raises; a torn final line is dropped, earlier corruption raises."""
    events: list[RoundEvent] = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise
        tag = row.pop("event", None)
        cls = EVENT_TYPES.get(tag)
        if cls is None:
            raise ValueError(f"{path}:{i + 1}: unknown event type {tag!r}")
        row["selected"] = tuple(row["selected"])
        events.append(cls(**row))
    return events
