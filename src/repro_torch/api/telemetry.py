"""Typed telemetry stream (port of the synchronous part of
``repro.api.telemetry``): one :class:`RoundEvent` per round, consumed by
sinks (anything with ``emit(event)``)."""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterable, Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One server-visible model update in the synchronous protocol."""

    round: int
    acc: float
    loss: float
    co2_g: float
    cum_co2_g: float
    duration_s: float
    reward: float
    eps_spent: float
    selected: tuple[int, ...]
    wire_bytes: float = 0.0
    sim_time_s: float = 0.0

    def history_row(self) -> dict:
        return {
            "round": self.round, "acc": self.acc, "co2_g": self.co2_g,
            "cum_co2_g": self.cum_co2_g, "duration_s": self.duration_s,
            "reward": self.reward, "loss": self.loss,
            "eps_spent": self.eps_spent, "selected": list(self.selected),
            "wire_bytes": self.wire_bytes, "sim_time_s": self.sim_time_s,
        }


@runtime_checkable
class TelemetrySink(Protocol):
    def emit(self, event: RoundEvent) -> None: ...


SYNC_HISTORY_KEYS = (
    "round", "acc", "co2_g", "cum_co2_g", "duration_s",
    "reward", "loss", "eps_spent", "selected",
)


class HistoryRecorder:
    """Rebuilds the reference's history dict from the event stream; the
    schema is fixed by ``keys`` (a missing column is filled with None)."""

    def __init__(self, keys: Iterable[str] = SYNC_HISTORY_KEYS):
        self.history: dict = {k: [] for k in keys}

    def emit(self, event: RoundEvent) -> None:
        row = event.history_row()
        for k in self.history:
            self.history[k].append(row.get(k))


class ConsoleSink:
    """Prints one line per event (every ``every``-th event)."""

    def __init__(self, every: int = 1, stream=None):
        self.every = max(1, every)
        self.stream = stream or sys.stdout
        self._n = 0

    def emit(self, event: RoundEvent) -> None:
        self._n += 1
        if (self._n - 1) % self.every:
            return
        print(
            f"round {event.round:3d}  acc={event.acc:.3f}  "
            f"CO2={event.co2_g:.0f} g  loss={event.loss:.3f}",
            file=self.stream, flush=True,
        )


class CallbackSink:
    """Adapts a ``progress(dict)`` callback to the event stream."""

    LEGACY_FIELDS = ("round", "acc", "co2_g", "loss")

    def __init__(self, fn: Callable[[dict], None], fields: tuple[str, ...] = LEGACY_FIELDS):
        self.fn = fn
        self.fields = fields

    def emit(self, event: RoundEvent) -> None:
        row = event.history_row()
        self.fn({k: row[k] for k in self.fields})
