"""Discrete-event queue (port of ``repro.engine.events``).

A min-heap of ``(t_s, seq, payload)``: pops are time-ordered, and among
equal times insertion order wins (``seq`` is a monotone int), so ties are
deterministic and FIFO, which the bitwise kill/resume check depends on.
Payloads are never compared.

``state_dict(pack)`` serializes the heap in its internal list order and
``load_state_dict(s, unpack)`` restores it verbatim; a valid heap restored
element for element pops in the same sequence.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, Optional


def _identity(x: Any) -> Any:
    return x


class EventQueue:
    """Min-heap of ``(t_s, seq, payload)`` with FIFO tie-breaking."""

    def __init__(self):
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = 0

    def push(self, t_s: float, payload: Any) -> int:
        """Schedule ``payload`` at absolute simulated time ``t_s``; returns
        the entry's sequence number."""
        seq = self._seq
        heapq.heappush(self._heap, (float(t_s), seq, payload))
        self._seq += 1
        return seq

    def pop(self) -> tuple[float, int, Any]:
        """Remove and return the earliest ``(t_s, seq, payload)``."""
        return heapq.heappop(self._heap)

    def peek_time(self) -> Optional[float]:
        """Earliest scheduled time, or None when empty."""
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self):
        """Entries in internal heap order (not pop order)."""
        return iter(self._heap)

    def state_dict(self, pack: Callable[[Any], Any] = _identity) -> dict:
        """The heap in internal list order; ``pack`` maps each payload to a
        checkpoint-safe container."""
        return {"seq": self._seq,
                "heap": [{"t": t, "seq": sq, "payload": pack(p)} for t, sq, p in self._heap]}

    def load_state_dict(self, s: dict, unpack: Callable[[Any], Any] = _identity) -> None:
        """Restore verbatim, so the event replay stays bitwise."""
        self._seq = int(s["seq"])
        self._heap = [(float(d["t"]), int(d["seq"]), unpack(d["payload"])) for d in s["heap"]]
