"""Simulated wall clock (port of ``repro.engine.clock``).

One ``SimClock`` is the run's single source of simulated time: the async
strategy advances it to each completion event it pops.  Time only moves
forward; an attempt to rewind is a scheduling fault and raises.  Its
``state_dict`` rides the checkpoint, so a resume restores the exact instant.
"""
from __future__ import annotations


class SimClock:
    """Monotone simulated time in seconds (continuous, event-driven)."""

    def __init__(self, now_s: float = 0.0):
        self.now_s = float(now_s)

    @property
    def hours(self) -> float:
        """Simulated time in hours (the carbon model's phase unit)."""
        return self.now_s / 3600.0

    def advance_to(self, t_s: float) -> float:
        """Jump to absolute time ``t_s`` (must not be in the past)."""
        t_s = float(t_s)
        if t_s < self.now_s:
            raise ValueError(f"simulated time cannot rewind: now={self.now_s!r}, "
                             f"advance_to({t_s!r})")
        self.now_s = t_s
        return self.now_s

    def advance(self, dt_s: float) -> float:
        """Advance by a duration ``dt_s >= 0``."""
        dt_s = float(dt_s)
        if dt_s < 0.0:
            raise ValueError(f"negative duration: {dt_s!r}")
        self.now_s += dt_s
        return self.now_s

    def state_dict(self) -> dict:
        return {"now_s": self.now_s}

    def load_state_dict(self, s: dict) -> None:
        self.now_s = float(s["now_s"])
