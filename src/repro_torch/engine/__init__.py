"""``repro_torch.engine``: the simulated clock and the event queue of the
continuous-time engine (port of ``repro.engine.clock`` and
``repro.engine.events``), which the async strategy drives."""
from repro_torch.engine.clock import SimClock
from repro_torch.engine.events import EventQueue

__all__ = ["SimClock", "EventQueue"]
