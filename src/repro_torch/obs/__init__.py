"""``repro_torch.obs``: the durable event log (port of ``repro.obs.sinks``)."""
from repro_torch.obs.sinks import EVENT_TYPES, JsonlSink, read_events

__all__ = ["EVENT_TYPES", "JsonlSink", "read_events"]
