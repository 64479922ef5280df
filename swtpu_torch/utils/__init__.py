"""Integrity guards of the port's scoring path (``guards``), its event
log, GCUPS meter and profiler hook (``metrics``) and the card's device
timers (``timing``)."""

from swtpu_torch.utils.metrics import BatchEvent, EventLog, GcupsMeter, profile_trace

__all__ = ["BatchEvent", "EventLog", "GcupsMeter", "profile_trace"]
