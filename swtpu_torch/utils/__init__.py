"""Integrity guards of the port's scoring path (``guards``), its event
log, GCUPS meter and profiler hook (``metrics``) and the card's device
timers (``timing``)."""
