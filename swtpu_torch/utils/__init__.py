"""Integrity guards of the port's scoring path (``guards``), its event
log (``metrics``) and the card's device timers (``timing``)."""
