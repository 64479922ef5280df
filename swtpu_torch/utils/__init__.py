"""Integrity guards of the port's scoring path (``guards``)."""
