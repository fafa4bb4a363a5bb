"""Layers of the port (counterparts of ``repro.nn``)."""
