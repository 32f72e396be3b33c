"""Drivers of the port (counterparts of experiments/*.py)."""
