"""Logical-axis sharding rules of the port (``axes.py``)."""
