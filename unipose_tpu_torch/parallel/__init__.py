"""Parallelism over ranks (one process a card): data (``mesh.py``) and time (``cp.py``)."""
