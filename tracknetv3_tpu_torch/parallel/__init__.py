"""Data parallelism over a 1-D device mesh (``mesh.py``)."""
