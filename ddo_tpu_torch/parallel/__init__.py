"""Frontier parallelism over a mesh of devices (`mesh.py`)."""
