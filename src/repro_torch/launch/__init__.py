"""Meshes of devices for serving and for tests (``launch/mesh.py``)."""
