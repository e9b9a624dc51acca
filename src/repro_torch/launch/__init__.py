"""Meshes of devices for serving and for tests (``launch/mesh.py``) and
the training launcher (``launch/train.py``)."""
