"""Roofline accounting of the port: the work counter (``cost``) and the
per-cell roofline table over the dry run's artifacts (``analysis``)."""
