"""Coordinate queries: the port's copy of ``vcfc_tpu/query/coordinate.py``."""
