"""Host utilities: the port's copy of ``vcfc_tpu/utils/refmap.py``."""
