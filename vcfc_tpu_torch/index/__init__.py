"""The .vcfc line scan: the port's copy of ``vcfc_tpu/index/scan.py``."""
