"""The .vcfc and .vcfz byte formats: the port's copy of ``vcfc_tpu/format``'s
``constants``, ``headers``, ``lines``, ``vcf`` and ``vcfz``, and the port of
its ``vcfz_device``."""
