"""The .vcfc byte format: the port's copy of ``vcfc_tpu/format``'s
``.vcfc`` modules (``constants``, ``headers``, ``lines``, ``vcf``)."""
