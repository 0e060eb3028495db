"""Data parallelism over local devices: the port of ``vcfc_tpu/parallel``'s
``mesh`` and ``shard`` modules (the ``.vcfc`` steps) and of the ``.vcfc``
legs of its multichip dry run (``dryrun``)."""
