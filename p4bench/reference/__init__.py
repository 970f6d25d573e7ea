"""The plain reference: a serial executor of the generated op arrays and
the comparison that decides a run's ``correct``.  Imports nothing of the
program (``repro_torch``), of the JAX package or of JAX."""
