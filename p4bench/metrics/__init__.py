"""Per-layer metrics: ``<metric>.py`` holds ``read(ev)``, which returns the
metric's reading from the traced run's evidence (see
``harness.Run.evidence``), or None where there is nothing to read."""
