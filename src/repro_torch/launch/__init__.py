"""Training and serving entry points (counterparts of ``repro/launch``)."""
