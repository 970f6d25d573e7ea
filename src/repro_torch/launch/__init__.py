"""Serving entry points (counterparts of ``repro/launch``)."""
