"""Configuration dataclasses (copy of ``repro/common``)."""
