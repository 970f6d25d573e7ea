"""Model configurations (copies of ``repro/configs``): ``registry.get`` /
``get_smoke`` resolve the same names and aliases."""
