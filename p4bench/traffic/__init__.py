"""Traffic: one generator module per benchmark family and one data file
per mix (``<mix>.json``) that names its generator and parameters."""
