"""Timing simulator of the port (copies of ``repro.sim``): the discrete-event
core and the cluster model behind the paper's speedup figures."""
