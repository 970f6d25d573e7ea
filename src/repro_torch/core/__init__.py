"""Core of the port: packet format, layout, hot index, switch engine."""
