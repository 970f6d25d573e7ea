"""Functional DBMS of the port: cluster, WAL, faults, conflicts, txns."""
