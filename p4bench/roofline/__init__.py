"""The yardstick of the kernels: the table of peaks (``peaks.json``) and,
per kernel route of the program (``<route>.py``), the bytes that one
dispatch's inputs need."""
