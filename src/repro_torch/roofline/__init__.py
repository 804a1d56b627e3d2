"""Roofline of the port: per-device counts of a program (``op_walk``) and
the three-term roofline from them (``analysis``)."""
