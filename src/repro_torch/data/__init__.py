"""Deterministic, resumable training data (the port of ``repro/data``)."""
