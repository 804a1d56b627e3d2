"""Training loop and steps (the port of ``repro/train``)."""
