"""Optimizer and gradient compression of the training path: ``adamw``
(AdamW, clipping, schedules) and ``grad_compress`` (the Tucker gradient
compressor), ports of ``repro/optim``."""
