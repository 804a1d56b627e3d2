"""Checkpoints of the training path (the port of ``repro/checkpoint``)."""
from .checkpointer import Checkpointer  # noqa: F401
