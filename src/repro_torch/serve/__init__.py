"""serve substrate of the port: LM continuous batching (``ServeEngine``).
The Tucker serving stack (``TuckerService``, buckets, metrics,
``TuckerBatchEngine``) waits for ``ROADMAP.md`` Queue 1 item 9."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
