"""serve substrate of the port: LM continuous batching + streaming Tucker
serving.

``TuckerService`` is the streaming front door (async submit/poll, shape
buckets, backpressure, per-bucket metrics) on an explicit device;
``TuckerBatchEngine`` is its synchronous one-shot wrapper; ``ServeEngine``
serves the repo's LMs.
"""

from .buckets import BucketPolicy, pad_block, pad_waste, slice_valid, trim_result
from .engine import Request, ServeEngine, TuckerBatchEngine, TuckerRequest
from .metrics import BucketMetrics, LatencyWindow, TraceWriter
from .service import RejectedError, ServiceClosed, Ticket, TuckerService

__all__ = [
    "BucketMetrics", "BucketPolicy", "LatencyWindow", "RejectedError",
    "Request", "ServeEngine", "ServiceClosed", "Ticket", "TraceWriter",
    "TuckerBatchEngine", "TuckerRequest", "TuckerService",
    "pad_block", "pad_waste", "slice_valid", "trim_result",
]
