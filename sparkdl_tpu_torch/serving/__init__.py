"""Online serving tier of the port — the continuous-batching generation
engine, the counterpart of ``sparkdl_tpu/serving``.

``engine`` imports no torch (the scheduler, queue, slot table and
request state machine are plain Python, copied from the JAX package);
the torch half lives in ``backend`` and is imported lazily by
:meth:`GenerationEngine.from_model`. The fleet router
(``serving/router.py`` of the JAX package) is not ported yet
(ROADMAP.md).
"""

from .draft import (DraftModelProvider, HistoryDraft, NGramDraft,
                    make_provider)
from .engine import (ENGINE_SCOPED_EVENTS, PREFILLING,
                     REQUEST_SCOPED_EVENTS, SNAPSHOT_VERSION,
                     DeadlineExceeded, EngineStopped, GenerationEngine,
                     QueueFullError, Request, RequestCancelled,
                     RequestQuarantined, RequestRejected, ServingError,
                     ServingStallError, SnapshotIncompatibleError,
                     StubBackend, bucket_length)
from .introspect import engine_debug_state, serving_snapshot
from .paging import (BlockAllocator, BlockError, BlockExhausted,
                     PagedBlockManager)
from .prefix import PrefixCache, RadixPrefixCache

__all__ = [
    "GenerationEngine", "Request", "StubBackend", "bucket_length",
    "ServingError", "RequestRejected", "QueueFullError",
    "RequestQuarantined", "ServingStallError", "EngineStopped",
    "RequestCancelled", "DeadlineExceeded", "SnapshotIncompatibleError",
    "SNAPSHOT_VERSION",
    "PREFILLING", "PrefixCache", "RadixPrefixCache", "BlockAllocator",
    "BlockError", "BlockExhausted", "PagedBlockManager", "NGramDraft",
    "HistoryDraft", "DraftModelProvider", "make_provider",
    "REQUEST_SCOPED_EVENTS", "ENGINE_SCOPED_EVENTS",
    "engine_debug_state", "serving_snapshot",
]
