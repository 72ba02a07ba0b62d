"""Online GNN and recsys inference: reorder-aware embedding cache + dynamic
micro-batching + oracle-checked request path, with the per-layer forward
(or the recsys tower) and the offline oracle forward on the device."""
from .cache import EmbeddingCache, CacheStats
from .batcher import (Request, MicroBatch, MicroBatcher, pow2_bucket,
                      zipfian_trace)
from .engine import ServeEngine, ServeReport, RequestRecord, ServeSLO
from .registry import (GNNSession, SESSION_BUILDERS, WideDeepSession,
                       make_session)
