"""Online ReID retrieval serving on the card: the int8 / fp32 / IVF resident
gallery index, the retrieval engine and the continuous batcher."""
from repro_torch.serving.batcher import (ContinuousBatcher, Ticket,
                                         run_closed_loop, run_open_loop)
from repro_torch.serving.engine import (RetrievalEngine, map_from_ranked_ids,
                                        query_host, query_ivf, query_ivf_host,
                                        recall_at_k)
from repro_torch.serving.index import (GalleryIndex, index_refresh,
                                       index_refresh_ivf, ivf_refresh_host)

__all__ = [
    "ContinuousBatcher", "Ticket", "run_closed_loop", "run_open_loop",
    "RetrievalEngine", "map_from_ranked_ids", "query_host", "query_ivf",
    "query_ivf_host", "recall_at_k", "GalleryIndex", "index_refresh",
    "index_refresh_ivf", "ivf_refresh_host",
]
