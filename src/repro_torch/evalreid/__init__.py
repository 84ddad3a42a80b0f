"""Retrieval evaluation: the numpy oracle and the batched device path."""
from repro_torch.evalreid.batched import (
    batched_retrieval_metrics,
    evaluate_retrieval_batched,
)
from repro_torch.evalreid.retrieval import (
    distance_matrix,
    evaluate_retrieval,
    l2_normalize,
)
