"""Published peaks of the card the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the card's full power limit).

A card whose name matches no row gets no peak: the shares that need one
are then left out of the result, never guessed.
"""
from __future__ import annotations

from typing import Dict, Optional

# (substring of torch.cuda.get_device_name(), peaks): the card the cells
# run on
PEAKS = (
    ("H100 80GB HBM3", {"bf16_flops": 989e12, "fp32_flops": 67e12,
                        "hbm_bytes": 3.35e12}),
)


def peaks(kind: str) -> Optional[Dict[str, float]]:
    for sub, row in PEAKS:
        if sub in kind:
            return dict(row)
    return None
