"""Local-only lifelong baselines of the port (paper Table II)."""
from repro_torch.lifelong.strategies import EWC, ICaRL, MAS, STL

__all__ = ["EWC", "ICaRL", "MAS", "STL"]
