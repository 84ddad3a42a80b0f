"""Local-only lifelong baselines of the port."""
from repro_torch.lifelong.strategies import STL

__all__ = ["STL"]
