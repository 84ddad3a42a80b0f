"""npz checkpoints of parameter trees, in the JAX package's format."""
from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
