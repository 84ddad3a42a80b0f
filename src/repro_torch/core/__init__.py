"""The edge model's adaptive head and the weight carry from the JAX package."""
