"""Training helpers of the port: the stacked optimizer and the lifelong metrics."""
