"""Training helpers of the port: the stacked optimizer, the lifelong
metrics and the LM trainer (``train.trainer``)."""
