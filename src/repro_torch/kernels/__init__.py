"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions (``ref``), and the device dispatch (``ops``)."""
