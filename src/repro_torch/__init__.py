"""PyTorch/CUDA port of the FedSTIL system (the JAX package ``repro`` is the
reference it is checked against).

Parity with the reference needs full IEEE fp32 in every float32 matrix
product and convolution: TF32 keeps about three decimal digits, and
near-ties in the retrieval ranking depend on the rest. PyTorch already
defaults matmuls to fp32 but runs cuDNN convolutions in TF32, so the port
sets both switches here, once, when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
