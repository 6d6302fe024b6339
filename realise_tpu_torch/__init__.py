"""realise-tpu-torch: the PyTorch/CUDA port of realise-tpu for NVIDIA Hopper.

A package beside ``realise_tpu`` (the JAX reference) that keeps its module
layout and names. Plain tensor code is PyTorch; the fused BERT-block kernels
that the JAX package wrote in Pallas are CUDA C++ kernels for sm_90a
(``csrc/``), built at first CUDA use and bound with ``ctypes``. Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
