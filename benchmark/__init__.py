"""The benchmark of the PyTorch and CUDA port (``realise_tpu_torch``): see
README.md beside this file."""
