"""The benchmark of the PyTorch/CUDA port (`dimsum_torch`): see
README.md."""
