"""ops/cuda of the PyTorch/CUDA port."""
