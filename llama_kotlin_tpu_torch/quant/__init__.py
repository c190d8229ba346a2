"""quant of the PyTorch/CUDA port."""
