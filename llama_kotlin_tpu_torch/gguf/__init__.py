"""gguf of the PyTorch/CUDA port: the GGUF container's reader (memory
mapped, tensors handed to torch without a copy) and writer."""
