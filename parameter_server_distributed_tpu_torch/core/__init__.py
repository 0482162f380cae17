"""core of the PyTorch/CUDA port."""
