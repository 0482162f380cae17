"""obs of the PyTorch/CUDA port."""
