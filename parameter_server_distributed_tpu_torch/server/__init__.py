"""server of the PyTorch/CUDA port."""
