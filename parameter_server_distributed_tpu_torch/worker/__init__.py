"""worker of the PyTorch/CUDA port."""
