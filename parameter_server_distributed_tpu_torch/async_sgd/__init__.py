"""async_sgd of the PyTorch/CUDA port."""
