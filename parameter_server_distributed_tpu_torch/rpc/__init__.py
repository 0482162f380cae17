"""rpc of the PyTorch/CUDA port."""
