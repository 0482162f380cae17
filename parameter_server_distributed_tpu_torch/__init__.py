"""PyTorch/CUDA port of parameter_server_distributed_tpu.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never ``jax`` or the JAX package.  Its entry points run on the
CUDA card unless the caller asks for the CPU (``device="cpu"``).  Slice 1
is the serving path: ``models.transformer``, ``models.generation``,
``models.serving`` and ``cli.serve_main``, with the causal flash-attention
forward as a hand-written Hopper kernel (``csrc/flash_fwd.cu``).  Slice 2
is the training step: ``worker.trainer.Trainer`` (the worker's gradient
step) and ``async_sgd.device_optimizer.PallasOptimizer`` (the PS's device
apply), with the flash backward (``csrc/flash_bwd.cu``) and the fused
optimizer updates (``csrc/fused_update.cu``).
"""
