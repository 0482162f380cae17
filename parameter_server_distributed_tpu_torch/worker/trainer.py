"""Worker-local gradient computation: the port of ``Trainer`` from
parameter_server_distributed_tpu/worker/trainer.py.

The parameter store crosses the host/device boundary as one flat f32
buffer each way per step, whatever the tensor count: one packed upload
(or, when the params are already card tensors, as ``PallasOptimizer``
returns them, one pack on the card), an unpack into ``config.dtype``
leaves that require grad, autograd of ``model.loss``, and one packed f32
download with the loss at offset 0.  Gradients are taken with respect to
the ``config.dtype`` leaves and then cast to f32, as the JAX step does.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device, same_device

# where each unported capability is planned
ROADMAP_MESH = "ROADMAP.md Queue 1, item 8 (multi-device SPMD)"
ROADMAP_BUCKETS = "ROADMAP.md Queue 1, item 4 (GradientBuckets)"


class Trainer:
    """Gradient computation for one worker process, on ``device``
    (default: the card; raises without one unless ``device="cpu"``).

    The packing layout is fixed at construction from the model's
    ``param_shapes()``, sorted by name: (name, offset, size, shape,
    dtype)."""

    def __init__(self, model, device=None, mesh_config=None, rule_fn=None):
        if mesh_config is not None or rule_fn is not None:
            raise NotImplementedError(
                f"a worker mesh (intra-worker model parallelism): "
                f"{ROADMAP_MESH}")
        self.model = model
        self.device = resolve_device(device)
        dtype = model.config.dtype
        self._layout = []
        offset = 0
        shapes = model.param_shapes()
        for name in sorted(shapes):
            shape = tuple(shapes[name])
            size = math.prod(shape)
            self._layout.append((name, offset, size, shape, dtype))
            offset += size
        self._packed_size = offset

    def init_params(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Deterministic init as a host f32 numpy store (every worker
        derives the same store for PS bootstrap)."""
        params = self.model.init_params(seed, device=self.device)
        return {k: v.float().cpu().numpy() for k, v in params.items()}

    def _pack(self, params: Mapping) -> torch.Tensor:
        """The store as one flat f32 tensor on the device: packed on the
        card when every param already lies there, else packed on the host
        and uploaded once."""
        names = [name for name, *_ in self._layout]
        if all(isinstance(params[n], torch.Tensor)
               and same_device(params[n].device, self.device)
               for n in names):
            return torch.cat([params[n].reshape(-1).float() for n in names])
        flat = np.empty(self._packed_size, np.float32)
        for name, off, size, _shape, _dtype in self._layout:
            value = params[name]
            if isinstance(value, torch.Tensor):
                value = value.detach().float().cpu().numpy()
            flat[off:off + size] = np.asarray(value, np.float32).ravel()
        return torch.from_numpy(flat).to(self.device)

    def _tokens(self, batch) -> torch.Tensor:
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device)
        return torch.from_numpy(np.asarray(tokens)).to(self.device)

    def compute_gradients(self, params: Mapping,
                          batch) -> tuple[dict[str, np.ndarray], float]:
        """params (host numpy store or card tensors) + batch ->
        (host f32 gradient store, loss).  One upload or on-card pack, one
        download, regardless of tensor count."""
        flat = self._pack(params)
        leaves = {name: flat[off:off + size].view(shape).to(dtype)
                  .detach().requires_grad_(True)
                  for name, off, size, shape, dtype in self._layout}
        with torch.enable_grad():
            loss = self.model.loss(leaves, self._tokens(batch))
            names = [name for name, *_ in self._layout]
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
        out = torch.cat([loss.detach().reshape(1).float()] + [
            (g if g is not None else torch.zeros_like(leaves[n]))
            .float().reshape(-1) for n, g in zip(names, grads)])
        host = out.cpu().numpy()
        store = {name: host[1 + off:1 + off + size].reshape(shape)
                 for name, off, size, shape, _dtype in self._layout}
        return store, float(host[0])

    def compute_gradient_buckets(self, params, batch, bucket_bytes=None,
                                 on_fetch=None):
        raise NotImplementedError(f"bucketed gradient download: "
                                  f"{ROADMAP_BUCKETS}")
