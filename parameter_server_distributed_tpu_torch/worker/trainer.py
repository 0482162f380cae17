"""Worker-local gradient computation: the port of ``Trainer`` and
``GradientBuckets`` from parameter_server_distributed_tpu/worker/trainer.py.

The parameter store crosses the host/device boundary as one flat f32
buffer each way per step, whatever the tensor count: one packed upload
(or, when the params are already card tensors, as ``PallasOptimizer``
returns them, one pack on the card), an unpack into ``config.dtype``
leaves that require grad, autograd of ``model.loss``, and one packed f32
output with the loss at offset 0.  Gradients are taken with respect to
the ``config.dtype`` leaves and then cast to f32, as the JAX step does
(a bf16 ResNet-50's or ViT-S/16's gradients are bf16 tensors widened to
f32 for the wire).  The model is a transformer LM (token batches) or a
classifier, an MLP, a ResNet or a ViT (``(x, y)`` batches, NHWC images
for the last two); the step hands ``model.loss`` the batch as it came,
on the device.

``compute_gradients`` downloads that output whole; the wire round's
``compute_gradient_buckets`` leaves it on the card and hands back a
:class:`GradientBuckets`, which downloads it bucket by bucket into a
pinned host buffer on a side stream while the worker encodes and sends
the buckets before.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device, same_device

# where each unported capability is planned
ROADMAP_MESH = "ROADMAP.md Queue 1, item 8 (multi-device SPMD)"


class GradientBuckets:
    """Lazily fetched packed gradients: the download leg of the pipelined
    data plane.

    Iterating yields ``(name, f32 array)`` per tensor, fetching the flat
    step output host-side in bucket-sized slices on demand: the plan
    groups consecutive tensors of the fixed layout greedily into slices
    of about ``bucket_bytes`` (a tensor larger than the budget rides
    alone, the rule of rpc/data_plane.split_tensors), and the loss rides
    bucket 0 at offset 0.  Reading :attr:`loss` fetches bucket 0.
    Fetched buckets are cached, so iterating again (the unary fallback
    replays the tensors) costs no second copy.  ``on_fetch(bucket_index,
    n_buckets)`` fires on each real device fetch.

    On the card each bucket is one ``non_blocking`` copy into a pinned
    host buffer, queued on a side copy stream behind an event recorded
    after the step; reaching bucket N queues bucket N+1's copy, so it
    runs while bucket N is encoded and sent, and each read waits on its
    own bucket's event only.  The pinned buffer belongs to the trainer
    and the next step reuses it: reading buckets of an older step
    raises.  ``dtoh_ms`` sums the copies' device time and ``wait_s`` the
    host time spent waiting for them.  On the CPU the buckets are views
    of the step's output."""

    def __init__(self, layout, device_flat: torch.Tensor, bucket_bytes: int,
                 on_fetch: Callable[[int, int], None] | None = None,
                 host: torch.Tensor | None = None, ready=None,
                 copy_stream=None, owner=None):
        self._device = device_flat
        self.on_fetch = on_fetch
        plan: list[tuple[int, int, list]] = []
        group: list = []
        start = 0
        for entry in layout:
            _name, off, size, _shape, _dtype = entry
            end = 1 + off + size
            if group and bucket_bytes > 0 and \
                    4 * (end - start) > bucket_bytes:
                plan.append((start, 1 + off, group))
                group, start = [], 1 + off
            group.append(entry)
        if group or not plan:
            end = (1 + group[-1][1] + group[-1][2]) if group else 1
            plan.append((start, end, group))
        self._plan = plan
        self._host: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self._cuda = device_flat.is_cuda
        if self._cuda:
            self._pinned = host
            self._pinned_np = host.numpy()
            self._ready = ready
            self._stream = copy_stream
            self._owner, self._generation = owner, owner._generation
            self._events: list = [None] * len(plan)
        self.wait_s = 0.0

    @property
    def plan(self) -> list[tuple[int, int, list[str]]]:
        """(start, end, tensor names) per bucket, in flat-output offsets."""
        return [(a, b, [e[0] for e in entries])
                for a, b, entries in self._plan]

    @property
    def num_buckets(self) -> int:
        return len(self._plan)

    @property
    def loss(self) -> float:
        return float(self._fetch(0)[0])

    @property
    def dtoh_ms(self) -> float:
        """Device time of the bucket copies queued so far; blocks until
        they have finished."""
        if not self._cuda:
            return 0.0
        queued = [e for e in self._events if e is not None]
        for _start, end in queued:
            end.synchronize()
        return sum(start.elapsed_time(end) for start, end in queued)

    def _start(self, i: int) -> None:
        """Queue bucket i's copy on the copy stream (caller holds the
        lock)."""
        if self._events[i] is not None:
            return
        a, b, _ = self._plan[i]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._ready)
            start.record(self._stream)
            self._pinned[a:b].copy_(self._device[a:b], non_blocking=True)
            end.record(self._stream)
        self._events[i] = (start, end)

    def _fetch(self, i: int) -> np.ndarray:
        if self._cuda and self._owner._generation != self._generation:
            raise RuntimeError("these gradient buckets belong to an older "
                               "step: a newer step reused their host buffer")
        with self._lock:
            buf = self._host.get(i)
            if buf is None:
                if self.on_fetch is not None:
                    self.on_fetch(i, len(self._plan))
                a, b, _ = self._plan[i]
                if self._cuda:
                    self._start(i)
                    t0 = time.perf_counter()
                    self._events[i][1].synchronize()
                    self.wait_s += time.perf_counter() - t0
                    buf = self._pinned_np[a:b]
                else:
                    buf = self._device[a:b].numpy()
                self._host[i] = buf
        return buf

    def _prefetch(self, i: int) -> None:
        """Queue bucket i's copy without waiting, so it runs under the
        previous bucket's encode and transport."""
        if not self._cuda or i >= len(self._plan):
            return
        with self._lock:
            if i not in self._host:
                self._start(i)

    def __iter__(self) -> Iterator[tuple[str, np.ndarray]]:
        for i, (start, _end, entries) in enumerate(self._plan):
            self._prefetch(i + 1)
            buf = self._fetch(i)
            for name, off, size, shape, _dtype in entries:
                a = 1 + off - start
                yield name, buf[a:a + size].reshape(shape)


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
        # the bucketed download's pinned host buffer and copy stream,
        # made on first use and reused by every step; _generation counts
        # the steps that reused them
        self._pinned: torch.Tensor | None = None
        self._copy_stream = None
        self._generation = 0

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

    def _on_device(self, batch):
        """The batch on the device: a token tensor, or a tuple such as an
        MLP's ``(x, y)``, each part a tensor or a numpy array."""
        if isinstance(batch, (tuple, list)):
            return tuple(self._on_device(part) for part in batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        return torch.from_numpy(np.asarray(batch)).to(self.device)

    def _step(self, params: Mapping, batch) -> torch.Tensor:
        """One gradient step: the flat f32 output (loss at offset 0, then
        the gradients in layout order) on the device."""
        flat = self._pack(params)
        leaves = {name: flat[off:off + size].view(shape).to(dtype)
                  .detach().requires_grad_(True)
                  for name, off, size, shape, dtype in self._layout}
        with torch.enable_grad():
            loss = self.model.loss(leaves, self._on_device(batch))
            names = [name for name, *_ in self._layout]
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
        return torch.cat([loss.detach().reshape(1).float()] + [
            (g if g is not None else torch.zeros_like(leaves[n]))
            .float().reshape(-1) for n, g in zip(names, grads)])

    def compute_gradients(self, params: Mapping,
                          batch) -> tuple[dict[str, np.ndarray], float]:
        """params (host numpy store or card tensors) + batch ->
        (host f32 gradient store, loss).  One upload or on-card pack, one
        download, regardless of tensor count."""
        host = self._step(params, batch).cpu().numpy()
        store = {name: host[1 + off:1 + off + size].reshape(shape)
                 for name, off, size, shape, _dtype in self._layout}
        return store, float(host[0])

    def compute_gradient_buckets(self, params: Mapping, batch,
                                 bucket_bytes: int | None = None,
                                 on_fetch=None) -> GradientBuckets:
        """The bucketed-download variant of :meth:`compute_gradients`: the
        same step, its output left on the device and fetched in
        ~``bucket_bytes`` slices as the returned :class:`GradientBuckets`
        is iterated (default budget: rpc/data_plane.bucket_bytes())."""
        if bucket_bytes is None:
            from ..rpc.data_plane import bucket_bytes as _bucket_bytes
            bucket_bytes = _bucket_bytes()
        out = self._step(params, batch)
        if not out.is_cuda:
            return GradientBuckets(self._layout, out, bucket_bytes,
                                   on_fetch=on_fetch)
        if self._pinned is None or self._pinned.numel() < out.numel():
            self._pinned = torch.empty(out.numel(), dtype=torch.float32,
                                       pin_memory=True)
            self._copy_stream = torch.cuda.Stream(out.device)
        self._generation += 1
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(out.device))
        # the copies read ``out`` on the copy stream: keep its memory from
        # being reused before they are done
        out.record_stream(self._copy_stream)
        return GradientBuckets(self._layout, out, bucket_bytes,
                               on_fetch=on_fetch, host=self._pinned,
                               ready=ready, copy_stream=self._copy_stream,
                               owner=self)
