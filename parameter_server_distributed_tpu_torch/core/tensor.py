"""Named-tensor store: the port's copy of ``TensorStore``,
``store_nbytes`` and ``tree_like`` from
parameter_server_distributed_tpu/core/tensor.py, and :func:`to_host`,
which every numpy-only caller (checkpoints, snapshots, optimizer state)
uses to read a store that may hold card tensors.

A store is an ordered ``dict[str, np.ndarray | torch.Tensor]``: host
code (folds, means, host optimizers) works on float32 numpy arrays;
device optimizers return torch tensors on their device, which the PS
core stores and serves as they are.  :func:`to_wire` and
:func:`from_wire` move a store to and from the wire messages of
``rpc/messages.py``; ``to_wire`` reads card tensors through
:func:`to_host`, one packed copy per device.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from ..rpc.messages import TOPK_DEFAULT_DENSITY, Tensor

TensorStore = dict[str, np.ndarray]


def to_wire(store: Mapping, wire_dtype: int = 0,
            topk_density: float = TOPK_DEFAULT_DENSITY) -> list[Tensor]:
    """Store -> wire messages (reference: src/worker.cpp:40-52 to_proto),
    names and order kept.  ``wire_dtype`` selects the payload encoding
    (messages.WIRE_*; the default is the reference's repeated float);
    ``topk_density`` applies to WIRE_TOPK only.  numpy values go as they
    are, as the JAX package's ``to_wire`` sends them; tensors, wherever
    they lie, come to the host through :func:`to_host`."""
    tensors = {k: v for k, v in store.items() if isinstance(v, torch.Tensor)}
    host = to_host(tensors) if tensors else {}
    return [Tensor.from_array(name, host[name] if name in host
                              else np.asarray(value),
                              wire_dtype=wire_dtype,
                              topk_density=topk_density)
            for name, value in store.items()]


def from_wire(tensors: Iterable[Tensor]) -> TensorStore:
    """Wire messages -> host store (reference: src/worker.cpp:54-66
    from_proto)."""
    return {t.name: t.to_array() for t in tensors}


def to_host(store: Mapping) -> TensorStore:
    """The store as float32 numpy arrays, names and order kept.  numpy
    values pass through (converted only where not already f32); tensors
    come back as host copies that share no memory with them (optimizer
    slots keep updating in place): those on the host one by one, those
    off it in one packed copy per device, whatever the tensor count (the
    returned arrays are views into that copy).  An ``ArenaStore``
    (core/arena.py) is read as the views into its host slabs that it
    holds, after its readback's event."""
    wait = getattr(store, "wait", None)
    if callable(wait):
        wait()
    out: TensorStore = {}
    remote: dict[torch.device, list[str]] = {}
    for name, value in store.items():
        if isinstance(value, torch.Tensor):
            value = value.detach()
            if value.device.type != "cpu":
                remote.setdefault(value.device, []).append(name)
                out[name] = None
                continue
            value = value.to(torch.float32, copy=True).numpy()
        out[name] = np.asarray(value, np.float32)
    for names in remote.values():
        flat = torch.cat([store[n].detach().reshape(-1).float()
                          for n in names]).cpu().numpy()
        offset = 0
        for n in names:
            size = store[n].numel()
            out[n] = flat[offset:offset + size].reshape(tuple(store[n].shape))
            offset += size
    return out


def state_to_host(state: Mapping) -> dict:
    """An optimizer state in ``state_dict``'s layout with its tensors
    brought to the host through :func:`to_host`, one packed copy per
    level of nesting; other values pass through."""
    tensors = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    host = to_host(tensors) if tensors else {}
    return {k: host[k] if k in host
            else state_to_host(v) if isinstance(v, Mapping) else v
            for k, v in state.items()}


def tree_like(store: Mapping) -> TensorStore:
    """An owned float32 numpy copy of a store (a core never keeps the
    caller's buffers: a worker may reuse them for its next step)."""
    return {k: np.array(v, np.float32) for k, v in to_host(store).items()}


def store_nbytes(store: Mapping) -> int:
    """Total payload bytes of a store (metadata on arrays and tensors
    alike: nothing is copied)."""
    return sum(int(v.nbytes) for v in store.values())
