"""Versioned delta serving and live weight publication: the port of
parameter_server_distributed_tpu/delta/.

After every optimizer apply the PS diffs the new store against the
previous one in wire space (:mod:`.chain`) and keeps a bounded chain of
version pairs, so a receiver that holds a recent version is served the
changed bytes instead of the whole model.  The same stream is the
train-to-serving publication loop: a decode server subscribes
(:mod:`.subscriber`) and hot-swaps each new version between rounds.

- :mod:`.messages`: the RPC schemas (``PullParametersDelta``,
  ``PushPullDeltaStream``, ``SubscribeWeights``), byte for byte the JAX
  package's, outside ``rpc/messages.py`` as there;
- :mod:`.chain`: ``DeltaChain`` and the wire-space checksum;
- :mod:`.client`: the receiver's frame assembly and in-place apply
  (the worker's data plane and the subscriber share it);
- :mod:`.subscriber`: ``WeightFollower``.
"""

from .chain import DeltaChain, delta_wire_dtype, store_crc  # noqa: F401
from .client import (DeltaBaseMismatch, DeltaPullState,  # noqa: F401
                     apply_frames)
from .messages import DELTA_PS_METHODS, delta_enabled  # noqa: F401
from .subscriber import WeightFollower  # noqa: F401
