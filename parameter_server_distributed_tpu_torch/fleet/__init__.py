"""The decode fleet of the PyTorch/CUDA port: the port of
parameter_server_distributed_tpu/fleet/.

Decode servers (:mod:`.decode`) register with the coordinator over its
``UpdateFleet`` method and send load heartbeats; a front-door router
(:mod:`.router`, ``cli/route_main.py``) admits each token stream to the
best ACTIVE server by free slots, queue depth and cached-prefix overlap
and pins it there for its lifetime; a controller (:mod:`.controller`)
scales the fleet under slot-occupancy watermarks (scale-in drains
before it stops) and rolls weight versions across it one server at a
time.  The messages (:mod:`.messages`) encode byte for byte as the JAX
package's, so either package's servers, router and coordinator work
with the other's.
"""

from . import messages  # noqa: F401
