"""Socket-compatibility layer: the reference's process-per-node protocol.

The port's own copy of ``tpu_gossip/compat/``: seed registry bootstrap
from ``config.txt``, quorum registration, rendezvous turn-taking, push
gossip, heartbeat/PING liveness and dead-node purge over asyncio, with the
reference's wire formats (``wire``), so the port's nodes and the JAX
package's speak to each other. The serving frontend (``serve/``) frames
and parses with ``wire`` too.

``transport="socket"`` runs real TCP nodes; ``transport="tpu-sim"`` backs
the same PeerNode API with a :class:`~tpu_gossip_torch.compat.simnet.SimCluster`,
the whole swarm as batched rounds on the card. This package does not
import ``simnet``, so the socket path never needs a tensor.
"""

from tpu_gossip_torch.compat.timing import ProtocolTiming
from tpu_gossip_torch.compat.peer import PeerNode
from tpu_gossip_torch.compat.seed import SeedNode

__all__ = ["PeerNode", "SeedNode", "ProtocolTiming"]
