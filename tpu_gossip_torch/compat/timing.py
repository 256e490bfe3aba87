"""The reference's wall-clock protocol contract, as one scalable dataclass
(the port's own copy of ``tpu_gossip/compat/timing.py``).

All constants are hard-coded literals in the reference (SURVEY.md §2.5);
here they scale together so integration tests can run the identical state
machine 100× faster (`ProtocolTiming.scaled(0.01)`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProtocolTiming:
    """Defaults reproduce SURVEY.md §2.5 exactly."""

    heartbeat_period: float = 15.0  # peer→peer + seed→seed heartbeat (Peer.py:393, Seed.py:356)
    detect_period: float = 10.0  # failure-detector sweep (Peer.py:363)
    heartbeat_timeout: float = 30.0  # stale threshold (Peer.py:299)
    ping_grace: float = 2.0  # post-PING wait before declaring dead (Peer.py:300)
    gossip_period: float = 5.0  # gossip generation tick (Peer.py:396-408)
    gossip_count: int = 10  # messages generated per peer (Peer.py:396)
    seed_reconnect_period: float = 15.0  # seed-mesh retry sweep (Seed.py:341)
    registration_settle: float = 1.0  # seed-side sleep before subset (Seed.py:282)
    subset_apply_delay: float = 1.0  # peer-side first-subset delay (Peer.py:108)
    connect_timeout: float = 5.0  # all TCP connects (Peer.py:91,245; Seed.py:305)
    topology_dump_period: float = 30.0  # seed topology print (Seed.py:486)

    def scaled(self, factor: float) -> "ProtocolTiming":
        """Uniformly speed up (factor < 1) every duration; counts unchanged."""
        return ProtocolTiming(
            **{
                f.name: (
                    getattr(self, f.name) * factor
                    if f.type == "float"
                    else getattr(self, f.name)
                )
                for f in dataclasses.fields(self)
            }
        )
