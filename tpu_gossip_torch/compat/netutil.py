"""Small shared asyncio-transport helpers for the socket compat layer (the
port's own copy of ``tpu_gossip/compat/netutil.py``)."""

from __future__ import annotations

import asyncio

__all__ = ["close_server_best_effort"]


async def close_server_best_effort(
    server: asyncio.AbstractServer | None, timeout: float = 5.0
) -> None:
    """Close a listening server without ever hanging shutdown.

    Python 3.12's ``Server.wait_closed()`` waits for every connection to
    fully close, so one straggler mid-handshake could hang ``stop()``
    forever; node shutdown is best-effort by design (the reference's is a
    daemon-thread process exit, reference Peer.py:417-446).
    """
    if server is None:
        return
    server.close()
    try:
        await asyncio.wait_for(server.wait_closed(), timeout=timeout)
    except (asyncio.TimeoutError, TimeoutError):
        pass
