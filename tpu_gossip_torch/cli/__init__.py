"""Operator entry points (the port's copies of ``tpu_gossip/cli/``).

The reference's CLI is two interactive scripts prompting for a port on stdin
(reference Seed.py:479-492, Peer.py:456-465). Here: `run_sim` drives the
batched engine on the card; `run_seed`/`run_peer` run socket-compatible
nodes (``compat/``) with argparse flags and, like the reference, fall back
to a stdin port prompt when ``--port`` is omitted. ``prompt_port`` and
``stdin_queue`` are copies of the JAX package's.
"""

from __future__ import annotations

import asyncio
import sys
import threading


def prompt_port(role: str) -> int:
    """Reference-parity stdin port prompt (Peer.py:456-465, Seed.py:479-492):
    a bare ``run_peer``/``run_seed`` invocation asks for the port
    interactively instead of erroring on a missing flag."""
    while True:
        try:
            raw = input(f"Enter the port for this {role} node: ")
        except EOFError:
            print(f"no --port given and stdin closed; cannot start {role}",
                  file=sys.stderr)
            raise SystemExit(2)
        try:
            port = int(raw.strip())
        except ValueError:
            print(f"not a port number: {raw!r}", file=sys.stderr)
            continue
        if 0 < port < 65536:
            return port
        print(f"port out of range: {port}", file=sys.stderr)


def stdin_queue(loop: asyncio.AbstractEventLoop) -> asyncio.Queue:
    """Feed stdin lines into an asyncio queue from a daemon thread.

    A daemon thread (not run_in_executor) so asyncio.run's shutdown never
    joins a thread blocked in readline — otherwise --run-seconds exits hang
    until the operator presses Enter. EOF enqueues None once.
    """
    q: asyncio.Queue = asyncio.Queue()

    def pump() -> None:
        while True:
            line = sys.stdin.readline()
            loop.call_soon_threadsafe(q.put_nowait, line if line else None)
            if not line:
                return

    threading.Thread(target=pump, daemon=True).start()
    return q
