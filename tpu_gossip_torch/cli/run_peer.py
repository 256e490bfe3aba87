"""Peer node CLI (reference: ``python Peer.py`` + stdin port prompt,
Peer.py:456-465). The reference operator surface is preserved on stdin:
``exit`` quits, ``1`` toggles silent-mode fault injection (Peer.py:437-439);
any other line is gossiped into the swarm (a generalization), or — with
``--stdin-to-seeds`` — forwarded verbatim to every connected seed, the
reference's literal passthrough (Peer.py:441-442, consumed as
"Unrecognized" at Seed.py:440-441). ``--dump-every`` prints the live
connection list periodically (printPeerConnections, Peer.py:448-454).
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="listening port (omitted: prompt on stdin, like the "
                   "reference Peer.py:456-465)")
    p.add_argument("--config", default="config.txt")
    p.add_argument("--no-relay", action="store_true",
                   help="reference-conformant one-hop gossip (no epidemic relay)")
    p.add_argument("--time-scale", type=float, default=1.0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--run-seconds", type=float, default=0,
                   help="run this long then exit (0 = until stdin 'exit'; "
                   "EOF on stdin leaves the node running as a daemon)")
    p.add_argument("--stdin-to-seeds", action="store_true",
                   help="forward unrecognized stdin lines to every connected "
                   "seed (the reference's literal passthrough, "
                   "Peer.py:441-442) instead of gossiping them")
    p.add_argument("--dump-every", type=float, default=0, metavar="SECONDS",
                   help="periodically print this peer's live connections "
                   "(printPeerConnections, Peer.py:448-454); 0 = off")
    return p


async def amain(args) -> int:
    from tpu_gossip_torch.compat.peer import PeerNode
    from tpu_gossip_torch.compat.timing import ProtocolTiming

    node = PeerNode(
        args.ip,
        args.port,
        config_path=args.config,
        timing=ProtocolTiming().scaled(args.time_scale),
        gossip_relay=not args.no_relay,
        log_stdout=not args.quiet,
    )
    await node.start()

    from tpu_gossip_torch.cli import stdin_queue

    lines = stdin_queue(asyncio.get_event_loop())

    async def stdin_loop():
        while node.running:
            line = await lines.get()
            if line is None:  # EOF: daemonize
                return
            if line.strip() == "exit":
                await node.stop()
                return
            if line.strip() == "1":  # silent-mode fault injection
                node.set_silent(not node.silent)
                node.log(f"silent={node.silent}")
            elif line.strip():
                if args.stdin_to_seeds:
                    n = node.send_to_seeds(line.strip())
                    node.log(f"forwarded to {n} seeds: {line.strip()!r}")
                else:
                    node.gossip(line.strip())

    async def dump_loop():
        while node.running:
            await asyncio.sleep(args.dump_every)
            if node.running:
                node.log(f"connections: {node.neighbors}")

    asyncio.ensure_future(stdin_loop())
    if args.dump_every > 0:
        asyncio.ensure_future(dump_loop())
    if args.run_seconds > 0:
        await asyncio.sleep(args.run_seconds)
        await node.stop()
    else:
        while node.running:
            await asyncio.sleep(0.2)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.port is None:
        from tpu_gossip_torch.cli import prompt_port

        args.port = prompt_port("peer")
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
