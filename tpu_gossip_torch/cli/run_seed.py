"""Seed node CLI (reference: ``python Seed.py`` + stdin port prompt,
Seed.py:479-492). Flags configure the node; a bare invocation falls back to
the reference's stdin port prompt, and the operator command surface
(``exit`` on stdin, periodic topology dumps) is preserved.
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
                   "reference Seed.py:479-492)")
    p.add_argument("--config", default="config.txt")
    p.add_argument("--subset-policy", choices=["powerlaw", "first"], default="powerlaw")
    p.add_argument("--subset-size", type=int, default=3)
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="speed up all protocol timers by this factor (<1 = faster)")
    p.add_argument("--quiet", action="store_true", help="log to file only")
    p.add_argument("--run-seconds", type=float, default=0,
                   help="run this long then exit (0 = until stdin 'exit'; "
                   "EOF on stdin leaves the node running as a daemon)")
    return p


async def amain(args) -> int:
    from tpu_gossip_torch.compat.seed import SeedNode
    from tpu_gossip_torch.compat.timing import ProtocolTiming

    node = SeedNode(
        args.ip,
        args.port,
        config_path=args.config,
        timing=ProtocolTiming().scaled(args.time_scale),
        subset_policy=args.subset_policy,
        subset_size=args.subset_size,
        log_stdout=not args.quiet,
    )
    await node.start()

    from tpu_gossip_torch.cli import stdin_queue

    lines = stdin_queue(asyncio.get_event_loop())

    async def stdin_loop():
        while node.running:
            line = await lines.get()
            if line is None:  # EOF: daemonize, stop via --run-seconds or signal
                return
            if line.strip() == "exit":  # Seed.py:446-455
                await node.stop()
                return

    async def dump_loop():  # Seed.py:485-487
        while node.running:
            await asyncio.sleep(node.timing.topology_dump_period)
            node.log(f"Topology: {node.topology_snapshot()}")

    asyncio.ensure_future(dump_loop())
    asyncio.ensure_future(stdin_loop())
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

        args.port = prompt_port("seed")
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
