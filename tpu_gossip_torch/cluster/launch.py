"""Several processes: ``torch.distributed`` ranks of ``run_sim`` on one machine.

Ports ``tpu_gossip/cluster/launch.py``. Two halves:

- :func:`init_distributed`, which ``run_sim`` calls under
  ``--coordinator``: it joins the process group through a TCP rendezvous at
  the coordinator's address, with ``backend`` (gloo or nccl), and picks the
  rank's device. NCCL needs a card a rank: ranks sharing one card under
  NCCL are refused (exit 2) before anything starts, naming the device.
  Ranks sharing a card run gloo, which takes the card's tensors for its
  ``all_to_all_single``, ``all_gather`` and ``all_reduce`` and moves them
  through host memory itself (``cluster/topology.py::exchange_blocks``). A
  backend that fails to start is an error: nothing retries with the other
  one.
- the ``__main__`` launcher, which spawns N ``run_sim`` ranks on localhost,
  one a host row, each holding ``--devices-per-host`` shards, with the
  coordinator flags appended. Each rank's output comes back prefixed with
  ``[i]``, the exit code is the ranks' maximum, and a rank past
  ``--timeout`` is killed and counted as 124.

``--backend`` defaults to ``nccl`` when every rank gets a card of its own
and to ``gloo`` otherwise (``--device cpu``, or ranks sharing a card).
Each rank's first stderr line names its backend and device.

Usage::

    python -m tpu_gossip_torch.cluster.launch --nprocs 2 --devices-per-host 4 \\
        -- --shard --graph matching --peers 2000 --rounds 12 --digest --device cpu

The separator ``--`` splits the launcher's flags from the ``run_sim`` argv
(``resume D`` included).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from tpu_gossip_torch.cluster import LOCAL_SHARDS_ENV

__all__ = ["init_distributed", "default_backend", "launch_workers", "main", "rank_device", "SharedCardError"]


class SharedCardError(RuntimeError):
    """NCCL asked for more ranks than cards."""


def rank_device(device: str, process_id: int) -> str:
    """The rank's device: its card, round-robin over the visible cards, or
    the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return f"cuda:{process_id % max(torch.cuda.device_count(), 1)}"


def init_distributed(coordinator: str, num_processes: int, process_id: int, backend: str = "gloo",
                     device: str = "cuda") -> str:
    """Join the process group as rank ``process_id`` of ``num_processes``
    through ``tcp://coordinator`` with ``backend``; returns the rank's
    device. Under NCCL each rank needs a card of its own:
    :class:`SharedCardError` names the card two ranks would share. A
    process already in a group as that rank of that size (a program running
    ``run_sim.main`` in its ranks) keeps it; any other group is an error."""
    import datetime

    import torch

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} must be gloo or nccl")
    dev = rank_device(device, process_id)
    if backend == "nccl":
        if dev == "cpu":
            raise SharedCardError("--dist-backend nccl moves card memory; a --device cpu rank runs gloo")
        cards = torch.cuda.device_count()
        if num_processes > cards:
            raise SharedCardError(
                f"--dist-backend nccl needs a card a rank: {num_processes} ranks on {cards} card(s) would share "
                f"{dev} (NCCL refuses two ranks on one device); run --backend gloo")
    if dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    if torch.distributed.is_initialized():
        held = (torch.distributed.get_world_size(), torch.distributed.get_rank(), torch.distributed.get_backend())
        if held != (num_processes, process_id, backend):
            raise RuntimeError(f"this process is already rank {held[1]} of {held[0]} ({held[2]}); it cannot join as "
                               f"rank {process_id} of {num_processes} ({backend})")
        return dev
    torch.distributed.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                                         rank=process_id, timeout=datetime.timedelta(seconds=300))
    return dev


def _worker_device(worker_argv: list[str]) -> str:
    """The ``--device`` the ``run_sim`` argv asks for (cuda by default)."""
    dev = "cuda"
    for i, a in enumerate(worker_argv):
        if a == "--device" and i + 1 < len(worker_argv):
            dev = worker_argv[i + 1]
        elif a.startswith("--device="):
            dev = a.split("=", 1)[1]
    return dev


def default_backend(worker_argv: list[str], nprocs: int) -> str:
    """nccl when every rank gets a card of its own, else gloo."""
    if _worker_device(worker_argv).startswith("cpu"):
        return "gloo"
    import torch

    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= nprocs else "gloo"


def launch_workers(worker_argv: list[str], nprocs: int, devices_per_host: int, *, port: int = 12723,
                   timeout: float | None = None, backend: str | None = None,
                   module: str = "tpu_gossip_torch.cli.run_sim", out=None) -> int:
    """Spawn ``nprocs`` ranks of ``python -m module <worker_argv> --hosts N
    --coordinator 127.0.0.1:port --num-processes N --process-id i
    --dist-backend B`` on localhost, each holding ``devices_per_host``
    shards; print each rank's output with an ``[i]`` prefix to ``out``
    (stdout) once it ends and return the ranks' maximum exit code (124 for
    a rank past ``timeout``)."""
    out = sys.stdout if out is None else out
    backend = backend or default_backend(worker_argv, nprocs)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for i in range(nprocs):
        env = dict(os.environ)
        env[LOCAL_SHARDS_ENV] = str(devices_per_host)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        argv = [sys.executable, "-m", module, *worker_argv, "--hosts", str(nprocs),
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(nprocs), "--process-id", str(i),
                "--dist-backend", backend]
        procs.append((i, subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)))
    rc = 0
    for i, p in procs:
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            print(f"[{i}] TIMED OUT", file=out, flush=True)
            rc = max(rc, 124)
        for line in (text or "").splitlines():
            print(f"[{i}] {line}", file=out, flush=True)
        rc = max(rc, p.returncode or 0)
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_gossip_torch.cluster.launch",
                                 description="spawn N torch.distributed run_sim ranks on localhost")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=4, help="mesh shards each rank holds")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="process group backend (default: nccl with a card a rank, else gloo)")
    ap.add_argument("--port", type=int, default=12723)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("worker_argv", nargs=argparse.REMAINDER, help="run_sim argv after a -- separator")
    args = ap.parse_args(argv)
    worker = args.worker_argv
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        ap.error("no run_sim argv given (append it after --)")
    if args.nprocs < 2:
        ap.error("--nprocs must be >= 2 (one process is the fold: run_sim --hosts H)")
    return launch_workers(worker, args.nprocs, args.devices_per_host, port=args.port, timeout=args.timeout,
                          backend=args.backend)


if __name__ == "__main__":
    sys.exit(main())
