"""Starting the ranks of a process mesh (the JAX package's
``parallel/multihost.py``).

One rank is one process. A run joins a process group set up from the
environment — this module's launcher (``KOIFISH_INIT``,
``KOIFISH_WORLD_SIZE``, ``KOIFISH_RANK``) or torchrun's (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) — or, where none is set
up and the mesh has more than one rank, the CLIs start their local ranks
themselves (``spawn``): one command, as in the JAX package, whose single
controller drives all of a host's devices.

Launch across hosts (the same command on every host; K ranks a host):

    python -m koifish_tpu_torch.parallel.multihost \\
        --coordinator host0:8476 --num-hosts N --host-id $ID \\
        --nproc-per-host K -- \\
        python -m koifish_tpu_torch.cli.koifish cfg.json --dp N --tp K

Ranks are placed round-robin over the visible cards (``LOCAL_RANK`` or the
rank modulo the card count), or all on the CPU under ``--device cpu``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, Optional, Sequence

import torch


def env_rank() -> Optional[tuple]:
    """(init_method, world_size, rank, local_rank) from the environment, or
    None when no launcher set one up."""
    e = os.environ
    if e.get("KOIFISH_INIT"):
        rank = int(e["KOIFISH_RANK"])
        return (e["KOIFISH_INIT"], int(e["KOIFISH_WORLD_SIZE"]), rank,
                int(e.get("KOIFISH_LOCAL_RANK", rank)))
    if e.get("RANK") and e.get("WORLD_SIZE") and e.get("MASTER_ADDR"):
        rank = int(e["RANK"])
        return ("env://", int(e["WORLD_SIZE"]), rank,
                int(e.get("LOCAL_RANK", rank)))
    return None


_why = {"backend": "none (one process)"}


def backend_choice() -> str:
    """The backend this process joined with and why, for the run's log."""
    return _why["backend"]


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Initialize ``torch.distributed`` from the arguments or the
    environment. Returns False for a single process (nothing to join).
    The backend is NCCL where every rank has a card of its own and gloo
    otherwise (``mesh.choose_backend``); a rank on a card makes that card
    current. ``timeout_s``: how long a collective may wait before it
    raises (torch's default when None)."""
    import datetime
    import torch.distributed as dist
    from koifish_tpu_torch.parallel.mesh import choose_backend, rank_device
    if dist.is_initialized():
        return True
    local = None
    if init_method is None:
        got = env_rank()
        if got is None:
            return False
        init_method, world_size, rank, local = got
    if int(world_size or 1) <= 1:
        return False
    world_size, rank = int(world_size), int(rank)
    local = rank if local is None else local
    dev = rank_device(local, device)
    n_local = int(os.environ.get("KOIFISH_LOCAL_WORLD", world_size))
    backend, why = choose_backend([rank_device(r, device)
                                   for r in range(n_local)])
    _why["backend"] = f"{backend} ({why})"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def local_device(device: Optional[str] = None) -> torch.device:
    """This rank's device (the CPU under ``device="cpu"``)."""
    from koifish_tpu_torch.parallel.mesh import rank_device
    got = env_rank()
    local = got[3] if got else 0
    return rank_device(local, device)


def per_host_batch_slice(global_batch: int, mesh=None) -> slice:
    """This rank's slice of the global batch: its rows along ``dp`` of
    ``mesh`` (a ``ProcessMesh``; the world's ranks when none is given)."""
    import torch.distributed as dist
    if mesh is not None:
        n, idx = mesh.size("dp"), mesh.index("dp")
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
        idx = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


def _child(rank: int, fn: Callable, args: tuple, world: int, init: str,
           device: Optional[str], threads: int) -> None:
    os.environ.update(KOIFISH_INIT=init, KOIFISH_WORLD_SIZE=str(world),
                      KOIFISH_RANK=str(rank), KOIFISH_LOCAL_RANK=str(rank),
                      KOIFISH_LOCAL_WORLD=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        fn(*args)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          device: Optional[str] = None, threads: int = 0,
          init_dir: Optional[str] = None) -> None:
    """Run ``fn(*args)`` in ``world`` new local processes, ranks 0..world-1
    of one group (joined through a file under ``init_dir``, a temporary
    directory by default), and wait for them; raises if any rank fails.
    ``fn`` must be importable by name (the processes start fresh).
    ``threads``: intra-op threads a rank (0: torch's default)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=init_dir) as d:
        init = "file://" + os.path.join(d, "rendezvous")
        mp.start_processes(_child, args=(fn, tuple(args), world, init,
                                         device, threads),
                           nprocs=world, join=True, start_method="spawn")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="koifish-multihost")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--init-method", default=None,
                    help="a torch.distributed init method in place of "
                         "--coordinator (e.g. file:///shared/path)")
    ap.add_argument("--num-hosts", type=int, required=True)
    ap.add_argument("--host-id", type=int, required=True)
    ap.add_argument("--nproc-per-host", type=int, default=1)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    init = args.init_method or (f"tcp://{args.coordinator}"
                                if args.coordinator else None)
    if init is None:
        ap.error("--coordinator or --init-method is required")
    k = args.nproc_per_host
    procs = []
    for local in range(k):
        env = dict(os.environ,
                   KOIFISH_INIT=init,
                   KOIFISH_WORLD_SIZE=str(args.num_hosts * k),
                   KOIFISH_RANK=str(args.host_id * k + local),
                   KOIFISH_LOCAL_RANK=str(local),
                   KOIFISH_LOCAL_WORLD=str(k))
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    return next((rc for rc in rcs if rc), 0)


if __name__ == "__main__":
    sys.exit(main())
