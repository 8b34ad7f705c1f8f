"""Device meshes (the JAX package's ``parallel/mesh.py``).

One process drives a mesh of named axes (``dp``, ``tp``, ``sp``), as the
JAX package's single controller drives a ``jax.sharding.Mesh``. Each rank
of the mesh is a ``torch.device``; a rank's work runs on its device, and
chunks move between ranks by device-to-device copies (peer copies between
cards, plain copies within one).

Where the mesh has more ranks than the run has devices, the ranks share
the devices round-robin ("virtual ranks"): rank i runs on device
i % len(devices). The CPU tests put P ranks on ``"cpu"``, and one card
can hold the P ranks of a ring, as the JAX tests put theirs on virtual
CPU devices (``--xla_force_host_platform_device_count``). The JAX
``make_mesh`` refuses a mesh larger than its device list.

Data, tensor, sequence and pipeline parallelism run one rank a process
instead (``ProcessMesh``: axes ``pp``, ``dp``, ``tp``, ``sp`` over a
``torch.distributed`` group), with each collective explicit in the port's
code (``parallel/comm.py``) where the JAX package leaves them to GSPMD.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from koifish_tpu_torch.utils.device import resolve_device


def mesh_shape_for(n_devices: int, tp: Optional[int] = None
                   ) -> Dict[str, int]:
    """Pick a (dp, tp) factorization. Defaults: tp = min(n, 4) when it
    divides n, the rest data-parallel (so n >= 8 also gets dp >= 2)."""
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if n_devices % cand == 0 and cand <= n_devices:
                tp = cand
                break
    assert n_devices % tp == 0
    return {"dp": n_devices // tp, "tp": tp}


class Mesh:
    """Named axes over an array of ``torch.device``s, one per rank.

    ``shape`` maps each axis name to its size (``mesh.shape["sp"]``, as in
    JAX); ``devices`` is an object array of that shape."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"Mesh: {devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices of the ranks along ``axis``, the other axes at index
        0. Ranks that differ only in another axis hold replicas of the
        same chunk; one controller computes each chunk once."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])

    @property
    def n_devices(self) -> int:
        """Distinct devices the ranks lie on."""
        return len({str(d) for d in self.devices.flat})


def _device(d) -> torch.device:
    """A rank's device, a card always with its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_devices() -> list:
    resolve_device(None)                 # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Union[str, torch.device, Sequence]] = None
              ) -> Mesh:
    """A mesh of ``axes`` (default ``mesh_shape_for`` the device count).
    ``devices``: a device, a list of devices, or None for every visible
    card (raises without one; pass ``"cpu"`` for the CPU). Ranks are placed
    round-robin over the devices, in row-major order of the axes."""
    if devices is None:
        devs = _visible_devices()
    elif isinstance(devices, (str, torch.device)):
        devs = [_device(devices)]
    else:
        devs = [_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    axes = axes or mesh_shape_for(len(devs))
    n = int(np.prod(list(axes.values())))
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = devs[i % len(devs)]
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


# ---------------------------------------------------------------------------
# process meshes: one rank a process (torch.distributed)
# ---------------------------------------------------------------------------

#: axis order of a process mesh, outermost first: ``pp`` alone (the
#: pipeline takes no other axis), then the JAX CLI's ``dp``, ``tp``, ``sp``
#: (``koifish_tpu/cli/koifish.py:217-219``), so the ranks of a ring are
#: neighbours (on one host)
PROCESS_AXES = ("pp", "dp", "tp", "sp")


def choose_backend(devices: Sequence) -> Tuple[str, str]:
    """(backend, reason) for ranks on ``devices`` (one entry a rank): NCCL
    when every rank has a card of its own, gloo on the CPU and when ranks
    share a card (NCCL refuses two ranks on one GPU)."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "gloo", "ranks on the CPU"
    idx = [d.index if d.index is not None else 0 for d in devs]
    if len(set(idx)) < len(idx):
        return "gloo", (f"{len(idx)} ranks share {len(set(idx))} card(s); "
                        f"NCCL refuses two ranks on one GPU")
    import torch.distributed as dist
    if not dist.is_nccl_available():
        return "gloo", "this PyTorch has no NCCL"
    return "nccl", "one card a rank"


def rank_device(rank: int, device: Optional[str] = None) -> torch.device:
    """Rank ``rank``'s device: the CPU under ``device="cpu"``, else the
    visible cards round-robin (raises without a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


class ProcessMesh:
    """Named axes over the processes of a ``torch.distributed`` group, one
    rank a process: the counterpart of the JAX package's ``Mesh`` once each
    rank is a process of its own. ``axes`` maps ``pp``/``dp``/``tp``/``sp``
    to sizes (missing axes are 1); rank r sits at the row-major coordinates of
    r over ``PROCESS_AXES``. Each axis is a process group of the ranks that
    differ only along it (``torch.distributed.new_group``: every rank
    builds every group, in the same order). ``shape``, ``size(axis)``,
    ``index(axis)`` (this rank's coordinate), ``group(axis)`` and
    ``ranks(axis)`` (the global ranks of this rank's group)."""

    def __init__(self, axes: Dict[str, int], device: torch.device,
                 backend: str = "gloo"):
        import torch.distributed as dist
        bad = set(axes) - set(PROCESS_AXES)
        if bad:
            raise ValueError(f"ProcessMesh: unknown axes {sorted(bad)}; "
                             f"a process mesh has {PROCESS_AXES}")
        self.shape = {a: int(axes.get(a, 1)) for a in PROCESS_AXES}
        self.world = int(np.prod(list(self.shape.values())))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have != self.world:
            raise ValueError(f"ProcessMesh {self.shape} needs {self.world} "
                             f"ranks; the process group has {have}")
        self.device = torch.device(device)
        self.backend = backend
        #: the group of every rank (None for a mesh of one rank)
        self.world_group = dist.group.WORLD if self.world > 1 else None
        dims = tuple(self.shape.values())
        grid = np.arange(self.world).reshape(dims)
        self.coords = dict(zip(PROCESS_AXES,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 dims))))
        self._groups, self._ranks = {}, {}
        for ai, a in enumerate(PROCESS_AXES):
            lines = np.moveaxis(grid, ai, -1).reshape(-1, dims[ai])
            for line in lines:
                ranks = [int(r) for r in line]
                # every rank creates every group, in one order
                g = (dist.new_group(ranks) if self.world > 1
                     and dims[ai] > 1 else None)
                if self.rank in ranks:
                    self._groups[a], self._ranks[a] = g, ranks

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def ranks(self, axis: str) -> list:
        return self._ranks.get(axis, [self.rank])

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that does the run's I/O."""
        return self.rank == 0

    def __repr__(self) -> str:
        axes = " ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"ProcessMesh({axes}, rank {self.rank}/{self.world}, "
                f"{self.backend}, {self.device})")


def make_process_mesh(axes: Dict[str, int],
                      device: Optional[str] = None) -> ProcessMesh:
    """The process mesh of ``axes`` over the group this process has joined
    (``parallel/multihost.init_distributed``; a mesh of one rank needs
    none), on this rank's device (the CPU under ``device="cpu"``)."""
    import torch.distributed as dist
    from koifish_tpu_torch.parallel.multihost import local_device
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    return ProcessMesh(axes, local_device(device), backend)
