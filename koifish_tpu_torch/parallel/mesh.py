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
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

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
