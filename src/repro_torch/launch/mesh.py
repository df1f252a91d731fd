"""The fleet mesh — port of the fleet half of ``repro/launch/mesh.py``.

A ``FleetMesh`` is the tuple of devices that the fleet entry points
(``core.whatif.sharded_*``) split their fork or scenario axis over: one
shard per entry, on a ``data`` axis (``shape == {"data": n, "model":
1}``).  A device may appear more than once; each entry is one shard.
That is how two or three shards run on the CPU or on one card, as the
reference's tests run them on ``--xla_force_host_platform_device_count``
host devices.  The shards of a mesh run one after the other, each on
its own device; their results meet on the first device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, init=False)
class FleetMesh:
    """Shards on a ``data`` axis, one device each (repeats allowed)."""

    devices: Tuple[torch.device, ...]

    def __init__(self, devices: Sequence[DeviceLike]) -> None:
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a FleetMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    @property
    def home(self) -> torch.device:
        """Where shard results are gathered and selection runs."""
        return self.devices[0]


def make_fleet_mesh(shards: Optional[int] = None) -> FleetMesh:
    """A (data=shards, model=1) mesh over the first ``shards`` local
    CUDA devices, every one when ``shards`` is None.  A prefix of the
    device list is accepted, so ``--shard 2`` works on an 8-card host.
    Raises where torch sees no card: there is no CPU fallback (build a
    ``FleetMesh(["cpu"] * n)`` to shard on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_fleet_mesh: torch sees no CUDA device; "
                           "build FleetMesh(['cpu']) to run on the host")
    n = torch.cuda.device_count()
    s = n if shards is None else int(shards)
    if not 1 <= s <= n:
        raise ValueError(f"shards={s} outside [1, {n}] local devices")
    return FleetMesh([torch.device("cuda", i) for i in range(s)])
