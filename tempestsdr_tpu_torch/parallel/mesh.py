"""The mesh the sharded steps run over: a (ch, time) grid of torch.distributed
ranks, one process per mesh position (SPMD), as the JAX package's Mesh is a
(ch, time) grid of devices.

The 'time' axis carries a wideband block's shards (parallel/timeshard.py):
each rank of a row holds one contiguous segment and the row exchanges
halos, gathers the envelope and sums the pixels. The 'ch' axis carries
independent channels (parallel/channels.py), with no collective at all.
Lay ranks out host-major so a row's collectives stay within a host.

Backends: "nccl" for one rank per card; "gloo" for CPU ranks and for several
ranks sharing one card (NCCL refuses two ranks on one device). Gloo's
collectives here take CPU tensors: on a CUDA tensor the mesh copies it to
host memory, runs the collective there and copies the result back to the
rank's card. Only the exchange goes through the host; the step's compute
stays on the card.
"""

from __future__ import annotations

import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


class MeshDevice(NamedTuple):
    """One mesh position: its rank in the default group, that rank's torch
    device, and the host it runs on (hosts numbered in rank order)."""

    rank: int
    device: str
    process_index: int


class Mesh:
    """A (ch, time) grid of ranks as seen from one rank. `devices` is the
    (C, T) object array of MeshDevice, `shape` {"ch": C, "time": T};
    `coords` is this rank's (row, column), None if it is outside the mesh.
    The collectives act along this rank's 'time' row."""

    def __init__(self, devices: np.ndarray, rank: int, process_index: int, backend=None,
                 time_group=None, ch_group=None):
        self.devices = devices
        self.shape = {"ch": devices.shape[0], "time": devices.shape[1]}
        self.rank, self.process_index, self.backend = rank, process_index, backend
        self._time_group, self._ch_group = time_group, ch_group
        where = [(r, t) for r in range(devices.shape[0]) for t in range(devices.shape[1])
                 if devices[r, t].rank == rank]
        self.coords = where[0] if where else None

    def _position(self):
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh")
        return self.coords

    @property
    def ch_index(self) -> int:
        return self._position()[0]

    @property
    def time_index(self) -> int:
        return self._position()[1]

    @property
    def device(self) -> torch.device:
        """This rank's torch device."""
        r, t = self._position()
        return torch.device(self.devices[r, t].device)

    @staticmethod
    def _not_captured(what: str) -> None:
        """A collective is never captured into a CUDA graph: a replay would
        not run it (the sharded steps run their collectives between their
        stages' replays, stream.graph.StagedRunner)."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"Mesh.{what} called while the current stream captures a "
                               "CUDA graph: run the collective between the graph's replays")

    def _to_backend(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous copy the backend takes: in host memory under gloo."""
        if self.backend == "gloo" and x.device.type != "cpu":
            return x.detach().to("cpu")
        return x.detach().contiguous().clone()

    def all_gather(self, x: torch.Tensor, tiled: bool = False) -> torch.Tensor:
        """Every rank of the row's x, stacked on a new leading axis in 'time'
        order ([T, ...]), or concatenated along axis 0 when tiled."""
        self._not_captured("all_gather")
        T = self.shape["time"]
        self._position()
        if T == 1:
            return x if tiled else x.unsqueeze(0)
        xs = self._to_backend(x)
        parts = [torch.empty_like(xs) for _ in range(T)]
        dist.all_gather(parts, xs, group=self._time_group)
        out = (torch.cat if tiled else torch.stack)(parts)
        return out.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the row's x, on every rank of the row."""
        self._not_captured("psum")
        self._position()
        if self.shape["time"] == 1:
            return x
        xs = self._to_backend(x)
        dist.all_reduce(xs, group=self._time_group)
        return xs.to(x.device)

    def shift_right(self, x: torch.Tensor):
        """The left neighbour's x (what a ppermute to the right delivers);
        None on the row's first rank, whose caller substitutes its carry.
        Collective: every rank of the row calls it."""
        t, every = self.time_index, self.all_gather(x)
        return every[t - 1] if t > 0 else None

    def shift_left(self, x: torch.Tensor):
        """The right neighbour's x; None on the row's last rank. Collective."""
        t, every = self.time_index, self.all_gather(x)
        return every[t + 1] if t < self.shape["time"] - 1 else None


def make_mesh(n_channel: int = 1, n_time: int = 1, devices=None, *, device="cuda") -> Mesh:
    """The (n_channel, n_time) mesh over `devices`, a sequence of ranks of
    the default group (default: every rank, in order), laid out row-major so
    the 'time' axis is innermost. Every rank of the default group calls it,
    in the same order as every other collective: it gathers each rank's
    host and `device` (this rank's torch device; "cuda" is the current
    card) and creates one subgroup per row ('time') and per column ('ch').
    Without an initialised process group the world is this one process."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    me = (socket.gethostname(), str(dev))
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
        info = [None] * world
        dist.all_gather_object(info, me)
    else:
        world, rank, backend, info = 1, 0, None, [me]
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"devices must be distinct ranks of the {world}-rank group: {ranks}")
    need = n_channel * n_time
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    hosts: dict = {}
    for host, _ in info:
        hosts.setdefault(host, len(hosts))
    grid = np.empty((n_channel, n_time), dtype=object)
    for i, r in enumerate(ranks[:need]):
        grid[i // n_time, i % n_time] = MeshDevice(r, info[r][1], hosts[info[r][0]])
    groups = {}
    if world > 1:
        # new_group is collective over the default group: every rank creates
        # every subgroup, in one order, and keeps the ones it is in
        lines = [("time", [d.rank for d in grid[r]]) for r in range(n_channel)]
        lines += [("ch", [d.rank for d in grid[:, t]]) for t in range(n_time)]
        for axis, members in lines:
            group = dist.new_group(members)
            if rank in members:
                groups[axis] = group
    return Mesh(grid, rank, hosts[info[rank][0]], backend, groups.get("time"), groups.get("ch"))
