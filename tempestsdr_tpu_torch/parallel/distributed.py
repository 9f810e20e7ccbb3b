"""Multi-process bring-up over torch.distributed.

One process per mesh position: each host starts its ranks, each rank calls
init_distributed and then make_global_mesh, and feeds the channels whose
rows it holds (config 5: local_channel_slice) or its time shard of a
wideband block (config 4). The step builders in .channels and .timeshard
take the mesh and work unchanged on one host or many.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def init_distributed(coordinator: str, num_processes: int, process_id: int, *,
                     backend: str = "nccl") -> None:
    """torch.distributed bring-up; call on every rank before any collective.
    The JAX package's three-argument call binds as it is.

    coordinator: "host:port" of rank 0's rendezvous (or a full init method
    such as "file:///path"). backend: "nccl" (the default) for one rank per
    card, the deployment the three-argument call means (this rank takes
    card process_id % cards, so start a host's ranks in order); "gloo",
    given explicitly, for CPU ranks and for several ranks that share one
    card."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def make_global_mesh(n_channel: int, n_time: int, *, device="cuda") -> Mesh:
    """The mesh over every rank of every host, in rank order: with ranks
    started host by host and n_channel >= hosts, each host's channels stay
    on its own ranks and only the 'time' collectives leave a host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = n_channel * n_time
    if world < need:
        raise ValueError(f"need {need} ranks across hosts, have {world}")
    return make_mesh(n_channel, n_time, device=device)


def channel_row_bounds(n_channels_global: int, ch_rows: int) -> list:
    """Block distribution of channels over the 'ch' axis rows: row r owns
    channels [bounds[r], bounds[r+1]). Non-divisible counts spread the
    remainder over the first rows (standard balanced blocks)."""
    if ch_rows <= 0:
        raise ValueError("mesh has no 'ch' rows")
    per, rem = divmod(n_channels_global, ch_rows)
    bounds = [0]
    for r in range(ch_rows):
        bounds.append(bounds[-1] + per + (1 if r < rem else 0))
    return bounds


def local_channel_slice(mesh, n_channels_global: int) -> slice:
    """Which global channel indices this host feeds: channels are
    block-distributed over the 'ch' rows in mesh order (balanced blocks,
    remainder on the first rows), and a host feeds the rows that hold one of
    its ranks. Reads only mesh.devices (each with .process_index) and
    mesh.process_index, this host's. Raises if this host's rows are not
    contiguous (make_global_mesh over ranks started host by host never
    makes such a mesh; a hand-built one can)."""
    ch_rows = mesh.devices.shape[0]
    bounds = channel_row_bounds(n_channels_global, ch_rows)
    local_rows = [r for r in range(ch_rows)
                  if any(d.process_index == mesh.process_index for d in mesh.devices[r])]
    if not local_rows:
        return slice(0, 0)
    lo, hi = min(local_rows), max(local_rows)
    if local_rows != list(range(lo, hi + 1)):
        raise ValueError(
            "this host's 'ch' rows are non-contiguous; build the mesh over "
            "ranks started host by host (make_global_mesh) so each host's "
            "channels form one block")
    return slice(bounds[lo], bounds[hi + 1])
