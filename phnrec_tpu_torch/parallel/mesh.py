"""The port's counterpart of a ``jax.sharding.Mesh`` with a "data" axis.

phnrec_tpu shards a batch or a stream axis with ``P("data")`` over the
devices of a mesh, under one controller.  The port runs SPMD instead: one
process per card, every rank running the same program, and a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names include
"data".  Rank r of a data group of size R owns the r-th contiguous share
of the rows, as ``P("data")`` splits them; what every rank must see (the
fetched segments, the label lists, the counters) is all-gathered or
all-reduced over that group.  The group is NCCL on the card (call
``torch.cuda.set_device`` before the first collective) and gloo on the
CPU.  Nothing here creates a process group: the caller initializes it,
with a ``FileStore`` or a ``tcp://localhost`` address, its world size and
its rank.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch
import torch.distributed as dist


class DataAxis(NamedTuple):
    group: Any          # the ProcessGroup of the "data" dimension
    rank: int           # this process's index along it
    size: int           # its size
    device_type: str    # "cuda" (NCCL) or "cpu" (gloo)


def data_axis(mesh) -> DataAxis:
    """The "data" dimension of ``mesh``.  Raises TypeError for anything but
    a DeviceMesh, ValueError for one without a "data" dimension."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh with a 'data' dimension, not "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names:
        raise ValueError(f"mesh has no 'data' dimension (its dimensions: "
                         f"{names})")
    return DataAxis(mesh.get_group("data"), mesh.get_local_rank("data"),
                    mesh.size(names.index("data")), mesh.device_type)


def world_axis() -> DataAxis:
    """A DataAxis over the default group (every process)."""
    return DataAxis(None, dist.get_rank(), dist.get_world_size(),
                    "cuda" if dist.get_backend() == "nccl" else "cpu")


def rows_of(n: int, axis: DataAxis) -> Tuple[int, int]:
    """The contiguous rows [lo, hi) of ``n`` that this rank owns: shares
    of ceil(n / size) rows, the last ranks' shorter or empty."""
    share = -(-n // axis.size)
    lo = min(n, axis.rank * share)
    return lo, min(n, lo + share)


def _device(axis: DataAxis) -> torch.device:
    if axis.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj, axis: DataAxis) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    out: List[Any] = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    return out


def all_reduce(values, axis: DataAxis, op=dist.ReduceOp.SUM) -> List[float]:
    """Float64 all-reduce of a list of numbers."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_device(axis))
    dist.all_reduce(t, op=op, group=axis.group)
    return t.cpu().tolist()
