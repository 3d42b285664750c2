"""Device-mesh helpers for scene / camera / splat sharding.

Port of ``pegasus_tpu/parallel/mesh.py``.  The scale-out axes are the
reference's:

  * ``scene``  — data parallelism over scenes or scene variants (batched
    physics, independent renders, no communication);
  * ``batch``  — data parallelism over a training step's camera batch;
  * ``splat``  — model parallelism over the splat axis of one large scene:
    depth-contiguous shards composite locally and combine in shard order
    under the 'over' operator (``parallel/sharded_render.py``).

A mesh here is an array of *lanes*.  A lane is a ``torch.device`` with a
CUDA stream of its own (no stream on the CPU), and one device may stand in
the mesh more than once: ``make_mesh(devices=["cuda:0"] * 4)`` is four lanes
of one card, ``make_mesh(devices=["cpu"] * 4)`` four CPU lanes.  Partitioning,
ordering, combining and writing are therefore the same code on one card, on
several cards of one process and on the CPU.  Nothing here speaks
``torch.distributed``: the paths built on a mesh are one process driving its
lanes (``map_lanes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pegasus_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Lane:
    """One slot of a mesh: a device and, on a CUDA device, the stream that
    this lane's work is queued on."""

    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None

    @contextlib.contextmanager
    def activate(self):
        """Make this lane's stream the current stream (a no-op on the CPU).  Ordering against other streams is the caller's:
        ``map_lanes`` makes every lane wait for its caller and the caller
        for every lane."""
        if self.stream is None:
            yield self
        else:
            with torch.cuda.stream(self.stream):
                yield self


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Lanes arranged along named axes."""

    devices: np.ndarray  # object array of torch.device, shaped like the axes
    axis_names: tuple
    streams: np.ndarray = dataclasses.field(compare=False, repr=False, default=None)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def lanes(self, index=()) -> list:
        """The lanes of the sub-mesh at ``index`` (leading axes), row-major:
        ``mesh.lanes()`` is every lane, ``mesh.lanes((r,))`` row r of a 2-D
        mesh."""
        devs = np.asarray(self.devices[tuple(index)], dtype=object).reshape(-1)
        streams = np.asarray(self.streams[tuple(index)], dtype=object).reshape(-1)
        return [Lane(d, s) for d, s in zip(devs, streams)]

    def distinct_devices(self) -> list:
        """Every device of the mesh once, in order of first appearance."""
        seen = []
        for d in self.devices.reshape(-1):
            if d not in seen:
                seen.append(d)
        return seen


def _object_array(items, shape) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr.reshape(shape)


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("scene",),
    devices=None,
) -> Mesh:
    """Build a Mesh over ``devices`` (default: every visible CUDA device,
    one lane each; raises without a card).

    Default: a 1-D 'scene' mesh over all devices.  ``axis_sizes=(a, b)``
    with ``axis_names=('scene', 'splat')`` gives the 2-D scene-DP x splat-MP
    mesh.  A device listed n times gives n lanes on it."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    n = len(devs)
    if axis_sizes is None:
        axis_sizes = (n,)
    axis_sizes = tuple(int(a) for a in axis_sizes)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} devices")
    if len(axis_sizes) != len(tuple(axis_names)):
        raise ValueError(f"mesh {axis_sizes} does not match axes {tuple(axis_names)}")
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devs]
    return Mesh(
        devices=_object_array(devs, axis_sizes),
        axis_names=tuple(axis_names),
        streams=_object_array(streams, axis_sizes),
    )


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a nest of dataclasses, named tuples,
    tuples, lists and dicts; anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def to_device(tree, device):
    """``tree`` with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def lane_slices(n: int, n_lanes: int) -> list:
    """Contiguous, near-equal ``slice`` per lane over ``n`` items, as
    ``torch.tensor_split`` cuts them (the first ``n % n_lanes`` lanes hold
    one more)."""
    base, extra = divmod(n, n_lanes)
    out, lo = [], 0
    for i in range(n_lanes):
        hi = lo + base + (1 if i < extra else 0)
        out.append(slice(lo, hi))
        lo = hi
    return out


def split_batch(tree, mesh: Mesh, axis_name: str = "scene") -> list:
    """Cut a tree whose tensors share a leading batch axis into one
    contiguous slice per lane of ``axis_name`` (a 1-D mesh), each moved to
    its lane's device.  Returns the list of per-lane trees, in lane order.
    The counterpart of the reference's ``shard_batch``, which places the
    tree as one array sharded over the axis; a lane here holds its slice."""
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"split_batch wants a 1-D {axis_name!r} mesh, got {mesh.axis_names}")
    lanes = mesh.lanes()
    sizes = set()
    tree_map(lambda t: sizes.add(t.shape[0]) or t, tree)
    if len(sizes) != 1:
        raise ValueError(f"leading axes differ: {sorted(sizes)}")
    cuts = lane_slices(sizes.pop(), len(lanes))
    return [tree_map(lambda t: t[cut].to(lane.device), tree) for lane, cut in zip(lanes, cuts)]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per lane, on the lane's device (lanes of one
    device share the copy)."""
    copies = {}
    out = []
    for lane in mesh.lanes():
        if lane.device not in copies:
            copies[lane.device] = to_device(tree, lane.device)
        out.append(copies[lane.device])
    return out


def map_lanes(lanes: Sequence[Lane], fn: Callable, items: Sequence) -> list:
    """``[fn(lane, item) for lane, item in zip(lanes, items)]`` with each
    call made inside its lane (``Lane.activate``), one after the other: the
    lanes' work overlaps on the device (each lane has its stream), not on the
    host.  Every lane first waits for what the caller's stream has queued,
    and the caller's stream waits for every lane afterwards, also when a
    call raises."""
    lanes, items = list(lanes), list(items)
    if len(items) > len(lanes):
        raise ValueError(f"{len(items)} items for {len(lanes)} lanes")
    lanes = lanes[: len(items)]
    cuda_lanes = [lane for lane in lanes if lane.stream is not None]
    callers = {}
    for lane in cuda_lanes:
        caller = callers.setdefault(lane.device, torch.cuda.current_stream(lane.device))
        lane.stream.wait_stream(caller)
    try:
        out = []
        for lane, item in zip(lanes, items):
            with lane.activate():
                out.append(fn(lane, item))
        return out
    finally:
        for lane in cuda_lanes:
            callers[lane.device].wait_stream(lane.stream)
