"""A data-parallel device mesh and its batch helpers (the JAX package's
``parallel/mesh.py``).

A ``Mesh`` is a 1-D tuple of ``torch.device`` entries on one ``data`` axis.
Serving (``TrackNetPredictor.run_staged(mesh=)``) and rally evaluation
(``RallyTestEngine(mesh=)``) split each chunk's window batch into
``mesh.size`` equal shares (``split_batch``), forward each share on its
entry's device from that device's copy of the staged frames and the folded
weights (``replicate_tree``), and put the shares back in window order on the
mesh's first device (``gather_batch``), where the sequential ensemble and
the decode run. The folded forward has no batch statistics, so nothing is
reduced across entries. One host thread launches the shares in turn; on
separate cards they run at once, since a launch returns before its kernel
ends.

An entry may repeat a device: ``make_mesh(devices=["cuda:0", "cuda:0"])``
stands one card in twice, and ``make_mesh(n, device="cpu")`` holds n entries
of the CPU (the counterpart of the JAX tests' virtual CPU devices). A mesh
that spans processes is not ported; neither are the TPU sandbox's platform
shims.

Data-parallel training (``training/steps.make_tracknet_shares_train_step``)
splits each train batch the same way (``shard_train_batch``), runs each
share on its entry with that entry's copy of the parameters
(``entry_params``: autograd sums the entries' gradients on the master's),
and synchronises every BatchNorm across the shares through
``mesh_reducer``. Several processes (``parallel/processes.py``) each hold a
mesh of one entry.

Resident frames sharded over N holders (the JAX loader's
``frame_sharding="shard"``: the mesh's entries, or the processes of a group)
hold rows ``[j R, (j + 1) R)`` of the split's buffer each, so that a share's
windows need rows that other holders hold. A batch then carries the flat
frame indices of the whole global batch (``FrameShards``), and the exchange
is planned on the host (``FrameShards.exchange``): for each holder j and
receiver i the unique local rows of j's shard that i's windows need, and
for each receiver the order that puts the rows it receives back in window
order. Both gathers run on the ``window_copy`` kernel (P8): the holder's,
from its shard, and the receiver's reorder. The transport between them is,
on a one-process mesh, the copy between the two entries' devices
(``mesh_exchange``: the holder gathers straight into the receiver's buffer
where they share a device, so nothing is copied there), and over a group
one all-to-all (``processes.DeviceGroup.exchange``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.shift_copy import window_copy

DeviceLike = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices on the one ``data`` axis, in shard order."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` as meshes compare it: ``"cuda"`` is the current card, and
    every CPU index is the one CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None,
              *, device: DeviceLike = "cuda") -> Mesh:
    """The first ``num_devices`` of ``devices`` (every entry by default).
    Without ``devices``: the cards ``cuda:0 .. cuda:n-1`` for ``device``
    ``"cuda"``, or ``num_devices`` (default 1) entries of the CPU for
    ``"cpu"``. More devices than there are raise ``ValueError``."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif kind == "cpu":
            devices = [torch.device("cpu")] * max(num_devices or 1, 1)
        else:
            raise ValueError(f"no mesh of {kind} devices: use cuda or cpu")
    else:
        devices = [canonical_device(d) for d in devices]
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be at least 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(f"Requested {num_devices} devices, only {len(devices)} available")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("Requested 1 devices, only 0 available")
    return Mesh(tuple(devices))


def check_mesh(mesh: Mesh, batch_size: int, device: DeviceLike, owner: str) -> None:
    """Raise unless ``mesh`` can shard the window batches of ``owner`` (a
    predictor or an engine on ``device``): a ``Mesh`` whose size divides
    ``batch_size`` and whose first device is ``device``, where the shares
    are gathered."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    if mesh.devices[0] != canonical_device(device):
        raise ValueError(f"the mesh's first device {mesh.devices[0]} is not the {owner}'s "
                         f"{device}")


def device_context(device: torch.device):
    """Make ``device`` the current card inside the block (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor and numpy array of nested dicts, lists and
    tuples (named ones too); other leaves are kept as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def to_device(tree: Any, device: DeviceLike) -> Any:
    """Every tensor of ``tree`` on ``device`` (numpy arrays become tensors);
    a tensor already there is the same tensor, not a copy."""
    return _tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def split_batch(x: Union[torch.Tensor, np.ndarray], n: int) -> List:
    """``x``'s leading axis in ``n`` equal consecutive shares (views)."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} not divisible by mesh size {n}")
    if isinstance(x, np.ndarray):
        return np.split(x, n)
    return list(x.split(x.shape[0] // n))


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """One tree per mesh entry: entry i holds share i of every leaf's
    leading axis, on its device."""
    return [_tree_map(lambda x, i=i: torch.as_tensor(split_batch(x, mesh.size)[i]).to(dev),
                      batch)
            for i, dev in enumerate(mesh.devices)]


def replicate_tree(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` per mesh entry, on its device (``to_device``:
    an entry on the tensors' own device shares them)."""
    return [to_device(tree, dev) for dev in mesh.devices]


def gather_batch(shares: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shares back in order along the leading axis, on the mesh's first
    device."""
    return torch.cat([s.to(mesh.devices[0]) for s in shares])


def pad_batch_to(batch: Any, target: int) -> Any:
    """Pad every leaf's leading axis to ``target`` by repeating the last
    element (so batch sizes stay divisible by the mesh width)."""

    def pad(x):
        n = x.shape[0]
        if n == target:
            return x
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)], axis=0)
        return torch.cat([x, x[-1:].expand((target - n,) + tuple(x.shape[1:]))])

    return _tree_map(pad, batch)


def shard_train_batch(batch: dict, mesh: Mesh) -> List[dict]:
    """One share of a train batch per mesh entry, on its device (tensors
    copied ``non_blocking``, numpy leaves as slices): every leaf's leading
    axis split in ``mesh.size`` consecutive shares (a segmented batch's by
    segments, which keeps each segment's windows in one share), except a
    resident loader's split buffers (``res_*_buf``: one tensor, or a tuple
    with one per entry, whose i-th entry share i takes: the whole split, or
    under ``"shard"`` its entry's shard) and the exchange plan of sharded
    frames (``res_shards``), which every share takes whole."""
    shares: List[dict] = [{} for _ in mesh.devices]
    for k, v in batch.items():
        for i, dev in enumerate(mesh.devices):
            if k == "res_shards":
                shares[i][k] = v
            elif k.startswith("res_") and k.endswith("_buf"):
                shares[i][k] = (v[i] if isinstance(v, (tuple, list)) else v).to(dev)
            else:
                part = split_batch(v, mesh.size)[i]
                shares[i][k] = (part if isinstance(part, np.ndarray)
                                else part.to(dev, non_blocking=True))
    return shares


class Exchange(NamedTuple):
    """The host plan of one exchange of sharded rows: ``send[j][i]``, the
    rows of holder j's shard (local indices, ascending, each once) that
    receiver i takes, in that order; ``order[i]``, for each frame of
    receiver i's windows in window order, its row among the rows i receives
    (holder 0's first, then holder 1's, ...). int32 arrays."""

    send: Tuple[Tuple[np.ndarray, ...], ...]
    order: Tuple[np.ndarray, ...]

    def counts(self, holder: int) -> List[int]:
        """The rows ``holder`` sends to each receiver."""
        return [len(r) for r in self.send[holder]]

    def received(self, receiver: int) -> List[int]:
        """The rows ``receiver`` gets from each holder."""
        return [len(s[receiver]) for s in self.send]


def plan_exchange(idx: np.ndarray, rows: int, holders: int, receivers: int) -> Exchange:
    """The exchange that gives each of ``receivers`` equal consecutive
    shares of the windows ``idx`` (B, L) (flat rows of a buffer of which
    holder j holds rows ``[j * rows, (j + 1) * rows)``) its frames."""
    B = idx.shape[0]
    if B % receivers:
        raise ValueError(f"batch of {B} not divisible by {receivers} receivers")
    send: List[List[np.ndarray]] = [[] for _ in range(holders)]
    order = []
    for part in np.split(np.asarray(idx, np.int64).reshape(B, -1), receivers):
        need, where = np.unique(part.reshape(-1), return_inverse=True)
        if len(need) and (need[0] < 0 or need[-1] >= holders * rows):
            raise IndexError(f"frame rows in [{need[0]}, {need[-1]}] leave the {holders} x "
                             f"{rows} rows of the shards")
        cuts = np.searchsorted(need, np.arange(holders + 1) * rows)
        for j in range(holders):
            send[j].append((need[cuts[j]:cuts[j + 1]] - j * rows).astype(np.int32))
        order.append(where.reshape(-1).astype(np.int32))
    return Exchange(tuple(tuple(s) for s in send), tuple(order))


class FrameShards(NamedTuple):
    """What a batch of resident frames sharded over ``holders`` carries
    (``res_shards``): ``idx`` (B, L), the flat frame rows of the whole
    global batch's windows, and ``rows``, the rows of the (padded) buffer
    that each holder holds."""

    idx: np.ndarray
    rows: int
    holders: int

    def exchange(self, receivers: int) -> Exchange:
        """The plan that gives each of ``receivers`` equal shares of the
        global batch its windows' frames (``plan_exchange``)."""
        return plan_exchange(self.idx, self.rows, self.holders, receivers)


def upload_indices(arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """The int32 ``arrays`` as contiguous tensors on ``device``, through one
    host-to-device copy (from pinned memory to a card, ``non_blocking``)."""
    if not arrays:
        return []
    flat = torch.from_numpy(np.concatenate([np.asarray(a, np.int32) for a in arrays]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        out.append(flat[at:at + len(a)])
        at += len(a)
    return out


def mesh_exchange(shards: Sequence[torch.Tensor], ex: Exchange,
                  devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each receiver's frames in window order on ``devices[i]`` (its
    ``len(ex.order[i])`` rows of a shard's row shape), from the ``shards``
    of a one-process mesh: holder j gathers the rows receiver i takes with
    ``window_copy`` on its shard's device, straight into i's buffer where
    the two share a device, else into its own, which is then copied to i's
    device (between two cards a peer copy, ordered after the gather and
    before the reorder on both cards' current streams); receiver i then puts
    its rows in window order with one more ``window_copy``."""
    frame = tuple(shards[0].shape[1:])
    index: dict = {}
    for dev in dict.fromkeys([s.device for s in shards] + list(devices)):
        want = [(("send", j, i), ex.send[j][i]) for j, s in enumerate(shards) if s.device == dev
                for i in range(len(devices))]
        want += [(("order", i), ex.order[i]) for i, d in enumerate(devices) if d == dev]
        index.update(zip([k for k, _ in want], upload_indices([a for _, a in want], dev)))
    out = []
    for i, dev in enumerate(devices):
        got = torch.empty((sum(ex.received(i)),) + frame, dtype=shards[0].dtype, device=dev)
        at = 0
        for j, shard in enumerate(shards):
            rows = index["send", j, i]
            n = len(rows)
            if n == 0:
                continue
            if shard.device == dev:
                window_copy(shard, rows, 1, out=got[at:at + n].unsqueeze(1))
            else:
                got[at:at + n].copy_(window_copy(shard, rows, 1)[:, 0])
            at += n
        out.append(window_copy(got, index["order", i], 1)[:, 0])
    return out


def entry_params(module: torch.nn.Module, mesh: Mesh) -> List[dict]:
    """Per mesh entry, ``module``'s parameters by name on the entry's device,
    made inside autograd: a parameter already on that device is itself, any
    other a copy through which the entry's gradient flows back, so that
    autograd sums every entry's gradient on the master's."""
    params = dict(module.named_parameters())
    return [{k: p.to(dev) for k, p in params.items()} for dev in mesh.devices]


class Reducer(NamedTuple):
    """How the synchronised BatchNorm (``ops/batchnorm.py``) adds up the
    shares' (2, C) float64 sums: ``sum(parts)`` returns, for each share of
    this process, the sum over every share of the global batch on that
    share's device; ``processes`` is the number of processes whose shares
    take part (the global row count is this process's times it, the shares
    being equal)."""

    sum: Callable[[List[torch.Tensor]], List[torch.Tensor]]
    processes: int = 1


def mesh_reducer(mesh: Mesh) -> Reducer:
    """The shares' (2, C) BatchNorm sums added up in share order on the
    mesh's first entry, the total copied back to each entry's device."""

    def total(parts: List[torch.Tensor]) -> List[torch.Tensor]:
        first = parts[0]
        for p in parts[1:]:
            first = first + p.to(first.device)
        return [first.to(dev) for dev in mesh.devices]

    return Reducer(total)
