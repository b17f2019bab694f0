"""Pinning a CsrSnapshot into device memory, whole or over a mesh.

Port of `nebula_tpu/tpu/device.py`.  In local mode (a 1-slot mesh, or a
runtime given one `device`) every partition of every block is resident
on the one `torch.device` as a (P, ...) tensor stack, so the per-hop
exchange of the reference's mesh becomes writes into one shared (P,
vmax) bitmap (`pin_snapshot`).

On a P-slot mesh (`make_mesh`, gpu/mesh.py) a snapshot with P parts is
pinned slot by slot (`pin_sharded`, the sharded branch of the
reference's `make_putter`, :299-313): slot p holds only part p's rows —
indptr, nbr, rank and props as (1, ...) tensors, and its delta rows when
the plane is armed — plus the (H,) hub tables, on its own device.
`shard_hbm_bytes` gives each slot's bytes (:255).  A part count that
differs from the mesh raises GpuUnavailable (:315).

Every tag table is pinned too (`DeviceTag`, the reference's device.py:170,
put at :376): `present` and each prop column as (P, vmax) tensors, or
part p's (1, vmax) rows on slot p.  Nothing on the device reads them
(the vertex masks read the host mirror, `snap.tags`), but they are
counted wherever the reference counts them: `hbm_bytes`,
`shard_hbm_bytes`, `pin_bytes` and so the memory budget.

The delta plane (`DeviceDelta`, `put_delta_blocks`, the reference's
device.py:178/319) keeps each block's padded insert rows and sorted
tombstones on the device beside the immutable base arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphstore.csr import CsrSnapshot, StringPool
from ..graphstore.schema import PropType
from .exprjit import CannotCompile
from .mesh import InProcess, Mesh


class GpuUnavailable(Exception):
    """The device plane cannot serve this space or configuration."""


class MeshLayoutRefused(GpuUnavailable, CannotCompile):
    """A snapshot whose part count differs from the mesh's slots: the
    device plane cannot serve it (`GpuUnavailable`), and a fused GO
    over it is a statement the device cannot express (`CannotCompile`),
    so its executor takes the host path."""


class SnapshotRetired(GpuUnavailable):
    """A dispatch found its snapshot replaced by a concurrent pin (a
    rebuild, or a compaction's swap): the call can run again on the
    snapshot now pinned."""


@dataclass
class DeviceBlock:
    """One (edge type, direction) CSR block resident on the device."""
    etype: str
    direction: str
    indptr: torch.Tensor              # (P, Vmax+H+1) i32
    nbr: torch.Tensor                 # (P, Emax)   i32
    rank: torch.Tensor                # (P, Emax)   i32
    props: Dict[str, torch.Tensor] = field(default_factory=dict)  # (P, Emax)
    prop_types: Dict[str, PropType] = field(default_factory=dict)


@dataclass
class DeviceTag:
    """One tag table resident on the device: `present` (P, Vmax) bool
    and each prop column (P, Vmax), or one part's (1, Vmax) rows on a
    shard slot."""
    tag: str
    present: torch.Tensor
    props: Dict[str, torch.Tensor] = field(default_factory=dict)
    prop_types: Dict[str, PropType] = field(default_factory=dict)


@dataclass
class DeviceDelta:
    """Device-resident delta-CSR buffers for one pinned snapshot: per
    (etype, direction) block, the padded insert rows and the sorted
    tombstoned base edge indices, re-put whole per apply (small: (P,
    Dcap) and (P, Tcap)).  `host` is the numpy mirror
    (graphstore.delta.HostDelta) the arrays are rebuilt from."""
    host: Any
    # bk → {"d_src", "d_dst", "d_rank", "d_valid", "d_tomb": tensors,
    #        "d_props": {name: tensor},
    #        "np": the numpy block_arrays dict these were put from};
    # on a sharded pin the tensors are per slot instead: bk → {"np": ...,
    # "slots": [one such dict of (1, ...) rows a slot]}
    blocks: Dict[Tuple[str, str], Dict[str, Any]] = field(
        default_factory=dict)
    applied_epoch: int = 0            # store epoch the delta covers
    epoch: int = 0                    # bumped per apply
    # (epoch, blocks) published as ONE tuple: an apply REPLACES the blocks
    # dict and its tensors (copy-on-write) and then swaps this tuple in,
    # so a view grabbed before an apply keeps decoding as it was
    view: Tuple[int, Optional[Dict[Tuple[str, str], Dict[str, Any]]]] = \
        (0, None)
    last_put_bytes: int = 0           # bytes the last apply uploaded

    def _leaves(self, slot: Optional[int] = None):
        """Every delta tensor, or on a sharded pin those of slot index
        `slot` (None: every slot's)."""
        for arrs in self.blocks.values():
            dicts = arrs.get("slots", [arrs])
            if slot is not None and "slots" in arrs:
                dicts = [dicts[slot]]
            for d in dicts:
                for k, v in d.items():
                    if k == "d_props":
                        yield from v.values()
                    elif k not in ("np", "slots"):
                        yield v


@dataclass
class DeviceShard:
    """One shard slot's part of a snapshot pinned on a mesh: part
    `part`'s rows of every block and tag table, (1, ...) tensors on
    `device`, and the (H,) hub tables of a degree-split snapshot."""
    part: int
    device: torch.device
    num_vertices: torch.Tensor        # (1,) i32
    blocks: Dict[Tuple[str, str], DeviceBlock] = field(default_factory=dict)
    tags: Dict[str, DeviceTag] = field(default_factory=dict)
    hub_dense: Optional[torch.Tensor] = None
    hub_owner: Optional[torch.Tensor] = None
    hub_local: Optional[torch.Tensor] = None

    @property
    def num_hubs(self) -> int:
        return 0 if self.hub_dense is None else int(self.hub_dense.numel())

    def _leaves(self):
        return _pinned_leaves(self)


def _pinned_leaves(t):
    """The pinned tensors of a snapshot or shard: num_vertices, the hub
    tables, every block's arrays, every tag table's columns."""
    if t.num_vertices is not None:
        yield t.num_vertices
    if t.hub_dense is not None:
        yield t.hub_dense
        yield t.hub_owner
        yield t.hub_local
    for b in t.blocks.values():
        yield b.indptr
        yield b.nbr
        yield b.rank
        yield from b.props.values()
    for tg in t.tags.values():
        yield tg.present
        yield from tg.props.values()


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


@dataclass
class DeviceSnapshot:
    """Epoch-tagged device-resident copy of one space."""
    space: str
    epoch: int
    num_parts: int
    vmax: int
    device: torch.device
    num_vertices: Optional[torch.Tensor]  # (P,) i32; None when sharded
    blocks: Dict[Tuple[str, str], DeviceBlock] = field(default_factory=dict)
    tags: Dict[str, DeviceTag] = field(default_factory=dict)
    pool: StringPool = field(default_factory=StringPool)
    host: Optional[CsrSnapshot] = None   # kept for vid and prop decode
    # degree-split hub tables (the reference's `_hub_consts`, hop.py:271),
    # (H,) int32 each, or None for an unsplit snapshot: hub dense id, its
    # owner part (dense % P) and its owner-local row (dense // P)
    hub_dense: Optional[torch.Tensor] = None
    hub_owner: Optional[torch.Tensor] = None
    hub_local: Optional[torch.Tensor] = None
    # the delta plane; None = off for this pin
    delta: Optional[DeviceDelta] = None
    # set when a pin replaces (or unpin drops) this snapshot: a dispatch
    # that finds it under the runtime's read gate raises GpuUnavailable
    retired: bool = False
    # the `uid` of the store space a pin from a store built it from (None
    # for pin_prebuilt): a snapshot serves only the store it came from
    space_uid: Optional[int] = None
    # a sharded pin: its mesh and one DeviceShard per slot this process
    # holds; the snapshot's own blocks, tags and tensors are then empty
    mesh: Optional[Mesh] = None
    shards: List[DeviceShard] = field(default_factory=list)

    @property
    def num_hubs(self) -> int:
        if self.shards:
            return self.shards[0].num_hubs
        return 0 if self.hub_dense is None else int(self.hub_dense.numel())

    def _leaves(self):
        for sh in self.shards:
            yield from sh._leaves()
        yield from _pinned_leaves(self)
        if self.delta is not None:
            yield from self.delta._leaves()

    def hbm_bytes(self) -> int:
        return _nbytes(self._leaves())

    def shard_hbm_bytes(self) -> Dict[int, int]:
        """Per-slot ledger: the bytes resident for each part this process
        holds (the delta rows included); {0: hbm_bytes()} in local mode.
        The slots sum to hbm_bytes()."""
        if not self.shards:
            return {0: self.hbm_bytes()}
        dd = self.delta
        return {sh.part: _nbytes(sh._leaves()) + (
            0 if dd is None else _nbytes(dd._leaves(i)))
            for i, sh in enumerate(self.shards)}


def make_mesh(n: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """An n-slot in-process mesh laid over `devices` (default: every
    CUDA card; n defaults to their count): slot s on devices[s *
    len(devices) // n], so on one card every slot shares it.  Tests pass
    devices=[torch.device("cpu")] (or [cpu] * n: n entries are n devices
    to the memory budget, as the reference's virtual CPU mesh has).
    Unlike the reference's make_mesh, which raises when n exceeds the
    real devices, several slots may share a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise GpuUnavailable("make_mesh: no CUDA device (pass devices= "
                                 "to lay the slots elsewhere)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = len(devices) if n is None else int(n)
    if n < 1:
        raise ValueError(f"make_mesh: {n} slots")
    homes = [s * len(devices) // n for s in range(n)]
    return Mesh(n, [devices[h] for h in homes], InProcess(), homes=homes)


def mesh_parts(mesh: Mesh) -> int:
    return mesh.size


def mesh_lanes(mesh: Mesh) -> int:
    """Lane-axis size: 1 (the two-axis mesh is not ported)."""
    return 1


def _hub_tables(snap: CsrSnapshot):
    """(dense ids, owner part, owner-local row) as int32 numpy arrays,
    or None for an unsplit snapshot (the caller's P*vmax check bounds
    them)."""
    hubs = snap.hub_dense
    if hubs is None or not len(hubs):
        return None
    hubs = np.asarray(hubs, np.int64)
    if hubs.min() < 0 or hubs.max() >= snap.num_parts * snap.vmax:
        raise GpuUnavailable("hub_dense holds ids outside [0, P*vmax)")
    P = snap.num_parts
    return tuple(a.astype(np.int32) for a in (hubs, hubs % P, hubs // P))


def _put_blocks(snap: CsrSnapshot, put) -> Dict[Tuple[str, str],
                                                DeviceBlock]:
    return {key: DeviceBlock(
        etype=b.etype, direction=b.direction,
        indptr=put(b.indptr), nbr=put(b.nbr), rank=put(b.rank),
        props={k: put(v) for k, v in b.props.items()},
        prop_types=dict(b.prop_types)) for key, b in snap.blocks.items()}


def _put_tags(snap: CsrSnapshot, put) -> Dict[str, DeviceTag]:
    return {name: DeviceTag(
        tag=name, present=put(t.present),
        props={k: put(v) for k, v in t.props.items()},
        prop_types=dict(t.prop_types)) for name, t in snap.tags.items()}


def _putter(device, rows: Optional[int] = None):
    """Copy a numpy array (its row `rows` only, as a (1, ...) array, when
    given) to `device`, contiguous, same dtype.  On the CPU too the
    tensor is a copy, never a view of the host array: a host mirror
    written in place (a delta apply) must not reach the pinned tensors
    except through a put, as on the card."""
    device = torch.device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        if rows is not None:
            a = a[rows:rows + 1]
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.clone() if device.type == "cpu" else t.to(device)
    return put


def pin_snapshot(snap: CsrSnapshot, device: torch.device) -> DeviceSnapshot:
    """Copy every snapshot array to `device` (contiguous, same dtypes;
    the hub tables as int32), the tag tables included."""
    put = _putter(device)
    dev = DeviceSnapshot(space=snap.space, epoch=snap.epoch,
                         num_parts=snap.num_parts, vmax=snap.vmax,
                         device=device, num_vertices=put(snap.num_vertices),
                         pool=snap.pool, host=snap)
    hubs = _hub_tables(snap)
    if hubs is not None:
        dev.hub_dense, dev.hub_owner, dev.hub_local = map(put, hubs)
    dev.blocks = _put_blocks(snap, put)
    dev.tags = _put_tags(snap, put)
    return dev


def _check_mesh_parts(snap: CsrSnapshot, mesh: Mesh) -> None:
    if snap.num_parts != mesh.size:
        raise MeshLayoutRefused(
            f"snapshot has {snap.num_parts} parts but the mesh has "
            f"{mesh.size} slots; create the space with partition_num == "
            f"mesh size to pin it")


def pin_bytes(snap: CsrSnapshot, mesh: Mesh,
              delta_bytes: int = 0) -> Dict[int, int]:
    """What pinning `snap` on `mesh` puts on each slot this process
    holds — the `shard_hbm_bytes()` of that pin — counted from the host
    arrays before anything is put: on a 1-slot mesh the whole snapshot
    (`pin_snapshot`), else part p's rows and the hub tables on slot p
    (`pin_sharded`).  `delta_bytes`: the delta plane armed at pin time,
    every part's rows (each slot holds its 1/P)."""
    hubs = _hub_tables(snap)
    fixed = 0 if hubs is None else sum(a.nbytes for a in hubs)
    arrays = [a for b in snap.blocks.values()
              for a in (b.indptr, b.nbr, b.rank, *b.props.values())]
    arrays += [a for t in snap.tags.values()
               for a in (t.present, *t.props.values())]
    if mesh.size == 1:
        return {mesh.first: np.asarray(snap.num_vertices).nbytes + fixed
                + sum(a.nbytes for a in arrays) + delta_bytes}
    _check_mesh_parts(snap, mesh)
    # a slot's num_vertices is its part's one int32
    return {p: 4 + fixed + sum(a[p].nbytes for a in arrays)
            + delta_bytes // mesh.size for p in mesh.parts}


def pin_sharded(snap: CsrSnapshot, mesh: Mesh) -> DeviceSnapshot:
    """Pin a P-part snapshot on a P-slot mesh, slot by slot: each slot
    this process holds gets only its own part's rows, on its own device,
    and the hub tables.  A part count other than the mesh's raises
    MeshLayoutRefused."""
    _check_mesh_parts(snap, mesh)
    dev = DeviceSnapshot(space=snap.space, epoch=snap.epoch,
                         num_parts=snap.num_parts, vmax=snap.vmax,
                         device=mesh.devices[0], num_vertices=None,
                         pool=snap.pool, host=snap, mesh=mesh)
    hubs = _hub_tables(snap)
    for p, d in zip(mesh.parts, mesh.devices):
        put = _putter(d, rows=p)
        sh = DeviceShard(part=p, device=d, num_vertices=put(
            np.asarray(snap.num_vertices, np.int32)))
        if hubs is not None:
            sh.hub_dense, sh.hub_owner, sh.hub_local = map(_putter(d), hubs)
        sh.blocks = _put_blocks(snap, put)
        sh.tags = _put_tags(snap, put)
        dev.shards.append(sh)
    return dev


def put_delta_blocks(dev: DeviceSnapshot, host_delta,
                     block_keys=None) -> int:
    """(Re-)place the delta buffers of `block_keys` (None = all blocks)
    of a pinned snapshot from the mirror `host_delta`; returns the bytes
    uploaded.  Copy-on-write: every block gets new tensors in a new
    blocks dict, published with a new (epoch, blocks) view, so tensors a
    grabbed view holds are never written.  On a sharded pin each slot
    gets only its own part's rows (the reference's per-part put)."""
    if dev.delta is None:
        dev.delta = DeviceDelta(host=host_delta, applied_epoch=dev.epoch)
    dd = dev.delta

    def place(arrs, put) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        nbytes = 0
        for k, v in arrs.items():
            if k == "d_props":
                out[k] = {n: put(a) for n, a in v.items()}
                nbytes += sum(t.numel() * t.element_size()
                              for t in out[k].values())
            else:
                out[k] = put(v)
                nbytes += out[k].numel() * out[k].element_size()
        return out, nbytes

    keys = list(dev.host.blocks if block_keys is None else block_keys)
    new_blocks = dict(dd.blocks)
    moved = 0
    for bk in keys:
        arrs = host_delta.block_arrays(bk)
        if dev.shards:                 # per-part placement, slot by slot
            slots = []
            for sh in dev.shards:
                d, n = place(arrs, _putter(sh.device, rows=sh.part))
                slots.append(d)
                moved += n
            new_blocks[bk] = {"np": arrs, "slots": slots}
        else:
            d, n = place(arrs, _putter(dev.device))
            new_blocks[bk] = dict(d, np=arrs)
            moved += n
    dd.epoch += 1
    dd.blocks = new_blocks
    dd.view = (dd.epoch, new_blocks)
    dd.last_put_bytes = moved
    return moved


def resolve_device(device: Any = None) -> torch.device:
    """`None` means `cuda:0`.  A CUDA device without CUDA raises
    GpuUnavailable; the CPU runs only when the caller names it."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise GpuUnavailable(f"{dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise GpuUnavailable(f"unsupported device {dev}")
    return dev
