"""Pinning a CsrSnapshot into device memory.

Port of `nebula_tpu/tpu/device.py` for one device: every partition of
every block is resident on the one `torch.device` as a (P, ...) tensor
stack, so the per-hop exchange of the reference's mesh becomes writes
into one shared (P, vmax) bitmap.  There is no mesh and no sharding.

The delta plane (`DeviceDelta`, `put_delta_blocks`, the reference's
device.py:178/319) keeps each block's padded insert rows and sorted
tombstones on the device beside the immutable base arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..graphstore.csr import CsrSnapshot, StringPool
from ..graphstore.schema import PropType


class GpuUnavailable(Exception):
    """The device plane cannot serve this space or configuration."""


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
class DeviceDelta:
    """Device-resident delta-CSR buffers for one pinned snapshot: per
    (etype, direction) block, the padded insert rows and the sorted
    tombstoned base edge indices, re-put whole per apply (small: (P,
    Dcap) and (P, Tcap)).  `host` is the numpy mirror
    (graphstore.delta.HostDelta) the arrays are rebuilt from."""
    host: Any
    # bk → {"d_src", "d_dst", "d_rank", "d_valid", "d_tomb": tensors,
    #        "d_props": {name: tensor},
    #        "np": the numpy block_arrays dict these were put from}
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

    def _leaves(self):
        for arrs in self.blocks.values():
            for k, v in arrs.items():
                if k == "d_props":
                    yield from v.values()
                elif k != "np":
                    yield v


@dataclass
class DeviceSnapshot:
    """Epoch-tagged device-resident copy of one space."""
    space: str
    epoch: int
    num_parts: int
    vmax: int
    device: torch.device
    num_vertices: torch.Tensor        # (P,) i32
    blocks: Dict[Tuple[str, str], DeviceBlock] = field(default_factory=dict)
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

    @property
    def num_hubs(self) -> int:
        return 0 if self.hub_dense is None else int(self.hub_dense.numel())

    def _leaves(self):
        yield self.num_vertices
        if self.hub_dense is not None:
            yield self.hub_dense
            yield self.hub_owner
            yield self.hub_local
        for b in self.blocks.values():
            yield b.indptr
            yield b.nbr
            yield b.rank
            yield from b.props.values()
        if self.delta is not None:
            yield from self.delta._leaves()

    def hbm_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._leaves())


def pin_snapshot(snap: CsrSnapshot, device: torch.device) -> DeviceSnapshot:
    """Copy every snapshot array to `device` (contiguous, same dtypes;
    the hub tables as int32, which the caller's P*vmax check bounds)."""

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = DeviceSnapshot(space=snap.space, epoch=snap.epoch,
                         num_parts=snap.num_parts, vmax=snap.vmax,
                         device=device, num_vertices=put(snap.num_vertices),
                         pool=snap.pool, host=snap)
    hubs = snap.hub_dense
    if hubs is not None and len(hubs):
        hubs = np.asarray(hubs, np.int64)
        if hubs.min() < 0 or hubs.max() >= snap.num_parts * snap.vmax:
            raise GpuUnavailable("hub_dense holds ids outside [0, P*vmax)")
        P = snap.num_parts
        dev.hub_dense = put(hubs.astype(np.int32))
        dev.hub_owner = put((hubs % P).astype(np.int32))
        dev.hub_local = put((hubs // P).astype(np.int32))
    for key, b in snap.blocks.items():
        dev.blocks[key] = DeviceBlock(
            etype=b.etype, direction=b.direction,
            indptr=put(b.indptr), nbr=put(b.nbr), rank=put(b.rank),
            props={k: put(v) for k, v in b.props.items()},
            prop_types=dict(b.prop_types))
    return dev


def put_delta_blocks(dev: DeviceSnapshot, host_delta,
                     block_keys=None) -> int:
    """(Re-)place the delta buffers of `block_keys` (None = all blocks)
    of a pinned snapshot from the mirror `host_delta`; returns the bytes
    uploaded.  Copy-on-write: every block gets new tensors in a new
    blocks dict, published with a new (epoch, blocks) view, so tensors a
    grabbed view holds are never written."""
    if dev.delta is None:
        dev.delta = DeviceDelta(host=host_delta, applied_epoch=dev.epoch)
    dd = dev.delta

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev.device)

    keys = list(dev.blocks if block_keys is None else block_keys)
    new_blocks = dict(dd.blocks)
    moved = 0
    for bk in keys:
        arrs = host_delta.block_arrays(bk)
        placed: Dict[str, Any] = {"np": arrs}
        for k, v in arrs.items():
            if k == "d_props":
                placed[k] = {n: put(a) for n, a in v.items()}
                moved += sum(a.nbytes for a in v.values())
            else:
                placed[k] = put(v)
                moved += v.nbytes
        new_blocks[bk] = placed
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
