"""Pinning a CsrSnapshot into device memory.

Port of `nebula_tpu/tpu/device.py` for one device: every partition of
every block is resident on the one `torch.device` as a (P, ...) tensor
stack, so the per-hop exchange of the reference's mesh becomes writes
into one shared (P, vmax) bitmap.  There is no mesh and no sharding.
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


def resolve_device(device: Any = None) -> torch.device:
    """`None` means `cuda:0`.  A CUDA device without CUDA raises
    GpuUnavailable; the CPU runs only when the caller names it."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise GpuUnavailable(f"{dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise GpuUnavailable(f"unsupported device {dev}")
    return dev
