"""The BFS level bodies: top-down and bottom-up frontier steps.

Port of the single-device half of `nebula_tpu/algo/frontier.py`:

  * `expand_part`    — one block's expansion (K1), merged with its
                       delta plane (K9) top-down (:57-66), with the WHERE
                       mask (K4) folded into `keep`, including the
                       bottom-up endpoint swap (:39);
  * `top_down_step`  — expand every block from the frontier buffer and
                       OR the kept destinations into one candidate bitmap
                       (K2) — the reference's OR over blocks and parts
                       (:82);
  * `bottom_up_step` — expand every REVERSE block from the unvisited
                       buffer; an unvisited vertex becomes a candidate
                       when an in-neighbour is on the frontier
                       (`bfs_probe`, :110).

  * `sharded_level_step` — the mesh's level body (:145): `top_down_step`
                       for one shard slot, from its own (1, 1, vmax + H)
                       frontier buffer with its part's ids, into its
                       (1, P, vmax) mark matrix, row d bound for slot d
                       (gpu/bfs.py ships it).

The reference vmaps each over the parts; the port's kernels take all P
parts in one launch.  Each step marks its candidates into the caller's
bitmap in place and returns (edges (P,) int32, width): edges is the
pre-filter slot count per part (the level's hop_edges), width the
level's slot width (the largest block's EB).  The reference's
`ovf` has no counterpart: `expand` sizes its slots exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..gpu.device import DeviceBlock
from ..gpu.exprjit import Program
from ..gpu.hop import expand_merged
from ..gpu.kernels import bfs_probe, mark, predicate_mask

__all__ = ["expand_part", "top_down_step", "bottom_up_step",
           "sharded_level_step"]


def expand_part(block: DeviceBlock, fbm: torch.Tensor,
                hub_dense: Optional[torch.Tensor] = None,
                pred: Optional[Program] = None, swap_ends: bool = False,
                delta: Optional[Dict[str, Any]] = None, parts=None,
                pid: int = 0, owners=None):
    """Expand one block from the (P, rows) bitmap `fbm` (rows = vmax, or
    vmax + H on a degree-split snapshot: each hub's bit read from its
    owner's row through `owners`, the (hub_owner, hub_local) tables, or
    on a shard slot, with none, from the hub columns the mesh filled)
    for every part, and apply the compiled edge predicate.

    `swap_ends` is the bottom-up contract: $^/$$ are TRAVERSAL source
    and destination, and bottom-up expands the REVERSE adjacency, so the
    expansion source is the traversal destination (the vertex to reach)
    and the neighbour is the frontier side: the predicate sees the two
    endpoint columns swapped.

    `delta` (the block's delta plane tensors) is merged top-down only:
    the runtime turns bottom-up off while a plane is armed, since the
    reverse adjacency's delta rows would need the swapped endpoints the
    merge does not model.

    `parts` and `pid`: a shard slot's part count and part (see
    `kernels.expand`).  `owners`: see `gpu.hop.expand_merged`.

    Returns (src, dst, keep, total) per `kernels.expand`'s slot contract;
    keep is the predicate's (P, EB) mask (valid slots only), the merged
    valid mask without a predicate, or None without either, meaning
    every slot below total."""
    dl = None if swap_ends else delta
    src, dst, rk, eidx, valid, total = expand_merged(block, fbm, hub_dense,
                                                     dl, parts, pid, owners)
    keep = valid
    if pred is not None:
        ps, pd = (dst, src) if swap_ends else (src, dst)
        keep = predicate_mask(
            pred, ps, pd, rk, eidx, valid if valid is not None else total,
            [block.props[n] for n in pred.columns],
            None if dl is None else [dl["d_props"][n]
                                     for n in pred.columns])
    return src, dst, keep, total


def top_down_step(blocks: Sequence[DeviceBlock], efbm: torch.Tensor,
                  cand: torch.Tensor, hub_dense=None, pred=None,
                  deltas: Optional[Sequence[Optional[Dict[str, Any]]]]
                  = None, pid: int = 0, owners=None
                  ) -> Tuple[torch.Tensor, int]:
    """Forward level body: expand every block from the frontier buffer
    `efbm` (hub bits through `owners`, or a shard slot's hub columns
    filled by the caller), merged with its delta
    plane (`deltas`, per block, or None), and mark each kept destination
    into the (P, vmax) candidate bitmap `cand` (zeroed by the caller; it
    may be the first vmax columns of a wider buffer).  On a mesh, `efbm`
    is one shard slot's (1, 1, vmax + H) buffer, `pid` its part, and
    `cand` its (1, P, vmax) mark matrix: row d holds the candidates owned
    by slot d.

    -> (edges (P,) int32, or (1, 1) for a slot; width)."""
    P, vmax = cand.shape[-2:]
    edges = torch.zeros(efbm.shape[:-1], dtype=torch.int32,
                        device=cand.device)
    width = 0
    for b, dl in zip(blocks, deltas or [None] * len(blocks)):
        _s, dst, keep, total = expand_part(b, efbm, hub_dense, pred,
                                           delta=dl, parts=P, pid=pid,
                                           owners=owners)
        edges += total
        width = max(width, dst.shape[-1])
        # without a predicate every valid slot is kept, and expand and
        # merge_delta give the invalid ones dst = -1, which mark drops
        mark(dst, P, vmax, keep=keep, out=cand)
    return edges, width


def bottom_up_step(rev_blocks: Sequence[DeviceBlock], fbm: torch.Tensor,
                   eunvis: torch.Tensor, cand: torch.Tensor,
                   hub_dense=None, pred=None, fbits=None, owners=None
                   ) -> Tuple[torch.Tensor, int]:
    """Direction-optimizing level body: expand the REVERSE adjacency of
    the unvisited vertices (`eunvis`, each hub's bit read from its
    owner's row through `owners`);
    a vertex joins `cand` when an in-neighbour's bit is set in the
    (P, vmax) frontier bitmap `fbm`, read from `fbits`, its (P, W) int32
    words (bfs_level's fbits_out; required on the card).  A degree-split
    hub row's vertex is owned by another part, so `bfs_probe` routes
    every reached vertex to its owner row.

    -> (edges (P,) int32, width)."""
    P, vmax = cand.shape
    edges = torch.zeros((P,), dtype=torch.int32, device=cand.device)
    width = 0
    for b in rev_blocks:
        src, nb, keep, total = expand_part(b, eunvis, hub_dense, pred,
                                           swap_ends=True, owners=owners)
        edges += total
        width = max(width, src.shape[1])
        bfs_probe(src, nb, keep, total, fbm, cand, fbits)
    return edges, width


def sharded_level_step(blocks: Sequence[DeviceBlock], efbm: torch.Tensor,
                       marks: torch.Tensor, pid: int, hub_dense=None,
                       pred=None,
                       deltas: Optional[Sequence[Optional[Dict[str, Any]]]]
                       = None) -> Tuple[torch.Tensor, int]:
    """The mesh's level body for the shard slot of part `pid` (the
    reference's `sharded_level_step`, frontier.py:145): `top_down_step`
    on the slot's buffer and (1, P, vmax) mark matrix `marks`."""
    return top_down_step(blocks, efbm, marks, hub_dense, pred, deltas, pid)
