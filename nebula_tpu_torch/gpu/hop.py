"""The single-device N-hop loop (Queue B K7): GO's and MATCH's.

Port of `nebula_tpu/tpu/hop.py:_build_local_fn` (:463) in both its modes:
GO's final-hop capture and MATCH's every-hop capture (`capture_hops`,
:522-575).  The reference is one jitted XLA program per bucket
configuration; here it is a host loop over the hand-written kernels of
`gpu/kernels.py`.  In GO's mode:

  per hop:             on a degree-split snapshot, extend_hubs (K8) fills
                       the H hub columns of the (P, vmax + H) frontier
                       buffer from the hub bits in the first vmax columns;
  per hop, per block:  expand (K1) the frontier bitmap through the block's
                       CSR (hub rows included) — its slot arrays are sized
                       exactly from the block's degree scan, so there is
                       no overflow and no escalation ladder; on a block
                       with a delta plane (never degree-split) they are
                       Dcap columns wider, and merge_delta (K9) masks the
                       tombstoned base slots (dst = -1) and appends the
                       frontier-active delta rows in that tail
                       (hop.py:478-497);
  every hop but the last: mark (K2) the valid destinations into the first
                       vmax columns of the one next-frontier buffer (that
                       tensor is the OR over blocks and source parts — the
                       reference's single-device exchange);
  the last hop:        predicate_mask (K4) runs the WHERE program over the
                       valid slots, gathering its columns at eidx itself
                       (a delta slot's from the column's delta half), then
                       compact_capture (K3 + K5) moves the kept slots and
                       their YIELD columns to the front of each part's row
                       (reading keep only below each row's valid total).

Query lanes (Queue B K10, nebula_tpu/tpu/hop.py:619
`build_traverse_fn_lanes`, the reference's hop program vmapped over a
leading lane axis with the CSR shared): `run_hops` also takes an (L, P,
vmax + H) stack of L statements' frontiers (`new_frontier(dev, lanes=L)`)
and runs the same loop once for all of them — each kernel launch covers
every lane, the CSR, prop and delta tensors are shared, and each lane's
results are those of its solo run.  expand's one read per hop and block
is then the max slot count over every lane: the lanes share the slot
width.  The delta merge runs per lane (a delta row's activity depends on
that lane's frontier) inside merge_delta's one launch.

As in the reference, the predicate applies to the final hop only (GO's
WHERE filters the edges it yields), hop_edges counts the pre-filter
expansion of each hop — with a delta plane, the base slots of frontier
rows, tombstoned ones included, plus the active delta rows — and
frontier_sizes counts the ownership bitmap without the hub columns
(hop.py:511).

MATCH's mode (`capture_hops=True`, the reference's hop.py:522 `want_pred
= pred is not None and (last or capture_hops)`): the predicate and the
compaction run at EVERY hop (a MATCH edge pattern's filter holds over
the whole variable-length expansion), every hop's kept slots are
captured, and the next frontier marks only the kept dsts — mark gets the
predicate's mask as its keep (hop.py:552-553).  No yield column is
gathered.  Each hop's capture keeps its own exact width, where the
reference stacks them at one uniform bucket (`_norm_ebs`, :258-267):
the frames do not depend on it, only e_cap does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from .device import DeviceBlock, DeviceSnapshot
from .exprjit import Program
from .kernels import compact_capture, expand, extend_hubs, mark, \
    merge_delta, predicate_mask


def new_frontier(dev: DeviceSnapshot,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """A zero (P, vmax + H) frontier buffer — or an (L, P, vmax + H)
    stack of L lanes' buffers; the first vmax columns of each are the
    (P, vmax) ownership bitmap that mark writes."""
    lead = () if lanes is None else (int(lanes),)
    return torch.zeros(lead + (dev.num_parts, dev.vmax + dev.num_hubs),
                       dtype=torch.bool, device=dev.device)


def expand_merged(b: DeviceBlock, fbm: torch.Tensor, hub_dense=None,
                  dl: Optional[Dict[str, Any]] = None):
    """expand (K1) one block from the frontier buffer (or lane stack),
    then, when the block has a delta plane `dl` (its d_* tensors),
    merge_delta (K9).  Returns (src, dst, rank, eidx, valid, total):
    valid is the merged (P, EB + Dcap) mask (with the lane axis), or
    None when the valid slots are each row's prefix below total."""
    dcap = 0 if dl is None else dl["d_src"].shape[1]
    src, dst, rk, eidx, total = expand(b.indptr, b.nbr, b.rank, fbm,
                                       hub_dense, extra=dcap)
    if dl is None:
        return src, dst, rk, eidx, None, total
    # a delta snapshot is never degree-split: fbm is the (P, vmax) bitmap
    valid, total = merge_delta(
        src, dst, rk, eidx, total, fbm, dl["d_src"], dl["d_dst"],
        dl["d_rank"], dl["d_valid"], dl["d_tomb"], b.nbr.shape[1])
    return src, dst, rk, eidx, valid, total


def run_hops(dev: DeviceSnapshot, blocks: Sequence[DeviceBlock],
             frontier: torch.Tensor, steps: int,
             pred: Optional[Program] = None, capture: bool = True,
             yield_cols: Sequence[str] = (),
             deltas: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
             capture_hops: bool = False) -> Dict[str, Any]:
    """Run a `steps`-hop GO — or with capture_hops, MATCH's every-hop
    expansion — from the seed frontier buffer (`new_frontier` with the
    seeds marked into its first vmax columns), or from an (L, P, vmax +
    H) lane stack of L statements' seed buffers.  `deltas`: per
    block, its delta plane's tensors (d_src, d_dst, d_rank, d_valid,
    d_tomb and d_props {name: (P, Dcap)}) or None.

    Returns, all on the device (every per-statement leaf with a leading
    L when the frontier has lanes):
      hop_edges (P, steps) int32: pre-filter expansion size per hop/part
      frontier_sizes (P, steps) int32: popcount entering each hop
      e_cap: per-hop slot width (max over blocks, and lanes, of
        max(total)) — ints
      cap (if capture): one dict per block of (P, EB) arrays src, dst,
        rank, eidx, prop:<name> per yield col (kept slots compacted to a
        prefix: base slots, then delta slots) and kcount (P,) int32;
        with capture_hops, one such list per hop (no yield columns),
        each hop at its own width
    """
    P, vmax, H = dev.num_parts, dev.vmax, dev.num_hubs
    lead = tuple(frontier.shape[:-1])         # (P,) or (L, P)
    deltas = list(deltas) if deltas is not None else [None] * len(blocks)
    fbm = frontier
    hop_edges: List[torch.Tensor] = []
    frontier_sizes: List[torch.Tensor] = []
    e_cap: List[int] = []
    hop_caps: List[List[Dict[str, torch.Tensor]]] = []
    for hop in range(steps):
        frontier_sizes.append(fbm[..., :vmax].sum(-1, dtype=torch.int32))
        if H:
            extend_hubs(fbm, dev.hub_owner, dev.hub_local, vmax)
        last = hop == steps - 1
        captured = capture and (last or capture_hops)
        nxt = None if last else torch.zeros_like(fbm)
        edges = torch.zeros(lead, dtype=torch.int32, device=fbm.device)
        width = 0
        caps: List[Dict[str, torch.Tensor]] = []
        for b, dl in zip(blocks, deltas):
            src, dst, rk, eidx, valid, total = expand_merged(
                b, fbm, dev.hub_dense, dl)
            edges += total
            width = max(width, src.shape[-1])
            keep = None
            if pred is not None and (last or capture_hops):
                keep = predicate_mask(
                    pred, src, dst, rk, eidx,
                    valid if valid is not None else total,
                    [b.props[n] for n in pred.columns],
                    None if dl is None
                    else [dl["d_props"][n] for n in pred.columns])
            if not last:
                # without a predicate every valid slot is kept, and the
                # invalid ones — expand's padding, the merge's tombstoned
                # and inactive slots — have dst = -1
                mark(dst, P, vmax, keep=keep, out=nxt[..., :vmax])
            if not captured:
                continue
            if keep is None:
                keep = valid if valid is not None else (
                    torch.arange(src.shape[-1], dtype=torch.int32,
                                 device=fbm.device) < total[..., None])
            ycols = () if capture_hops else yield_cols
            cs, cd, cr, ce, props, kc = compact_capture(
                src, dst, rk, eidx, keep, [b.props[n] for n in ycols],
                None if dl is None
                else [dl["d_props"][n] for n in ycols],
                extent=total if valid is None else None)
            cap = {"src": cs, "dst": cd, "rank": cr, "eidx": ce,
                   "kcount": kc}
            cap.update({"prop:" + n: c for n, c in zip(ycols, props)})
            caps.append(cap)
        if captured:
            hop_caps.append(caps)
        hop_edges.append(edges)
        e_cap.append(width)
        fbm = nxt
    res: Dict[str, Any] = {
        "hop_edges": torch.stack(hop_edges, -1),
        "frontier_sizes": torch.stack(frontier_sizes, -1),
        "e_cap": e_cap,
    }
    if capture:
        res["cap"] = hop_caps if capture_hops else hop_caps[-1]
    return res
