"""The single-device N-hop GO loop (Queue B K7).

Port of `nebula_tpu/tpu/hop.py:_build_local_fn` (:463) in its GO final-hop
capture mode.  The reference is one jitted XLA program per bucket
configuration; here it is a host loop over the hand-written kernels of
`gpu/kernels.py`:

  per hop, per block:  expand (K1) the frontier bitmap through the block's
                       CSR — its slot arrays are sized exactly from the
                       block's degree scan, so there is no overflow and no
                       escalation ladder;
  every hop but the last: mark (K2) the valid destinations into the one
                       (P, vmax) next-frontier bitmap (that tensor is the
                       OR over blocks and source parts — the reference's
                       single-device exchange);
  the last hop:        apply the WHERE mask (K4, torch elementwise ops
                       over the gathered prop columns), then
                       compact_capture (K3 + K5) the kept slots and their
                       YIELD columns to the front of each part's row.

As in the reference, the predicate applies to the final hop only (GO's
WHERE filters the edges it yields), and hop_edges counts the pre-filter
expansion of each hop.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .device import DeviceBlock
from .kernels import compact_capture, expand, mark


def _pred_columns(b: DeviceBlock, pred_cols: Sequence[str], src, dst, rk,
                  eidx) -> Dict[str, torch.Tensor]:
    """The columns the compiled predicate reads, one value per slot.
    Padding slots carry eidx 0, so every gather stays in range."""
    cols: Dict[str, torch.Tensor] = {"_rank": rk.long(), "_src": src,
                                      "_dst": dst}
    el = None
    for name in pred_cols:
        if not name.startswith("_"):
            el = eidx.long() if el is None else el
            cols[name] = torch.gather(b.props[name], 1, el)
    return cols


def run_hops(blocks: Sequence[DeviceBlock], frontier: torch.Tensor,
             steps: int,
             pred: Optional[Callable[[Dict[str, Any]], Any]] = None,
             pred_cols: Sequence[str] = (), capture: bool = True,
             yield_cols: Sequence[str] = ()) -> Dict[str, Any]:
    """Run a `steps`-hop GO from the (P, vmax) bool seed bitmap.

    Returns, all on the device:
      hop_edges (P, steps) int32: pre-filter expansion size per hop/part
      frontier_sizes (P, steps) int32: popcount entering each hop
      e_cap: per-hop slot width (max over blocks of max(total)) — ints
      cap (if capture): one dict per block of (P, EB) arrays src, dst,
        rank, eidx, prop:<name> per yield col (kept slots compacted to a
        prefix) and kcount (P,) int32
    """
    P, vmax = frontier.shape
    fbm = frontier
    hop_edges: List[torch.Tensor] = []
    frontier_sizes: List[torch.Tensor] = []
    e_cap: List[int] = []
    caps: List[Dict[str, torch.Tensor]] = []
    for hop in range(steps):
        frontier_sizes.append(fbm.sum(1, dtype=torch.int32))
        last = hop == steps - 1
        nxt = None if last else torch.zeros_like(fbm)
        edges = torch.zeros((P,), dtype=torch.int32, device=fbm.device)
        width = 0
        for b in blocks:
            src, dst, rk, eidx, total = expand(b.indptr, b.nbr, b.rank, fbm)
            edges += total
            width = max(width, src.shape[1])
            if not last:
                # no predicate before the final hop: every valid slot is
                # kept, and expand pads the invalid ones with dst = -1
                mark(dst, P, vmax, out=nxt)
                continue
            if not capture:
                continue
            EB = src.shape[1]
            keep = (torch.arange(EB, dtype=torch.int32, device=fbm.device)
                    < total[:, None])
            if pred is not None:
                keep &= pred(_pred_columns(b, pred_cols, src, dst, rk, eidx))
            cs, cd, cr, ce, props, kc = compact_capture(
                src, dst, rk, eidx, keep, [b.props[n] for n in yield_cols])
            cap = {"src": cs, "dst": cd, "rank": cr, "eidx": ce,
                   "kcount": kc}
            cap.update({"prop:" + n: c for n, c in zip(yield_cols, props)})
            caps.append(cap)
        hop_edges.append(edges)
        e_cap.append(width)
        fbm = nxt
    res: Dict[str, Any] = {
        "hop_edges": torch.stack(hop_edges, 1),
        "frontier_sizes": torch.stack(frontier_sizes, 1),
        "e_cap": e_cap,
    }
    if capture:
        res["cap"] = caps
    return res
