"""The single-device N-hop loop (Queue B K7): GO's and MATCH's.

Port of `nebula_tpu/tpu/hop.py:_build_local_fn` (:463) in both its modes:
GO's final-hop capture and MATCH's every-hop capture (`capture_hops`,
:522-575).  The reference is one jitted XLA program per bucket
configuration; here it is a host loop over the hand-written kernels of
`gpu/kernels.py`.  In GO's mode:

  per hop, per block:  expand (K1) the frontier bitmap through the block's
                       CSR (hub rows included: on a degree-split snapshot
                       its scan reads each hub's bit from the owner's row
                       of the (P, vmax + H) frontier buffer, given the
                       snapshot's owner tables — the reference's K8 hub
                       extension, hop.py:303, folded in; the buffer's H
                       tail columns stay unread) — its slot arrays are sized
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

The sharded mesh (Queue B K15-K17; nebula_tpu/tpu/hop.py:179-312, :653):
`run_hops_sharded` runs the same per-block hop (`_hop_block`) in every
shard slot on the slot's own (Ll, 1, vmax + H) frontier and its part's
CSR row, with expand and the merge told the slot's part; each slot marks
into an (Ll, P, vmax) matrix whose row d is bound for slot d, and one
`exchange_marks_lanes` a hop (K15: pack_bits, the transport's
all_to_all, unpack_or) gives every slot its next frontier.  On a
degree-split snapshot `extend_fbm_sharded_lanes` (K16: owned_hub_bits,
the transport's sum, fill_hub_columns) fills each slot's hub columns,
which its expand reads (a slot holds no other part's row to read the
bits from).  The exchange
works a slot group at a time (`Mesh.groups`, the slots that share a
device; on one card, all of them): the frontier buffers, each hop's mark
matrices and next frontiers are one allocation a group with a leading
slot axis, each slot's buffer a view of it, so that each of K15's and
K16's kernels is one launch a group a hop, and the hop's zero fills and
frontier popcount one op a group.  The per-block kernels still run once
a slot.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .device import DeviceBlock, DeviceShard, DeviceSnapshot
from .exprjit import Program
from .kernels import compact_capture, expand, fill_hub_columns, mark, \
    merge_delta, owned_hub_bits, pack_bits, predicate_mask, unpack_or
from .mesh import Mesh


def new_frontier(dev: DeviceSnapshot,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """A zero (P, vmax + H) frontier buffer — or an (L, P, vmax + H)
    stack of L lanes' buffers; the first vmax columns of each are the
    (P, vmax) ownership bitmap that mark writes."""
    lead = () if lanes is None else (int(lanes),)
    return torch.zeros(lead + (dev.num_parts, dev.vmax + dev.num_hubs),
                       dtype=torch.bool, device=dev.device)


def hub_owners(dev: DeviceSnapshot) -> Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """The (hub_owner, hub_local) tables through which a single-device
    expand reads each hub's bit from its owner's row, or None for an
    unsplit snapshot."""
    return (dev.hub_owner, dev.hub_local) if dev.num_hubs else None


def expand_merged(b: DeviceBlock, fbm: torch.Tensor, hub_dense=None,
                  dl: Optional[Dict[str, Any]] = None, parts=None,
                  pid: int = 0, owners=None):
    """expand (K1) one block from the frontier buffer (or lane stack),
    then, when the block has a delta plane `dl` (its d_* tensors),
    merge_delta (K9).  `parts` and `pid`: a shard slot's part count and
    part (see `kernels.expand`).  `owners`: `hub_owners(dev)` on a
    single device (the hub bits read from their owners' rows), None on
    a shard slot (its hub columns filled).  Returns (src, dst, rank,
    eidx, valid, total): valid is the merged (P, EB + Dcap) mask (with
    the lane axis), or None when the valid slots are each row's prefix
    below total."""
    dcap = 0 if dl is None else dl["d_src"].shape[1]
    hub_owner, hub_local = owners if owners is not None else (None, None)
    src, dst, rk, eidx, total = expand(b.indptr, b.nbr, b.rank, fbm,
                                       hub_dense, extra=dcap, parts=parts,
                                       pid=pid, hub_owner=hub_owner,
                                       hub_local=hub_local)
    if dl is None:
        return src, dst, rk, eidx, None, total
    # a delta snapshot is never degree-split: fbm is the (P, vmax) bitmap
    valid, total = merge_delta(
        src, dst, rk, eidx, total, fbm, dl["d_src"], dl["d_dst"],
        dl["d_rank"], dl["d_valid"], dl["d_tomb"], b.nbr.shape[1],
        parts=parts, pid=pid)
    return src, dst, rk, eidx, valid, total


def _hop_block(b: DeviceBlock, dl, fbm: torch.Tensor, hub_dense,
               pred: Optional[Program], want_pred: bool, captured: bool,
               ycols: Sequence[str], mark_out, P: int, vmax: int,
               parts=None, pid: int = 0, owners=None):
    """One hop of one block: expand (merged with its delta plane), the
    WHERE mask where `want_pred`, mark the kept dsts into `mark_out` (a
    (P, vmax) bitmap view or an (L, P, vmax) stack; None on the last hop)
    and, when `captured`, compact the kept slots with the `ycols` yield
    columns.  `owners`: see `expand_merged`.  Returns (total, slot
    width, capture dict or None)."""
    src, dst, rk, eidx, valid, total = expand_merged(b, fbm, hub_dense, dl,
                                                     parts, pid, owners)
    keep = None
    if want_pred:
        keep = predicate_mask(
            pred, src, dst, rk, eidx,
            valid if valid is not None else total,
            [b.props[n] for n in pred.columns],
            None if dl is None else [dl["d_props"][n] for n in pred.columns])
    if mark_out is not None:
        # without a predicate every valid slot is kept, and the invalid
        # ones — expand's padding, the merge's tombstoned and inactive
        # slots — have dst = -1
        mark(dst, P, vmax, keep=keep, out=mark_out)
    if not captured:
        return total, src.shape[-1], None
    if keep is None:
        keep = valid if valid is not None else (
            torch.arange(src.shape[-1], dtype=torch.int32,
                         device=fbm.device) < total[..., None])
    cs, cd, cr, ce, props, kc = compact_capture(
        src, dst, rk, eidx, keep, [b.props[n] for n in ycols],
        None if dl is None else [dl["d_props"][n] for n in ycols],
        extent=total if valid is None else None)
    cap = {"src": cs, "dst": cd, "rank": cr, "eidx": ce, "kcount": kc}
    cap.update({"prop:" + n: c for n, c in zip(ycols, props)})
    return total, src.shape[-1], cap


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
    P, vmax = dev.num_parts, dev.vmax
    owners = hub_owners(dev)
    lead = tuple(frontier.shape[:-1])         # (P,) or (L, P)
    deltas = list(deltas) if deltas is not None else [None] * len(blocks)
    fbm = frontier
    hop_edges: List[torch.Tensor] = []
    frontier_sizes: List[torch.Tensor] = []
    e_cap: List[int] = []
    hop_caps: List[List[Dict[str, torch.Tensor]]] = []
    for hop in range(steps):
        frontier_sizes.append(fbm[..., :vmax].sum(-1, dtype=torch.int32))
        last = hop == steps - 1
        captured = capture and (last or capture_hops)
        nxt = None if last else torch.zeros_like(fbm)
        edges = torch.zeros(lead, dtype=torch.int32, device=fbm.device)
        width = 0
        caps: List[Dict[str, torch.Tensor]] = []
        for b, dl in zip(blocks, deltas):
            total, w, cap = _hop_block(
                b, dl, fbm, dev.hub_dense, pred,
                pred is not None and (last or capture_hops), captured,
                () if capture_hops else yield_cols,
                None if last else nxt[..., :vmax], P, vmax, owners=owners)
            edges += total
            width = max(width, w)
            if cap is not None:
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


# ---------------------------------------------------------------------------
# the sharded mesh (Queue B K15-K17)
# ---------------------------------------------------------------------------


def a2a_payload_bytes(P: int, vmax: int, lanes: int = 1) -> int:
    """Bytes moved by ONE bit-packed frontier exchange over the whole
    mesh (nebula_tpu/tpu/hop.py:227): each of the P slots ships P rows of
    ceil(vmax / 32) 4-byte words a lane.  0 when P == 1: local mode has
    no exchange."""
    if P <= 1:
        return 0
    return int(lanes) * P * P * (-(-int(vmax) // 32)) * 4


def new_slot_frontiers(dev: DeviceSnapshot,
                       lanes: int = 1) -> List[torch.Tensor]:
    """One zero (L, 1, vmax + H) frontier buffer for each slot of a
    sharded pin, on the slot's device: the slot's own row of `new_frontier`
    for each lane.  The slots of a group (`Mesh.groups`) are views of one
    (S, L, 1, vmax + H) allocation, slot s at index s (`slot_groups`
    gives it back)."""
    width = dev.vmax + dev.num_hubs
    bufs: List[torch.Tensor] = []
    for grp in dev.mesh.groups:
        bufs.extend(torch.zeros((len(grp), int(lanes), 1, width),
                                dtype=torch.bool,
                                device=dev.shards[grp.start].device
                                ).unbind(0))
    return bufs


def seed_slot_frontiers(dev: DeviceSnapshot,
                        lane_dense: Sequence[Sequence[int]]
                        ) -> List[torch.Tensor]:
    """The seed build of a sharded pin (the sharded half of the
    reference's seed builder, runtime.py:941-987): each slot's (L, 1,
    vmax + H) buffers (`new_slot_frontiers`) with the seeds it owns —
    dense id d with d % P == its part, at row d // P — marked by one
    `mark` launch a slot for every lane.  `lane_dense`: each lane's seed
    ids, checked to lie in [0, P * vmax) by the caller."""
    P, vmax = dev.num_parts, dev.vmax
    lanes = [torch.as_tensor(list(d), dtype=torch.int64) for d in lane_dense]
    bufs = new_slot_frontiers(dev, lanes=len(lanes))
    for sh, fbm in zip(dev.shards, bufs):
        mine = [d[d % P == sh.part] // P for d in lanes]
        cap = max((len(d) for d in mine), default=0) or 1
        ids = torch.full((len(mine), cap), -1, dtype=torch.int32)
        for i, d in enumerate(mine):
            ids[i, :len(d)] = d
        mark(ids.to(sh.device), 1, vmax, out=fbm[..., :vmax])
    return bufs


def slot_groups(mesh: Mesh, per_slot: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Each slot group's buffer, (S, ...) with slot s at index s, from
    its slots' (...) views of it (`new_slot_frontiers`'); raises where a
    group's slots are not those views."""
    out = []
    for grp in mesh.groups:
        slots = per_slot[grp.start:grp.stop]
        g = slots[0]._base
        if g is None or g.shape[0] != len(slots) or any(
                (t.data_ptr(), t.shape, t.stride())
                != (g[s].data_ptr(), g.shape[1:], g.stride()[1:])
                for s, t in enumerate(slots)):
            raise ValueError(f"slots {grp.start}..{grp.stop - 1} are not "
                             f"views of one group buffer (make them with "
                             f"new_slot_frontiers or seed_slot_frontiers)")
        out.append(g)
    return out


def new_group_marks(fbm_groups: Sequence[torch.Tensor], P: int,
                    vmax: int) -> List[torch.Tensor]:
    """A hop's zero mark matrices, one (S, Ll, P, vmax) view a group
    (the first vmax columns of an (S, Ll, P, 32 * W) allocation, so that
    every row starts 32-byte aligned for pack_bits' vector loads), sized
    after the groups' (S, Ll, ...) frontier buffers."""
    w32 = 32 * -(-vmax // 32)
    return [torch.zeros((f.shape[0], f.shape[1], P, w32), dtype=torch.bool,
                        device=f.device)[..., :vmax] for f in fbm_groups]


def exchange_marks_lanes(mesh: Mesh, marks_by_group: Sequence[torch.Tensor],
                         outs: Sequence[torch.Tensor]) -> None:
    """The per-hop frontier exchange (K15, the reference's
    `_exchange_marks_lanes`, hop.py:214): each group's (S, Ll, P, vmax)
    mark matrices — row d of slot s the candidates bound for slot d — are
    packed to (S, Ll, P, W) words (one pack_bits), the transport ships
    row d to slot d, and each group ORs what its slots received and
    unpacks it (one unpack_or) into outs[g], its slots' (S, Ll, vmax)
    next-frontier bitmaps (the first vmax columns of their buffers).
    One exchange carries every lane; a solo statement is the L = 1
    case."""
    packed = [pack_bits(m) for m in marks_by_group]
    recv = mesh.transport.all_to_all(mesh, packed)
    vmax = marks_by_group[0].shape[-1]
    for r, out in zip(recv, outs):
        unpack_or(r, vmax, out)


def extend_fbm_sharded_lanes(mesh: Mesh, shards: Sequence[DeviceShard],
                             fbm_by_group: Sequence[torch.Tensor]) -> None:
    """Fill the H hub columns of every slot's (Ll, 1, vmax + H) frontier
    buffer, a group's (S, Ll, 1, vmax + H) at a time (K16, the
    reference's `_extend_fbm_sharded_lanes`, hop.py:292): each group
    takes the bits of the hubs its slots own (one owned_hub_bits, with
    the first slot's hub tables: every slot holds the same), the
    transport sums them over the groups, and each group sets its slots'
    hub columns where the sum is > 0 (one fill_hub_columns)."""
    heads = [shards[grp.start] for grp in mesh.groups]
    owned = [owned_hub_bits(f, sh.part, sh.hub_owner, sh.hub_local)
             for f, sh in zip(fbm_by_group, heads)]
    for f, summed in zip(fbm_by_group,
                         mesh.transport.all_reduce_sum(mesh, owned)):
        fill_hub_columns(f, summed)


def _gather_parts(per_slot: Sequence[torch.Tensor], device,
                  fill=None) -> torch.Tensor:
    """Each slot's (Ll, 1, ...) leaf on `device`, concatenated in part
    order along the part axis; with `fill`, the last axis padded to the
    widest slot's width with that value first."""
    ts = [t.to(device) for t in per_slot]
    if fill is not None:
        width = max(t.shape[-1] for t in ts)
        ts = [torch.nn.functional.pad(t, (0, width - t.shape[-1]),
                                      value=fill) for t in ts]
    return torch.cat(ts, 1)


def _parts_by_hop(per_group: Sequence[List[torch.Tensor]],
                  device) -> torch.Tensor:
    """Each group's per-hop (S, Ll, 1) counts as one (Ll, P, steps)
    tensor on `device`, the parts in order."""
    return torch.cat([torch.stack(h, -1)[:, :, 0].transpose(0, 1).to(device)
                      for h in per_group], 1)


_CAP_FILL = {"src": -1, "dst": -1}       # every other leaf pads with 0


def run_hops_sharded(mesh: Mesh, shards: Sequence[DeviceShard],
                     blocks_by_slot: Sequence[Sequence[DeviceBlock]],
                     frontier_by_slot: Sequence[torch.Tensor], steps: int,
                     pred: Optional[Program] = None, capture: bool = True,
                     yield_cols: Sequence[str] = (),
                     deltas_by_slot: Optional[Sequence[Sequence[Optional[
                         Dict[str, Any]]]]] = None,
                     capture_hops: bool = False) -> Dict[str, Any]:
    """`run_hops` over a mesh of shard slots (Queue B K17, the
    reference's `build_traverse_fn_lanes_sharded`, hop.py:653, in both of
    its modes, with the delta merge of :382-389).  Per slot this process
    holds: `shards[i]` (its part and hub tables), its blocks, its (Ll, 1,
    vmax + H) seed buffer (`new_slot_frontiers` with the slot's seeds
    marked: a view of its group's buffer) and, per block, its delta
    plane's (1, ...) rows or None.

    Per hop, once a slot group: the frontier popcount, the zero mark
    matrices and next frontiers, and on a degree-split snapshot
    `extend_fbm_sharded_lanes` (K16); then in each slot, per block,
    expand with the slot's part (K1), the merge (K9), the WHERE mask (K4)
    and the compaction (K3 + K5) where GO or MATCH asks for them, and
    mark (K2) into the slot's (Ll, P, vmax) mark matrix; then one
    `exchange_marks_lanes` (K15) for every slot and lane.  The last hop
    ships nothing.

    Returns the `run_hops` contract for the parts this process holds,
    every per-part leaf reassembled in part order on mesh.devices[0]:
    hop_edges and frontier_sizes (Ll, P, steps), the captures (Ll, P, EB)
    per block (and per hop) with kcount (Ll, P), EB the widest slot's,
    and e_cap, each hop's widest slot width."""
    P = mesh.size
    H = shards[0].num_hubs
    vmax = frontier_by_slot[0].shape[-1] - H
    out_dev = mesh.devices[0]
    n_slots = len(shards)
    deltas_by_slot = deltas_by_slot if deltas_by_slot is not None else [
        [None] * len(blocks_by_slot[0])] * n_slots
    fbm = slot_groups(mesh, frontier_by_slot)
    hop_edges: List[List[torch.Tensor]] = [[] for _ in fbm]
    frontier_sizes: List[List[torch.Tensor]] = [[] for _ in fbm]
    e_cap: List[int] = []
    hop_caps: List[List[Dict[str, torch.Tensor]]] = []
    for hop in range(steps):
        for g, f in enumerate(fbm):
            frontier_sizes[g].append(f[..., :vmax].sum(-1,
                                                       dtype=torch.int32))
        if H:
            extend_fbm_sharded_lanes(mesh, shards, fbm)
        last = hop == steps - 1
        captured = capture and (last or capture_hops)
        width = 0
        marks = None if last else new_group_marks(fbm, P, vmax)
        slot_caps = []                   # [slot][block] capture dicts
        for g, (grp, f) in enumerate(zip(mesh.groups, fbm)):
            edges = torch.zeros(f.shape[:-1], dtype=torch.int32,
                                device=f.device)
            for s, i in enumerate(grp):
                sh = shards[i]
                caps = []
                for b, dl in zip(blocks_by_slot[i], deltas_by_slot[i]):
                    total, w, cap = _hop_block(
                        b, dl, f[s], sh.hub_dense, pred,
                        pred is not None and (last or capture_hops),
                        captured, () if capture_hops else yield_cols,
                        None if last else marks[g][s], P, vmax, parts=P,
                        pid=sh.part)
                    edges[s] += total
                    width = max(width, w)
                    caps.append(cap)
                slot_caps.append(caps)
            hop_edges[g].append(edges)
        if captured:
            hop_caps.append([
                {k: _gather_parts([sc[bi][k] for sc in slot_caps], out_dev,
                                  None if k == "kcount"
                                  else _CAP_FILL.get(k, 0))
                 for k in slot_caps[0][bi]}
                for bi in range(len(slot_caps[0]))])
        e_cap.append(width)
        if not last:
            nxt = [torch.zeros_like(f) for f in fbm]
            exchange_marks_lanes(mesh, marks,
                                 [n[:, :, 0, :vmax] for n in nxt])
            fbm = nxt
    res: Dict[str, Any] = {
        "hop_edges": _parts_by_hop(hop_edges, out_dev),
        "frontier_sizes": _parts_by_hop(frontier_sizes, out_dev),
        "e_cap": e_cap,
    }
    if capture:
        res["cap"] = hop_caps if capture_hops else hop_caps[-1]
    return res
