"""The single-device level-synchronous BFS (Queue B K11).

Port of `nebula_tpu/tpu/bfs.py:build_bfs_fn_local` (:107), the device half
of FIND SHORTEST PATH.  The reference is one jitted XLA program with a
`lax.cond` per level; here it is a host loop over the hand-written kernels,
as `gpu/hop.py:run_hops` is for GO:

  level 0:    bfs_level turns the seed bitmap into dist (0 at the seeds,
              -1 elsewhere), the first frontier (as bytes, and as bits
              when the reverse blocks ride along) and the unvisited
              bitmap, counts both and clears the seed bitmap, which
              becomes the candidate bitmap;
  per level:  the dense-level switch `|frontier| * 8 > |unvisited| -
              n_phantom` (bfs.py:159) from the two counts of the previous
              update — one (2,) int64 row of a zeroed (max_steps + 1, 2)
              buffer read to the host per level; then top-down
              (frontier.top_down_step: expand, merge_delta on a block
              with a delta plane, predicate_mask, mark) or, with the
              reverse blocks, bottom-up (frontier.bottom_up_step: expand
              of the reverse blocks from the unvisited buffer,
              predicate_mask with the endpoints swapped, bfs_probe on
              the frontier's bits); then bfs_level.  On a degree-split
              snapshot each expand reads a hub's bit from its owner's
              row of the buffer it expands (`hop.hub_owners`).

Unlike GO (`run_hops`, which filters the final hop only), the WHERE mask
applies at every level, as in the reference (frontier.py:67-76).  All
`max_steps` levels are reported: once the frontier is empty a level
expands nothing, so its launches are skipped and it reports 0 edges, as
the reference's fixed program computes.  The frontier, unvisited and
candidate bitmaps are the first vmax columns of (P, vmax + H) buffers
(`hop.new_frontier`); their H tail columns stay unread.

`run_bfs_sharded` is the mesh's BFS (Queue B K17, the reference's
`build_bfs_fn`, bfs.py:54): top-down at every level — the reference's
sharded runtime pins no reverse twins (runtime.py:2169) — each shard slot
expanding its own part (`frontier.sharded_level_step`), one bit-packed
exchange a level, the last one included (`bfs_exchange_bytes`, :42), each
of its kernels one launch a slot group (`Mesh.groups`), then `bfs_level`
per slot on what it received: new = cand & (dist < 0).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..algo.frontier import bottom_up_step, sharded_level_step, \
    top_down_step
from .device import DeviceBlock, DeviceShard, DeviceSnapshot
from .exprjit import Program
from .hop import a2a_payload_bytes, exchange_marks_lanes, \
    extend_fbm_sharded_lanes, hub_owners, new_frontier, new_group_marks, \
    slot_groups
from .kernels import bfs_level
from .mesh import Mesh


def bfs_exchange_bytes(P: int, vmax: int, max_steps: int,
                       lanes: int = 1) -> int:
    """Bytes the bit-packed exchanges of one sharded BFS run move
    (nebula_tpu/tpu/bfs.py:42): one exchange every level, the last
    included (its candidates still update dist); 0 on a 1-slot mesh."""
    return max_steps * a2a_payload_bytes(P, vmax, lanes)


def run_bfs(dev: DeviceSnapshot, blocks: Sequence[DeviceBlock],
            rev_blocks: Optional[Sequence[DeviceBlock]],
            seeds: torch.Tensor, max_steps: int,
            pred: Optional[Program] = None,
            n_phantom: int = 0,
            deltas: Optional[Sequence[Optional[Dict[str, Any]]]] = None
            ) -> Dict[str, Any]:
    """Run a `max_steps`-level BFS from the seed buffer `seeds` (a
    `new_frontier` buffer with the seeds marked into its first vmax
    columns; it becomes the candidate buffer, and its contents are
    consumed).  With `rev_blocks` (each block's reverse twin, in the
    same order) dense levels go bottom-up; None keeps every level
    top-down.  n_phantom: the padding slots, P*vmax - sum(num_vertices).
    deltas: per block, its delta plane's tensors or None; top-down levels
    merge them (the caller passes no rev_blocks while a plane is armed).

    Returns:
      dist (P, vmax) int32 on the device: depth per slot, -1 unreached
      hop_edges (P, max_steps) int32 on the device: pre-filter slots per
        level and part
      e_cap: per-level slot width (ints; 0 for a level that expanded
        nothing)
      bottom_up: per-level branch (bools)
    """
    P, vmax = dev.num_parts, dev.vmax
    owners = hub_owners(dev)
    fbuf, ubuf = new_frontier(dev), new_frontier(dev)
    cand, fbm, unvis = seeds[:, :vmax], fbuf[:, :vmax], ubuf[:, :vmax]
    dist = torch.full((P, vmax), -1, dtype=torch.int32, device=seeds.device)
    # the frontier's words for the bottom-up probe, rewritten each level;
    # each level's counts are added into its own zeroed row
    fbits = None if rev_blocks is None else torch.empty(
        (P, -(-vmax // 32)), dtype=torch.int32, device=seeds.device)
    counts = torch.zeros((max_steps + 1, 2), dtype=torch.int64,
                         device=seeds.device)
    n_front, n_unvis = bfs_level(cand, dist, 0, fbm, unvis, fbits,
                                 counts[0]).tolist()
    no_edges = torch.zeros((P,), dtype=torch.int32, device=seeds.device)
    hop_edges: List[torch.Tensor] = []
    e_cap: List[int] = []
    bottom_up: List[bool] = []
    for level in range(1, max_steps + 1):
        use_bu = (rev_blocks is not None
                  and n_front * 8 > n_unvis - n_phantom)
        bottom_up.append(use_bu)
        if n_front == 0:
            hop_edges.append(no_edges)
            e_cap.append(0)
            continue
        if use_bu:
            edges, width = bottom_up_step(rev_blocks, fbm, ubuf, cand,
                                          dev.hub_dense, pred, fbits,
                                          owners=owners)
        else:
            edges, width = top_down_step(blocks, fbuf, cand,
                                         dev.hub_dense, pred, deltas,
                                         owners=owners)
        hop_edges.append(edges)
        e_cap.append(width)
        n_front, n_unvis = bfs_level(cand, dist, level, fbm, unvis, fbits,
                                     counts[level]).tolist()
    return {"dist": dist, "hop_edges": torch.stack(hop_edges, 1),
            "e_cap": e_cap, "bottom_up": bottom_up}


def run_bfs_sharded(mesh: Mesh, shards: Sequence[DeviceShard],
                    blocks_by_slot: Sequence[Sequence[DeviceBlock]],
                    seeds_by_slot: Sequence[torch.Tensor], max_steps: int,
                    pred: Optional[Program] = None,
                    deltas_by_slot: Optional[Sequence[Sequence[Optional[
                        Dict[str, Any]]]]] = None) -> Dict[str, Any]:
    """A `max_steps`-level top-down BFS over a mesh of shard slots.  Per
    slot this process holds: shards[i], its blocks, its (1, 1, vmax + H)
    seed buffer (`hop.new_slot_frontiers` with the slot's seeds marked, a
    view of its group's buffer; it becomes the candidate buffer) and,
    per block, its delta rows or None.  The frontier, unvisited,
    candidate, dist and count buffers and each level's mark matrices are
    one allocation a slot group (`Mesh.groups`), so that the exchange's
    kernels run once a group a level; each slot's expansion and
    `bfs_level` run on its views.

    Returns, for the parts this process holds, in part order on
    mesh.devices[0]: dist (P, vmax) int32, hop_edges (P, max_steps)
    int32 (every level's out-edges of the frontier), e_cap (per level,
    the widest slot's width) and bottom_up (all False)."""
    P = mesh.size
    H = shards[0].num_hubs
    vmax = seeds_by_slot[0].shape[-1] - H
    deltas_by_slot = deltas_by_slot if deltas_by_slot is not None else [
        None] * len(shards)
    cands = slot_groups(mesh, seeds_by_slot)      # (S, 1, 1, vmax + H)
    fbufs = [torch.zeros_like(c) for c in cands]
    unvis = [torch.zeros((c.shape[0], 1, vmax), dtype=torch.bool,
                         device=c.device) for c in cands]
    dist = [torch.full((c.shape[0], 1, vmax), -1, dtype=torch.int32,
                       device=c.device) for c in cands]
    counts = [torch.zeros((c.shape[0], max_steps + 1, 2), dtype=torch.int64,
                          device=c.device) for c in cands]

    def update(level: int) -> None:
        for c, f, u, d, n in zip(cands, fbufs, unvis, dist, counts):
            for s in range(c.shape[0]):
                bfs_level(c[s, :, 0, :vmax], d[s], level, f[s, :, 0, :vmax],
                          u[s], counts=n[s, level])

    update(0)
    hop_edges: List[List[torch.Tensor]] = [[] for _ in shards]
    e_cap: List[int] = []
    for level in range(1, max_steps + 1):
        if H:
            extend_fbm_sharded_lanes(mesh, shards, fbufs)
        marks = new_group_marks(cands, P, vmax)
        width = 0
        for grp, f, m in zip(mesh.groups, fbufs, marks):
            for s, i in enumerate(grp):
                edges, w = sharded_level_step(blocks_by_slot[i], f[s], m[s],
                                              shards[i].part,
                                              shards[i].hub_dense, pred,
                                              deltas_by_slot[i])
                hop_edges[i].append(edges[0])
                width = max(width, w)
        e_cap.append(width)
        exchange_marks_lanes(mesh, marks, [c[:, :, 0, :vmax] for c in cands])
        update(level)
    out_dev = mesh.devices[0]
    return {"dist": torch.cat([d[:, 0].to(out_dev) for d in dist], 0),
            "hop_edges": torch.cat([torch.stack(h, -1).to(out_dev)
                                    for h in hop_edges], 0),
            "e_cap": e_cap, "bottom_up": [False] * max_steps}
