"""The per-iteration step kernels of the algo plane (Queue B K12-K14).

Each algorithm's edge-propagate/combine/apply step is one wrapper here:

  pagerank_step   K12 — contributions over destination-sorted edges, a
                  deterministic segment sum per vertex (a merge-path
                  CSR SpMV, two launches), dangling mass, damping, the
                  L1 delta and the moved count
                  (nebula_tpu/algo/kernels.py:pagerank_step :49;
                  csrc/pagerank.cu)
  wcc_step        K13 — min-label hooking: masked gather, scatter-min
                  by destination (kernels.py:wcc_step :79; csrc/relax.cu)
  sssp_step       K14 — frontier relaxation: scatter-min of dist + w
                  (or + 1.0) by destination (kernels.py:sssp_step :95;
                  csrc/relax.cu)

K13 and K14 have two routes, one kernel each, chosen by `relax_route`
from the vertex count: "staged" (the frontier as bits in each block's
shared memory) and "global" (the same bits read from device memory).
Each wrapper also counts its launches a route
(`wcc_step.route_launches`).

Each has a plain PyTorch version (`*_plain`) that computes what the
reference's jitted step computes, with the same outputs and dtypes, and
a wrapper that runs the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.  Each wrapper counts its
launches in a plain int attribute (`pagerank_step.launches`, ...),
listed by `gpu.kernels.launch_counts()`.

Dtypes follow the reference, which runs under x64: rank, dist and weight
float64; label int64 with the sentinel BIG = INT64_MAX; esrc and edst
int32; starts int64; the counts int64 scalars.  The state a step
returns is new; its inputs are never written.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..gpu import kernels as GK

BIG = int(np.iinfo(np.int64).max)

_I32, _I64, _F64 = torch.int32, torch.int64, torch.float64


def _check_edges(n: int, *idx) -> None:
    """The wrappers' range check on the CPU side: every esrc/edst in
    [0, n) (a negative index would wrap around in torch's gather).  A
    CUDA kernel skips an out-of-range edge instead, without a device
    read; the arrays `graph.build_algo_graph` makes never hold one."""
    for t in idx:
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n):
            raise ValueError(f"edge endpoint outside [0, {n})")


# ---------------------------------------------------------------------------
# pagerank_step (K12)
# ---------------------------------------------------------------------------


def pagerank_step_plain(rank, esrc, starts, out_inv_e, dmask, vmask,
                        n: float, damping: float, tol: float):
    """Plain version of `pagerank_step`: (new rank (n_slots,) float64,
    L1 delta and moved count as 0-d float64 / int64 tensors).

    The segment sums are added up directly by destination.  The
    reference takes them as differences of one inclusive cumsum, whose
    rounding over 30M edges quantizes each vertex's sum to about 1e-16
    and moves it by up to about 1e-13: enough to hide late iterations'
    true changes from a tol=0 moved count."""
    n_slots, E = rank.shape[0], esrc.shape[0]
    contrib = rank[esrc.long()] * out_inv_e
    dst = torch.repeat_interleave(
        torch.arange(n_slots, device=rank.device), starts[1:] - starts[:-1],
        output_size=E)
    acc = torch.zeros_like(rank).index_add_(0, dst, contrib)
    dangling = torch.where(dmask, rank, 0.0).sum()
    # divide by a tensor: CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the kernel's (and numpy's) true division
    nt = torch.full((), n, dtype=_F64, device=rank.device)
    base = (1.0 - damping + damping * dangling) / nt
    new = torch.where(vmask, base + damping * acc, 0.0)
    moved = (new - rank).abs()
    return new, moved.sum(), (moved > tol).sum(dtype=_I64)


PAGERANK_BLOCK = 2560     # merge items (rows + edges) a block of the sums
PAGERANK_VBLOCK = 1024    # vertices a block of the apply pass


def pagerank_blocks(n: int, E: int):
    """(blocks of csrc/pagerank.cu's sums launch, blocks of its apply
    launch) for n vertices and E edges: the merged list of n row ends and
    E edges cut into PAGERANK_BLOCK items a block, the vertices into
    PAGERANK_VBLOCK (no launch at all when n == 0)."""
    if n <= 0:
        return 0, 0
    return GK._cdiv(n + E, PAGERANK_BLOCK), GK._cdiv(n, PAGERANK_VBLOCK)


def pagerank_scratch(n: int, E: int, device):
    """The kernel's scratch, (float64, int64): per sums block its carry
    value and dangling partial, per apply block its moved sum, then the
    dangling sum and the L1 delta; per sums block its carry row, per
    apply block its moved count, then the active count and one word of
    two 32-bit tickets (cleared by the entry point on the stream)."""
    nb, nvb = pagerank_blocks(n, E)
    return (torch.empty((2 * nb + nvb + 2,), dtype=_F64, device=device),
            torch.empty((nb + nvb + 2,), dtype=_I64, device=device))


def pagerank_step(rank, esrc, starts, out_inv_e, dmask, vmask,
                  n: float, damping: float, tol: float):
    """One PageRank iteration over destination-sorted edges: rank (n,)
    float64, esrc (E,) int32 sources in destination order, starts (n+1,)
    int64 segment index, out_inv_e (E,) float64 per-edge 1/outdeg,
    dmask/vmask (n,) bool, n the vertex count.  Returns (new rank, L1
    delta, moved count) as `pagerank_step_plain`; bit-identical from run
    to run on the card (no float atomics)."""
    if rank.device.type == "cpu":
        _check_edges(rank.shape[0], esrc)
        return pagerank_step_plain(rank, esrc, starts, out_inv_e, dmask,
                                   vmask, n, damping, tol)
    dev = rank.device
    N, E = rank.shape[0], esrc.shape[0]
    GK._want(rank, "rank", _F64, (N,), dev)
    GK._want(dmask, "dmask", torch.bool, (N,), dev)
    GK._want(vmask, "vmask", torch.bool, (N,), dev)
    GK._want(esrc, "esrc", _I32, (E,), dev)
    GK._want(out_inv_e, "out_inv_e", _F64, (E,), dev)
    GK._want(starts, "starts", _I64, (N + 1,), dev)
    lib = GK._lib()
    fscr, iscr = pagerank_scratch(N, E, dev)
    nb, nvb = pagerank_blocks(N, E)
    new = torch.empty((N,), dtype=_F64, device=dev)
    cval, dpart = fscr[:nb], fscr[nb:2 * nb]
    mpart, dsum, delta = fscr[2 * nb:2 * nb + nvb], fscr[-2:-1], fscr[-1:]
    crow, cpart = iscr[:nb], iscr[nb:nb + nvb]
    active, tickets = iscr[-2:-1], iscr[-1:]
    GK._check(lib.nt_pagerank_step(
        rank.data_ptr(), esrc.data_ptr(), starts.data_ptr(),
        out_inv_e.data_ptr(), dmask.data_ptr(), vmask.data_ptr(), N, E,
        float(n), float(damping), float(tol), crow.data_ptr(),
        cval.data_ptr(), dpart.data_ptr(), mpart.data_ptr(),
        cpart.data_ptr(), dsum.data_ptr(), tickets.data_ptr(),
        new.data_ptr(), delta.data_ptr(), active.data_ptr(),
        GK._stream(rank)), "pagerank_step")
    GK._count(pagerank_step)
    return new, delta[0], active[0]


# ---------------------------------------------------------------------------
# wcc_step (K13) and sssp_step (K14)
# ---------------------------------------------------------------------------


def _relax_plain(val, mask, esrc, edst, inc, sentinel):
    s = esrc.long()
    v = val[s] if inc is None else val[s] + inc
    send = torch.where(mask[s], v, sentinel)
    cand = torch.full_like(val, sentinel).scatter_reduce_(
        0, edst.long(), send, "amin", include_self=True)
    new = torch.minimum(val, cand)
    changed = new < val
    return new, changed, changed.sum(dtype=_I64)


def wcc_step_plain(label, active, esrc, edst):
    """Plain version of `wcc_step`: (new label (n,) int64, changed (n,)
    bool, changed count 0-d int64)."""
    return _relax_plain(label, active, esrc, edst, None, BIG)


def sssp_step_plain(dist, frontier, esrc, edst, w: Optional[torch.Tensor]
                    = None):
    """Plain version of `sssp_step`: (new dist (n,) float64, the next
    frontier (n,) bool, its size 0-d int64).  w=None weighs every edge
    1.0."""
    return _relax_plain(dist, frontier, esrc, edst,
                        1.0 if w is None else w, float("inf"))


RELAX_SMEM_BYTES = GK.MARK_SMEM_BYTES   # shared memory a block may take
RELAX_ROUTES = ("staged", "global")


def relax_stage_bytes(n: int) -> int:
    """Bytes of the frontier as bits for n vertices: ceil(n / 32) 32-bit
    words, rounded up to 16 bytes.  The size of the scratch the wrappers
    pass csrc/relax.cu, and the shared memory its staged route takes."""
    return GK._cdiv(n, 128) * 16


def relax_route(n: int, smem_bytes: int = RELAX_SMEM_BYTES) -> str:
    """The kernel `wcc_step` and `sssp_step` launch for n vertices:
    "staged" (each block copies the frontier bits into its shared memory
    and tests every edge's source there) where relax_stage_bytes(n) fits
    `smem_bytes`, else "global" (the same kernel reading the bits from
    device memory, where they sit in L2)."""
    return "staged" if relax_stage_bytes(n) <= smem_bytes else "global"


def _check_route(route) -> None:
    if route is not None and route not in RELAX_ROUTES:
        raise ValueError(f"route must be one of {RELAX_ROUTES}, got "
                         f"{route!r}")


def _relax_launch(fn, val, mask, esrc, edst, w, route):
    dev = val.device
    N, E = val.shape[0], esrc.shape[0]
    GK._want(mask, "mask", torch.bool, (N,), dev)
    GK._want(esrc, "esrc", _I32, (E,), dev)
    GK._want(edst, "edst", _I32, (E,), dev)
    if w is not None:
        GK._want(w, "w", _F64, (E,), dev)
    if route is None:
        route = relax_route(N)
    elif route == "staged" and relax_route(N) != "staged":
        raise ValueError(f"{N} vertices as bits do not fit a block's "
                         f"shared memory")
    lib = GK._lib()
    new = torch.empty_like(val)
    changed = torch.empty((N,), dtype=torch.bool, device=dev)
    count = torch.empty((1,), dtype=_I64, device=dev)
    words = torch.empty((relax_stage_bytes(N) // 4,), dtype=_I32,
                        device=dev)
    args = [val.data_ptr(), mask.data_ptr(), esrc.data_ptr(),
            edst.data_ptr()]
    if fn is sssp_step:
        args.append(None if w is None else w.data_ptr())
    name = fn.__name__
    GK._check(getattr(lib, "nt_" + name)(
        *args, E, N, words.data_ptr(), route == "staged", new.data_ptr(),
        changed.data_ptr(), count.data_ptr(), GK._stream(val)), name)
    GK._count(fn, route)
    return new, changed, count[0]


def wcc_step(label, active, esrc, edst, *, route=None):
    """One min-label hooking iteration: every active vertex sends its
    label along its edges; a vertex whose label drops joins the next
    active set.  label (n,) int64, active (n,) bool, esrc/edst (E,)
    int32, in any order (sorted by destination it is fastest).  Returns
    (new label, changed, count) as `wcc_step_plain`.  `route` forces one
    of RELAX_ROUTES on the card (None: `relax_route`'s choice); the
    result is the same bit for bit."""
    _check_route(route)
    if label.device.type == "cpu":
        _check_edges(label.shape[0], esrc, edst)
        return wcc_step_plain(label, active, esrc, edst)
    GK._want(label, "label", _I64, (label.shape[0],), label.device)
    return _relax_launch(wcc_step, label, active, esrc, edst, None, route)


def sssp_step(dist, frontier, esrc, edst, w: Optional[torch.Tensor] = None,
              *, route=None):
    """One frontier relaxation (Bellman-Ford over the active set):
    frontier vertices send dist + w (w=None: + 1.0) along their edges;
    strictly improved vertices form the next frontier.  dist (n,)
    float64, frontier (n,) bool, esrc/edst (E,) int32 in any order, w
    (E,) float64.  Returns (new dist, next frontier, its size) as
    `sssp_step_plain`; `route` as for `wcc_step`."""
    _check_route(route)
    if dist.device.type == "cpu":
        _check_edges(dist.shape[0], esrc, edst)
        return sssp_step_plain(dist, frontier, esrc, edst, w)
    GK._want(dist, "dist", _F64, (dist.shape[0],), dist.device)
    return _relax_launch(sssp_step, dist, frontier, esrc, edst, w, route)


for _fn in (pagerank_step, wcc_step, sssp_step):
    _fn.launches = 0
for _fn in (wcc_step, sssp_step):
    _fn.route_launches = dict.fromkeys(RELAX_ROUTES, 0)
