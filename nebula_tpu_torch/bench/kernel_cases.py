"""Edge cases of the scan kernels, `expand` (K1) and `compact_capture`
(K3 + K5), of `mark` (K2 / K6) and of `pagerank_step` (K12), made from a
numpy seed.

Each case is (name, args, kwargs) for `gpu.kernels.expand` /
`gpu.kernels.compact_capture` and their plain versions, on a given
device.  The shapes sit where a tiled single-pass scan and an
edge-balanced fill can go wrong: empty rows and empty outputs, row
widths one short of and one past a scan tile (`SCAN_TILE`), widths that
are not a multiple of 4 (rows that start off a 16-byte boundary), a
kept slot only at the end of each tile, a hub row longer than a fill
block's span, runs of zero-degree rows, query lanes, delta-merged
blocks, shard slots.  `big=True` adds rows of hundreds of tiles, whose
look-back walks long chains: sizes for the card; the CPU tests take the
small set.

`mark_cases` sit where the staged and direct mark kernels can go wrong:
no ids, no id kept, ids out of range, one id repeated, counts and lane
widths off a 16-byte boundary, an odd row stride (the split layout's
view), a bitmap already holding ones, part counts that are not a power
of two, and a bitmap too wide to stage.  `pagerank_cases` sit where a
merge-path segmented sum can: no edges, one vertex, one vertex holding
every edge (a row over many blocks), runs of edgeless rows across a
block's edge, segments ending exactly on a block's edge, every vertex
dangling, and `vmask` holes.

chip_smoke.py holds each kernel against its plain version on these
cases on the card; tests/test_torch_compact.py and
tests/test_torch_kernel_cases.py hold the plain versions against the
reference's functions on the CPU.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..algo.kernels import PAGERANK_BLOCK
from ..gpu.kernels import MARK_SMEM_BYTES, MARK_STAGE_MIN_IDS, SCAN_TILE

Case = Tuple[str, tuple, dict]


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _slots(rng, lead, EB, emax, dcap=0):
    """Random src/dst/rank/eidx slot arrays of shape lead + (EB,); eidx
    indexes the base columns (< emax) or, at columns >= EB - dcap, the
    delta half (emax + k)."""
    shape = tuple(lead) + (EB,)
    src = rng.integers(-1, 1 << 20, shape, dtype=np.int32)
    dst = rng.integers(-1, 1 << 20, shape, dtype=np.int32)
    rank = rng.integers(0, 4, shape, dtype=np.int32)
    eidx = rng.integers(0, max(emax, 1), shape, dtype=np.int32)
    if dcap:
        eidx[..., EB - dcap:] = emax + np.arange(dcap, dtype=np.int32)
    return src, dst, rank, eidx


def _cols(rng, P, n, kinds):
    """(P, n) yield columns: "i" int64, "f" float64 with NaN nulls."""
    out = []
    for k in kinds:
        if k == "i":
            out.append(rng.integers(-(1 << 40), 1 << 40, (P, n)))
        else:
            c = rng.standard_normal((P, n))
            c[rng.random((P, n)) < 0.1] = np.nan
            out.append(c)
    return out


def compact_cases(device, seed: int = 0, big: bool = False) -> List[Case]:
    """compact_capture(src, dst, rank, eidx, keep, cols, dcols=,
    extent=) cases."""
    rng = np.random.default_rng(seed)
    T = SCAN_TILE
    cases: List[Case] = []

    def add(name, lead, EB, keep, cols="i", extent=None, emax=6000,
            dcap=0):
        P = lead[-1]
        arrs = _slots(rng, lead, EB, emax, dcap)
        cl = _cols(rng, P, emax, cols)
        kw = {}
        if dcap:
            kw["dcols"] = [_t(c, device)
                           for c in _cols(rng, P, dcap, cols)]
        if extent is not None:
            kw["extent"] = _t(np.asarray(extent, np.int32).reshape(lead),
                              device)
        args = (*(_t(a, device) for a in arrs),
                _t(np.asarray(keep, bool).reshape(tuple(lead) + (EB,)),
                   device), [_t(c, device) for c in cl])
        cases.append((name, args, kw))

    def rand_keep(lead, EB, frac=0.5):
        return rng.random(tuple(lead) + (EB,)) < frac

    def rand_extent(lead, EB):
        return rng.integers(0, EB + 1, lead)

    P = 8
    EB = 2 * T + 811
    add("nothing kept", (P,), EB, np.zeros((P, EB), bool),
        extent=rand_extent((P,), EB))
    add("everything kept", (P,), EB, np.ones((P, EB), bool))
    add("every valid slot kept", (P,), EB, np.ones((P, EB), bool),
        extent=rand_extent((P,), EB))
    EBl = 3 * T + 7
    last = np.zeros((2, EBl), bool)
    last[:, T - 1::T] = True
    last[:, -1] = True
    add("only the last slot of each tile kept", (2,), EBl, last)
    for w in (0, 1, T - 1, T + 1, 2 * T + 2):
        add(f"EB {w}", (P,), w, rand_keep((P,), w),
            extent=rand_extent((P,), w))
    add("EB 4 x 1001 + 3, no extent", (3,), 4 * 1001 + 3,
        rand_keep((3,), 4 * 1001 + 3, 0.9))
    ext = np.where(np.arange(P) % 2 == 0, 0, EB)
    add("extent 0 on every other row", (P,), EB, rand_keep((P,), EB),
        extent=ext)
    dcap = 257
    W = T + 99 + dcap
    add("delta-merged, extent None", (P,), W, rand_keep((P,), W),
        cols="if", dcap=dcap)
    add("four columns, int64 and float64", (P,), EB, rand_keep((P,), EB),
        cols="ifif", extent=rand_extent((P,), EB))
    L = 8
    add("8 lanes", (L, P), EB, rand_keep((L, P), EB, 0.3), cols="fi",
        extent=rand_extent((L, P), EB))
    if big:
        n = 500 * T + 3
        add("one row of 500 tiles", (1,), n, rand_keep((1,), n, 0.3),
            extent=[n - 5])
        n = 40 * T + 1
        add("8 lanes x 8 rows of 40 tiles", (L, P), n,
            rand_keep((L, P), n, 0.5), cols="iiff",
            extent=rand_extent((L, P), n))
    return cases


def _csr(rng, P, nrows, deg_hi=8, hubs=(), active=0.3):
    """A (P, nrows + 1) CSR with `hubs` = [(p, row, degree)] and a
    frontier bitmap with `active` of the rows set (the hubs always)."""
    deg = rng.integers(0, deg_hi + 1, (P, nrows))
    for p, r, d in hubs:
        deg[p, r] = d
    indptr = np.zeros((P, nrows + 1), np.int32)
    np.cumsum(deg, axis=1, out=indptr[:, 1:])
    emax = max(int(indptr[:, -1].max()), 1)
    nbr = rng.integers(0, P * nrows, (P, emax), dtype=np.int32)
    rank = rng.integers(0, 3, (P, emax), dtype=np.int32)
    fbm = rng.random((P, nrows)) < active
    for p, r, _ in hubs:
        fbm[p, r] = True
    return indptr, nbr, rank, fbm


def expand_cases(device, seed: int = 0, big: bool = False) -> List[Case]:
    """expand(indptr, nbr, rank, fbm, hub_dense, extra, parts, pid)
    cases, as positional args."""
    rng = np.random.default_rng(seed + 1)
    T = SCAN_TILE
    cases: List[Case] = []

    def add(name, indptr, nbr, rank, fbm, hub_dense=None, extra=0,
            parts=None, pid=0):
        args = (_t(indptr, device), _t(nbr, device), _t(rank, device),
                _t(fbm, device),
                None if hub_dense is None else _t(hub_dense, device),
                extra, parts, pid)
        cases.append((name, args, {}))

    P = 8
    ip, nb, rk, f = _csr(rng, P, 3000)
    add("empty frontier", ip, nb, rk, np.zeros_like(f))
    add("empty frontier, extra 33", ip, nb, rk, np.zeros_like(f), extra=33)
    ip, nb, rk, f = _csr(rng, P, 5000, hubs=[(3, 17, 9000), (3, 4000, 5)])
    add("one hub row longer than a fill block's span", ip, nb, rk, f)
    ip, nb, rk, f = _csr(rng, P, 3 * T + 5, active=0.0005,
                         hubs=[(0, 2, 40), (5, 3 * T + 4, 3)])
    add("a sparse frontier over runs of zero-degree rows", ip, nb, rk, f)
    H, vloc = 12, 4000
    ip, nb, rk, f = _csr(rng, P, vloc + H,
                         hubs=[(p, vloc + h, int(rng.integers(2500, 6000)))
                               for p in range(P) for h in range(H)])
    hub = rng.choice(P * vloc, H, replace=False).astype(np.int32)
    add("split hub rows", ip, nb, rk, f, hub_dense=hub)
    ip, nb, rk, f = _csr(rng, 1, T + 3, hubs=[(0, 9, 3000)])
    add("a shard slot: parts 8, pid 5", ip, nb, rk, f, parts=8, pid=5)
    ip, nb, rk, f = _csr(rng, P, 2000)
    lanes = rng.random((4, P, 2000)) < 0.3
    lanes[2] = False                          # one lane's frontier empty
    add("4 lanes", ip, nb, rk, lanes)
    add("extra 1000", ip, nb, rk, f, extra=1000)
    ip, nb, rk, f = _csr(rng, P, vloc + H,
                         hubs=[(p, vloc + h, 3000)
                               for p in range(P) for h in range(H)])
    add("3 lanes, split hub rows, extra 7", ip, nb, rk,
        rng.random((3, P, vloc + H)) < 0.2, hub_dense=hub, extra=7)
    if big:
        ip, nb, rk, f = _csr(rng, 1, 125_000, deg_hi=20,
                             hubs=[(0, 5, 400_000)], active=0.6)
        add("a shard slot of 125,000 rows, a 400,000-edge hub", ip, nb, rk,
            f, parts=8, pid=3)
        ip, nb, rk, f = _csr(rng, P, 40 * T, deg_hi=4, active=0.5)
        add("8 rows of 40 tiles", ip, nb, rk, f, extra=4)
    return cases


def copy_view(t):
    """A copy of bitmap view `t` in a new buffer with t's layout (shape,
    strides, offset into its base), so that a kernel writing into the
    copy sees the same row stride."""
    base = t if t._base is None else t._base
    return base.clone().as_strided(t.shape, t.stride(), t.storage_offset())


def mark_cases(device, seed: int = 0, big: bool = False) -> List[Case]:
    """mark(ids, P, vmax, keep=, out=) cases; `out` is always given (a
    view into a buffer of its own; take `copy_view(out)` for each call)."""
    rng = np.random.default_rng(seed + 2)
    cases: List[Case] = []
    S = MARK_STAGE_MIN_IDS

    def add(name, ids, P, vmax, keep=None, lanes=0, H=0, ones=0.0):
        buf = np.zeros(((lanes,) if lanes else ()) + (P, vmax + H), bool)
        if ones:
            buf |= rng.random(buf.shape) < ones
        out = _t(buf, device)[..., :vmax]
        kw = {"out": out}
        if keep is not None:
            kw["keep"] = _t(np.asarray(keep, bool), device)
        cases.append((name, (_t(np.asarray(ids, np.int32), device), P,
                             vmax), kw))

    def ids_for(shape, P, vmax, lo=-1):
        return rng.integers(lo, P * vmax, shape, dtype=np.int64)

    P, vmax = 8, 3000
    add("n 0", np.zeros(0, np.int32), P, vmax)
    add("every id -1", np.full(5000, -1), P, vmax)
    odd = np.array([-1, -7, -(1 << 31), P * vmax, P * vmax + 3,
                    (1 << 31) - 1, 0, P * vmax - 1, 5])
    add("ids out of range", np.concatenate([odd, ids_for(S, P, vmax)]),
        P, vmax)
    add("keep all False", ids_for(S + 8, P, vmax), P, vmax,
        keep=np.zeros(S + 8, bool))
    add("one id repeated n times", np.full(S + 4, 12_345), P, vmax)
    n = S + 4001
    add("n = 65,536 + 4,001, not a multiple of 4", ids_for(n, P, vmax),
        P, vmax, keep=rng.random(n) < 0.5)
    add("3 lanes of 4,099 ids (per_lane % 4 = 3)",
        ids_for((3, 4099), P, vmax), P, vmax,
        keep=rng.random((3, 4099)) < 0.7, lanes=3)
    add("4 lanes of 16,385, lanes' bitmaps strided (ld 3,073)",
        ids_for((4, 16_385), P, vmax), P, vmax, lanes=4, H=73)
    add("split layout view: ld = vmax + 7, odd",
        ids_for(S + 2, P, vmax), P, vmax, keep=rng.random(S + 2) < 0.6,
        H=7)
    add("out already holding ones", ids_for(S, P, vmax), P, vmax,
        ones=0.3)
    for p in (1, 3, 7):
        add(f"P = {p}", ids_for(S + 1, p, 3001), p, 3001)
    wide = MARK_SMEM_BYTES * 8 // P + 64      # columns past the staged bits
    add(f"a bitmap too wide to stage: ({P}, {wide})",
        ids_for(S, P, wide), P, wide, keep=rng.random(S) < 0.9)
    add("16 seed ids", rng.choice(P * vmax, 16, replace=False), P, vmax)
    if big:
        V = 125_000
        n = 12_000_003
        zipf = np.minimum(rng.zipf(1.3, n), P * V) - 1
        add("12,000,003 ids into (8, 125,000), Zipf, ld 125,073",
            zipf, P, V, keep=rng.random(n) < 0.5, H=73)
        add("8 lanes x 1,500,001 ids, (8, 8, 125,000)",
            ids_for((8, 1_500_001), P, V), P, V, lanes=8)
        add("one slot: 1,559,801 ids into (1, 8, 125,000)",
            ids_for((1, 1_559_801), P, V), P, V, lanes=1)
        add("P = 1, 2,000,000 ids, vmax 1,000,000",
            ids_for(2_000_000, 1, 1_000_000), 1, 1_000_000)
    return cases


def _pagerank(rng, n, edst, device, vmask=None, tol=1e-4):
    """pagerank_step args for n vertices and the given destination of
    each edge (sorted), sources random over the real vertices."""
    edst = np.sort(np.asarray(edst, np.int64))
    E = edst.size
    if vmask is None:
        vmask = np.ones(n, bool)
    real = np.flatnonzero(vmask)
    esrc = real[rng.integers(0, real.size, E)] if E else np.zeros(0, int)
    starts = np.searchsorted(edst, np.arange(n + 1, dtype=np.int64))
    outdeg = np.bincount(esrc, minlength=n).astype(np.float64)
    out_inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    dmask = vmask & (outdeg == 0)
    rank = np.where(vmask, rng.random(n), 0.0)
    rank /= max(rank.sum(), 1e-300)
    return (_t(rank, device), _t(esrc.astype(np.int32), device),
            _t(starts, device), _t(out_inv[esrc], device),
            _t(dmask, device), _t(vmask, device), float(vmask.sum()), 0.85,
            tol)


def pagerank_cases(device, seed: int = 0, big: bool = False
                   ) -> List[Case]:
    """pagerank_step(rank, esrc, starts, out_inv_e, dmask, vmask, n,
    damping, tol) cases, as positional args; the sums launch cuts the n +
    E merge items into PAGERANK_BLOCK a block."""
    rng = np.random.default_rng(seed + 3)
    B = PAGERANK_BLOCK
    cases: List[Case] = []

    def add(name, n, edst, **kw):
        cases.append((name, _pagerank(rng, n, edst, device, **kw), {}))

    add("E 0", 50, [])
    add("n 1", 1, [0] * 5)
    hub = 3 * B + 11 if not big else 3_000_000
    add(f"one vertex holding all {hub} edges", 300, [117] * hub)
    # vertices 1,500-6,499 have no in-edge: blocks of rows alone
    n = 9000
    d = rng.integers(0, n, 20_000)
    d = d[(d < 1500) | (d >= 6500)]
    add("a run of 5,000 edgeless rows across block edges", n, d)
    # every row 2,047 edges: row v's end is the last item of block v
    add("every segment ending on a block's edge", 6,
        np.repeat(np.arange(6), B - 1))
    add("every vertex dangling (no edges)", 700, [],)
    vm = rng.random(5000) < 0.7
    real = np.flatnonzero(vm)
    add("vmask holes", 5000, real[rng.integers(0, real.size, 30_000)],
        vmask=vm)
    n = 4000
    zipf = np.minimum(rng.zipf(1.5, 50_000), n) - 1
    add("Zipf in-degrees", n, zipf)
    if big:
        n = 1_000_000
        zipf = np.minimum(rng.zipf(1.2, 30_000_000), n) - 1
        add("1,000,000 vertices, 30,000,000 Zipf edges", n, zipf,
            vmask=rng.random(n) < 0.99)
        add("every segment ending on a block's edge, 3,000 rows", 3000,
            np.repeat(np.arange(3000), B - 1))
    return cases
