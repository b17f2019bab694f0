"""Edge cases of the scan kernels, `expand` (K1) and `compact_capture`
(K3 + K5), of `mark` (K2 / K6), `pagerank_step` (K12), `predicate_mask`
(K4) and `merge_delta` (K9), made from a numpy seed.

Each case is (name, args, kwargs) for `gpu.kernels.expand` /
`gpu.kernels.compact_capture` and their plain versions, on a given
device.  The shapes sit where a tiled single-pass scan and an
edge-balanced fill can go wrong: empty rows and empty outputs, row
widths one short of and one past a scan tile (`SCAN_TILE`), widths that
are not a multiple of 4 (rows that start off a 16-byte boundary), a
kept slot only at the end of each tile, a hub row longer than a fill
block's span, runs of zero-degree rows, query lanes, delta-merged
blocks, shard slots; `expand_owner_cases` hold expand's owner route
(each hub row's bit read from its owner's row, the tail columns zero or
junk).  `big=True` adds rows of hundreds of tiles, whose
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
dangling, and `vmask` holes.  `predicate_cases` and `merge_delta_cases`
sit where row tiles of four-slot groups can go wrong (their docstrings
list the shapes).

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
from ..core import expr as E
from ..core.value import NULL
from ..gpu import exprjit as X
from ..gpu.kernels import (MARK_SMEM_BYTES, MARK_STAGE_MIN_IDS,
                           MERGE_DELTA_STAGE, MERGE_DELTA_TILE,
                           PREDICATE_TILES, SCAN_TILE, pack_bits_plain)
from ..graphstore.csr import StringPool
from ..graphstore.schema import PropType

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


def expand_owner_cases(device, seed: int = 0,
                       big: bool = False) -> List[Case]:
    """expand's owner route: the same positional args as `expand_cases`,
    with kwargs hub_owner and hub_local (H,) int32, so that each hub row's
    bit comes from its owner's row of the same lane.  Hubs owned by the
    first, a middle and the last part; an inactive hub; tail columns
    zero, or junk (each the opposite of the hub's bit, or random in
    lanes), which a scan reading them would expand; 1, 2 and 8 lanes
    whose lanes activate different hubs; H = 1, 73 and 300, the hub rows
    inside one scan tile, across a tile's edge and starting a tile."""
    rng = np.random.default_rng(seed + 7)
    T = SCAN_TILE
    P = 8
    cases: List[Case] = []

    def add(name, vloc, H, lanes=0, owners=None, tail="junk",
            inactive=0, deg_hi=8, extra=0):
        ip, nb, rk, _ = _csr(rng, P, vloc + H, deg_hi=deg_hi)
        own = (np.resize(np.asarray(owners), H) if owners is not None
               else rng.integers(0, P, H)).astype(np.int32)
        loc = np.zeros(H, np.int32)
        for p in range(P):        # distinct rows within each owner part
            mine = np.flatnonzero(own == p)
            loc[mine] = rng.choice(vloc, mine.size, replace=False)
        lead = (lanes,) if lanes else ()
        fbm = rng.random(lead + (P, vloc + H)) < 0.3
        # lane l activates the hubs h with h % L == l (solo: all), but
        # the first `inactive` hubs, which no lane activates
        n_l = max(lanes, 1)
        on = (np.arange(H)[None, :] % n_l == np.arange(n_l)[:, None])
        on[:, :inactive] = False
        fbm[..., own, loc] = on if lanes else on[0]
        bits = fbm[..., own, loc]                   # (lead..., H)
        if tail == "zero":
            fbm[..., vloc:] = False
        elif lanes:
            fbm[..., vloc:] = rng.random(fbm[..., vloc:].shape) < 0.5
        else:
            fbm[..., vloc:] = ~bits[..., None, :]
        hub = (loc.astype(np.int64) * P + own).astype(np.int32)
        args = (_t(ip, device), _t(nb, device), _t(rk, device),
                _t(fbm, device), _t(hub, device), extra, None, 0)
        cases.append((name, args, {"hub_owner": _t(own, device),
                                   "hub_local": _t(loc, device)}))

    add("H 1 owned by the first part, tail zero", 3000, 1, owners=[0],
        tail="zero")
    add("H 73 owned by the first, a middle and the last part, one "
        "inactive, junk tail", 5000, 73, owners=[0, P // 2, P - 1],
        inactive=1)
    add("H 300 across a scan tile's edge, junk tail", T - 100, 300,
        deg_hi=3)
    add("H 73 starting a scan tile, extra 5", T, 73, inactive=3, extra=5)
    add("2 lanes, different hubs, junk tails", 3000, 73, lanes=2)
    add("8 lanes, different hubs, one inactive, junk tails", 2000, 73,
        lanes=8, inactive=1)
    if big:
        add("8 lanes of 125,000 rows, H 73, junk tails", 125_000, 73,
            lanes=8, deg_hi=6)
        add("H 300 at 125,000 rows, junk tail", 125_000, 300, deg_hi=6)
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


# ---------------------------------------------------------------------------
# predicate_mask (K4)
# ---------------------------------------------------------------------------

PREDICATE_TYPES = {"w": "INT64", "f": "DOUBLE", "b": "BOOL", "tag": "STRING"}
PREDICATE_NAMES = ("ann", "bob", "cid", "dee")   # the string pool, in order
I64_MAX = (1 << 63) - 1


def _pred_builders():
    """WHERE trees by name, each a function of an expression module M
    (the port's `core.expr` or the reference's: the classes share names)
    and its NULL.  Together they run every opcode of gpu/exprjit.py."""
    def col(M, n):
        return M.EdgeProp("KNOWS", n)

    def lit(M, v):
        return M.Literal(v)

    def b(M, op, x, y):
        return M.Binary(op, x, y)

    def lst(M, *vs):
        return M.ListExpr([lit(M, v) for v in vs])

    def cmp(op, name, v):
        return lambda M, N: b(M, op, col(M, name), lit(M, v))

    def int_min(M):
        # w - I64_MAX - 2 wraps to INT64_MIN at w = 1
        return b(M, "-", b(M, "-", col(M, "w"), lit(M, I64_MAX)), lit(M, 2))

    def chain(M, op, terms):
        out = terms[-1]
        for t in reversed(terms[:-1]):
            out = b(M, op, t, out)
        return out

    return {
        "w > 50": cmp(">", "w", 50),
        "f < 0.5": cmp("<", "f", 0.5),
        "tag == ann": cmp("==", "tag", "ann"),
        "w <= 3": cmp("<=", "w", 3),
        "f >= 0.25": cmp(">=", "f", 0.25),
        "b": lambda M, N: col(M, "b"),
        "rank, id($^), id($$)": lambda M, N: b(
            M, "AND", b(M, ">=", M.FunctionCall("rank", [M.EdgeExpr()]),
                        lit(M, 1)),
            b(M, "OR", b(M, "==", M.FunctionCall("id", [M.VertexExpr("$^")]),
                         lit(M, 3)),
              b(M, "NOT IN", M.FunctionCall("id", [M.VertexExpr("$$")]),
                lst(M, 5, 9)))),
        "w + NULL > 1 OR w IS NULL": lambda M, N: b(
            M, "OR", b(M, ">", b(M, "+", col(M, "w"), lit(M, N)), lit(M, 1)),
            M.Unary("IS_NULL", col(M, "w"))),
        "f IS NOT NULL AND NOT b": lambda M, N: b(
            M, "AND", M.Unary("IS_NOT_NULL", col(M, "f")),
            M.Unary("NOT", col(M, "b"))),
        "-w < -40 XOR -f > -0.5": lambda M, N: b(
            M, "XOR", b(M, "<", M.Unary("-", col(M, "w")), lit(M, -40)),
            b(M, ">", M.Unary("-", col(M, "f")), lit(M, -0.5))),
        "w >= f * 100 OR f + 0.25 <= 0.75": lambda M, N: b(
            M, "OR", b(M, ">=", col(M, "w"),
                       b(M, "*", col(M, "f"), lit(M, 100))),
            b(M, "<=", b(M, "+", col(M, "f"), lit(M, 0.25)), lit(M, 0.75))),
        "w != 7 AND w < 60 OR f == 0.5 OR f != 0.25": lambda M, N: b(
            M, "OR", b(M, "AND", b(M, "!=", col(M, "w"), lit(M, 7)),
                       b(M, "<", col(M, "w"), lit(M, 60))),
            b(M, "OR", b(M, "==", col(M, "f"), lit(M, 0.5)),
              b(M, "!=", col(M, "f"), lit(M, 0.25)))),
        "(w-50)/7 < -2 OR (w-50)%7 == -3 OR w*2+1 > 21": lambda M, N: chain(
            M, "OR", [
                b(M, "<", b(M, "/", b(M, "-", col(M, "w"), lit(M, 50)),
                            lit(M, 7)), lit(M, -2)),
                b(M, "==", b(M, "%", b(M, "-", col(M, "w"), lit(M, 50)),
                             lit(M, 7)), lit(M, -3)),
                b(M, ">", b(M, "+", b(M, "*", col(M, "w"), lit(M, 2)),
                            lit(M, 1)), lit(M, 21))]),
        "w / (w - 10) > 0 OR (w % (w - 10)) IS NULL": lambda M, N: b(
            M, "OR", b(M, ">", b(M, "/", col(M, "w"),
                                 b(M, "-", col(M, "w"), lit(M, 10))),
                       lit(M, 0)),
            M.Unary("IS_NULL", b(M, "%", col(M, "w"),
                                 b(M, "-", col(M, "w"), lit(M, 10))))),
        "INT64_MIN / -7 > 0 OR INT64_MIN % 5 == -3 OR w % -4 == 1":
            lambda M, N: chain(M, "OR", [
                b(M, ">", b(M, "/", int_min(M), lit(M, -7)), lit(M, 0)),
                b(M, "==", b(M, "%", int_min(M), lit(M, 5)), lit(M, -3)),
                b(M, "==", b(M, "%", col(M, "w"), lit(M, -4)), lit(M, 1))]),
        "f / (f - 0.5) > 1.0 OR (f - 0.5) % 0.3 < -0.1": lambda M, N: b(
            M, "OR", b(M, ">", b(M, "/", col(M, "f"),
                                 b(M, "-", col(M, "f"), lit(M, 0.5))),
                       lit(M, 1.0)),
            b(M, "<", b(M, "%", b(M, "-", col(M, "f"), lit(M, 0.5)),
                        lit(M, 0.3)), lit(M, -0.1))),
        "(w & 1) == 0 OR (w | 8) < 60 OR (w ^ 3) > 40": lambda M, N: chain(
            M, "OR", [b(M, "==", b(M, "&", col(M, "w"), lit(M, 1)),
                        lit(M, 0)),
                      b(M, "<", b(M, "|", col(M, "w"), lit(M, 8)),
                        lit(M, 60)),
                      b(M, ">", b(M, "^", col(M, "w"), lit(M, 3)),
                        lit(M, 40))]),
        "w IN [3, 7.0, NULL] OR tag IN [cid, zzz, NULL] OR b IN [true]":
            lambda M, N: chain(M, "OR", [
                b(M, "IN", col(M, "w"), lst(M, 3, 7.0, N)),
                b(M, "IN", col(M, "tag"), lst(M, "cid", "zzz", N)),
                b(M, "IN", col(M, "b"), lst(M, True))]),
        "f NOT IN [0.5, 1] AND w NOT IN [1, 2, NULL]": lambda M, N: b(
            M, "AND", b(M, "NOT IN", col(M, "f"), lst(M, 0.5, 1)),
            b(M, "NOT IN", col(M, "w"), lst(M, 1, 2, N))),
        "w IN [128 constants]": lambda M, N: b(
            M, "IN", col(M, "w"),
            lst(M, *range(0, 252, 2), 7.5, N, 200.0)),
        "NOT (w == 0 OR ... OR w == 15): 64 instructions": lambda M, N:
            M.Unary("NOT", chain(M, "OR", [b(M, "==", col(M, "w"),
                                              lit(M, i))
                                            for i in range(16)])),
        "w > 0 AND (w > 10 AND (... w > 60)): 8 registers": lambda M, N:
            chain(M, "AND", [b(M, ">", col(M, "w"), lit(M, 10 * i))
                             for i in range(7)]),
        "w + 1: not a bool, always false": lambda M, N: b(
            M, "+", col(M, "w"), lit(M, 1)),
    }


PREDICATE_BUILDERS = _pred_builders()
PREDICATE_8_REGS = "w > 0 AND (w > 10 AND (... w > 60)): 8 registers"


def predicate_program(key: str, device="cpu"):
    """The port's program for PREDICATE_BUILDERS[key], compiled against
    PREDICATE_TYPES and a pool of PREDICATE_NAMES.  The 8-register case is
    lowered by hand, evaluating each AND's left operand first (the
    compiler's heavier-first order needs 2 registers for it): the same
    mask, through every register of the file."""
    if key == PREDICATE_8_REGS:
        code, consts = [], []
        for i in range(7):
            code += [(X.OP_LOAD_I, i, 0, 0, 0, 0, 0, 0),
                     (X.OP_CONST, i + 1, 0, 0, len(consts), 0, 0,
                      X.CONST_INT),
                     (X.OP_GT_I, i, i, i + 1, 0, 0, 0, 0)]
            consts.append(10 * i)
        for i in range(5, -1, -1):
            code.append((X.OP_AND3, i, i, i + 1, 0, 0, 0, 0))
        return X.Program(code, consts, ["w"], 8, False, device)
    prog, _ = X.compile_predicate(
        PREDICATE_BUILDERS[key](E, NULL),
        {n: PropType[t] for n, t in PREDICATE_TYPES.items()},
        StringPool(list(PREDICATE_NAMES)),
        vid_to_dense=lambda v: v if isinstance(v, int) and 0 <= v < 20
        else -1, device=device)
    return prog


def _pred_cols(rng, P, n):
    """(P, n) columns w, f, b, tag with nulls (INT64_MIN, NaN)."""
    w = rng.integers(-5, 100, (P, n)).astype(np.int64)
    w[rng.random((P, n)) < 0.1] = np.iinfo(np.int64).min
    f = rng.random((P, n))
    f[rng.random((P, n)) < 0.1] = np.nan
    f[rng.random((P, n)) < 0.05] = 0.5
    bb = rng.integers(0, 2, (P, n)).astype(np.int64)
    bb[rng.random((P, n)) < 0.1] = np.iinfo(np.int64).min
    tag = rng.integers(0, len(PREDICATE_NAMES), (P, n)).astype(np.int64)
    tag[rng.random((P, n)) < 0.1] = np.iinfo(np.int64).min
    return {"w": w, "f": f, "b": bb, "tag": tag}


def predicate_cases(device, seed: int = 0, big: bool = False
                    ) -> List[Case]:
    """predicate_mask(prog, src, dst, rank, eidx, valid, cols, dcols=)
    cases, as positional args; each name is "<PREDICATE_BUILDERS key> ::
    <shape>".  The shapes sit where row tiles of kV-slot groups can go
    wrong: row widths of 1, 3, 4, 5 and one past a tile of either kernel
    (rows off a 16-byte boundary, partial head and tail groups), total 0
    and total = EB, a valid mask with holes with and without delta
    halves (eidx >= emax in the tail reads the (P, dcap) half), lanes
    over shared columns.  The programs run every opcode (an IN over 128
    constants, a 64-instruction and an 8-register program, a program
    that is not a bool, INT64_MIN through / and %); the main path's
    w > 50 and the one-comparison form run on every shape."""
    rng = np.random.default_rng(seed + 4)
    T, TI = PREDICATE_TILES["compare"], PREDICATE_TILES["interpreter"]
    P, emax, dcap = 4, 300, 37
    base = _pred_cols(rng, P, emax)
    delta = _pred_cols(rng, P, dcap)
    cases: List[Case] = []

    def slots(lead, EB, valid, dc):
        shape = tuple(lead) + (EB,)
        R = int(np.prod(lead))
        eidx = np.sort(rng.integers(0, emax, (R, EB)), axis=1)
        if dc:
            eidx[:, EB - dc:] = emax + np.arange(dc)
        if valid == "mask":
            v = rng.random((R, EB)) < 0.6
            v[:, ::7] = False
            vt = _t(v.reshape(shape), device)
        else:
            tot = {"prefix": rng.integers(0, EB + 1, R),
                   "zero": np.zeros(R, int),
                   "full": np.full(R, EB)}[valid]
            tot[0] = {"zero": 0}.get(valid, EB)
            v = np.arange(EB)[None, :] < tot[:, None]
            vt = _t(tot.astype(np.int32).reshape(lead), device)
        arrs = [np.where(v, rng.integers(0, 20, (R, EB)), -1),
                np.where(v, rng.integers(0, 20, (R, EB)), -1),
                np.where(v, rng.integers(0, 3, (R, EB)), 0),
                np.where(v, eidx, 0)]
        return [_t(a.astype(np.int32).reshape(shape), device)
                for a in arrs] + [vt]

    def add(key, label, lead, EB, valid="prefix", dc=0):
        prog = predicate_program(key, device)
        sl = slots(lead, EB, valid, dc)
        cols = [_t(base[n], device) for n in prog.columns]
        kw = {}
        if dc:
            kw["dcols"] = [_t(delta[n][:, :dc], device)
                           for n in prog.columns]
        cases.append((f"{key} :: {label}", (prog, *sl, cols), kw))

    shapes = [("width 1", (P,), 1, "prefix", 0),
              ("width 3", (P,), 3, "prefix", 0),
              ("width 4", (P,), 4, "prefix", 0),
              ("width 5", (P,), 5, "prefix", 0),
              ("one past a tile", (P,), T + 1, "prefix", 0),
              ("one past an interpreter tile", (P,), TI + 1, "prefix", 0),
              ("total 0", (P,), 700, "zero", 0),
              ("total = EB", (P,), 701, "full", 0),
              ("a valid mask with holes", (P,), 1203, "mask", 0),
              ("a mask with holes, delta halves", (P,), 1203, "mask", dcap),
              ("3 lanes", (3, P), 901, "prefix", 0),
              ("3 lanes, a mask, delta halves", (3, P), 611, "mask", dcap)]
    keys = list(PREDICATE_BUILDERS)
    for label, lead, EB, valid, dc in shapes:
        for key in ("w > 50", "f < 0.5"):
            add(key, label, lead, EB, valid, dc)
    # every program on a width off a 16-byte boundary and past an
    # interpreter tile's edge, and each on one more shape in turn
    for i, key in enumerate(keys[2:]):
        add(key, f"width {TI + 3}, two tiles", (P,), TI + 3)
        label, lead, EB, valid, dc = shapes[i % len(shapes)]
        add(key, label, lead, EB, valid, dc)
    if big:
        add("w > 50", "2 lanes x 4 rows of 1,000,003", (2, P), 1_000_003)
        add("w IN [128 constants]", "4 rows of 1,000,003", (P,), 1_000_003)
        add("(w-50)/7 < -2 OR (w-50)%7 == -3 OR w*2+1 > 21",
            "8 lanes x 4 rows of 100,003, a mask, delta halves", (8, P),
            100_003, "mask", dcap)
        add(PREDICATE_8_REGS, "4 rows of 500,001", (P,), 500_001)
    return cases


# ---------------------------------------------------------------------------
# merge_delta (K9)
# ---------------------------------------------------------------------------

MAXI = np.iinfo(np.int32).max


def merge_delta_cases(device, seed: int = 0, big: bool = False
                      ) -> List[Case]:
    """merge_delta(src, dst, rank, eidx, total, fbm, d_src, d_dst, d_rank,
    d_valid, d_tomb, emax, parts=, pid=) cases, as positional args and
    kwargs.  The kernel merges in place: take `fresh_merge_args(args)` for
    each call.  The shapes sit where one tombstone search a tile can go
    wrong: no tombstone row (Tcap 0), no delta rows (Dcap 0), rows all
    MAXI padding, tombstones on a tile's first and last eidx, a tile whose
    tombstone range exceeds the staged slice (MERGE_DELTA_STAGE), eidx in
    no order, total 0 and total = EB, base widths and row widths that are
    not a multiple of 4, query lanes, a shard slot, and a strided frontier
    view."""
    rng = np.random.default_rng(seed + 5)
    T = MERGE_DELTA_TILE
    cases: List[Case] = []

    def add(name, lead, EB, Dcap, Tcap, vmax=64, emax=None, eidx="sorted",
            tomb="mixed", total="random", ld_extra=0, parts=None, pid=0):
        P = lead[-1]
        R = int(np.prod(lead))
        emax = 3 * EB + 1 if emax is None else emax
        tot = {"random": rng.integers(0, EB + 1, R),
               "full": np.full(R, EB), "zero": np.zeros(R, int)}[total]
        if total == "random" and R:
            tot[0] = EB
        j = np.arange(EB)
        ve = j[None, :] < tot[:, None]
        if eidx == "sorted":
            e = np.sort(rng.integers(0, emax, (R, EB)), axis=1)
        elif eidx == "unique":                 # eidx = 3 j + 1
            e = np.broadcast_to(3 * j + 1, (R, EB)).copy()
        else:
            e = rng.integers(0, emax, (R, EB))
        W = EB + Dcap

        def wide(a, fill):
            return np.concatenate([np.where(ve, a, fill),
                                   np.full((R, Dcap), fill)], 1)

        s = [wide(rng.integers(0, P * vmax, (R, EB)), -1),
             wide(rng.integers(0, P * vmax, (R, EB)), -1),
             wide(rng.integers(0, 3, (R, EB)), 0), wide(e, 0)]
        s = [_t(a.astype(np.int32).reshape(tuple(lead) + (W,)), device)
             for a in s]
        fbuf = rng.random((R, vmax + ld_extra)) < 0.5
        d_src = rng.integers(-3, vmax + 3, (P, Dcap)).astype(np.int32)
        d_valid = rng.random((P, Dcap)) < 0.7
        if Dcap:
            d_valid[:, 0] = True
            fbuf[np.arange(R), np.clip(d_src[np.arange(R) % P, 0], 0,
                                       vmax - 1)] = True
        d_tomb = np.full((P, Tcap), MAXI, np.int32)
        for p in range(P if tomb != "maxi" else 0):
            rows = e[p::P][ve[p::P]]
            if tomb == "edges":              # a tile's first and last eidx
                pick = 3 * np.array([0, T - 1, T, 2 * T - 1, EB - 1]) + 1
            elif tomb == "dense":   # tile 0's range past the staged slice
                pick = 3 * rng.choice(min(EB, T), min(Tcap, T) * 3 // 4,
                                      replace=False) + 1
                assert pick.size > MERGE_DELTA_STAGE
            else:
                live = np.unique(rows)
                pick = np.concatenate([
                    rng.choice(live, min(live.size, Tcap // 2),
                               replace=False),
                    rng.integers(0, emax, Tcap // 4)])
            pick = np.unique(pick)[:Tcap]
            d_tomb[p, :pick.size] = np.sort(pick)
        fbm = _t(fbuf.reshape(tuple(lead) + (vmax + ld_extra,)),
                 device)[..., :vmax]
        args = (*s, _t(tot.astype(np.int32).reshape(lead), device), fbm,
                _t(d_src, device),
                _t(rng.integers(0, P * vmax, (P, Dcap)).astype(np.int32),
                   device),
                _t(rng.integers(0, 3, (P, Dcap)).astype(np.int32), device),
                _t(d_valid, device), _t(d_tomb, device), emax)
        kw = {} if parts is None else {"parts": parts, "pid": pid}
        cases.append((name, args, kw))

    P = 4
    add("EB 4,099, Dcap 6: rows of 4,105 off 16 bytes", (P,), 2 * T + 3, 6,
        64)
    add("EB 4,099, Dcap 5: a row width of 4,104", (P,), 2 * T + 3, 5, 64)
    add("Tcap 0", (P,), 3001, 8, 0)
    add("Dcap 0", (P,), 3001, 0, 40)
    add("Tcap 0 and Dcap 0", (P,), 3001, 0, 0)
    add("every tombstone MAXI", (P,), 3001, 8, 64, tomb="maxi")
    add("tombstones on tiles' first and last eidx", (P,), 3 * T + 2, 8, 16,
        eidx="unique", total="full", tomb="edges")
    add("a tile's tombstones past the staged slice", (P,), 2 * T + 9, 8,
        3000, eidx="unique", total="full", tomb="dense")
    add("eidx in no order", (P,), 2 * T + 1, 8, 200, eidx="random")
    add("total 0", (P,), 2 * T, 8, 64, total="zero")
    add("total = EB", (P,), 2 * T, 8, 64, total="full")
    add("EB 0", (P,), 0, 8, 16)
    add("EB 1, 3, 5", (P,), 5, 3, 4)
    add("3 lanes", (3, P), T + 5, 7, 64)
    add("a shard slot: parts 8, pid 5", (1,), 2 * T + 7, 9, 64, parts=8,
        pid=5)
    add("a strided frontier view (ld vmax + 7)", (P,), T + 1, 8, 64,
        ld_extra=7)
    add("2 lanes, strided frontier, Dcap 0", (2, P), 999, 0, 32,
        ld_extra=3)
    if big:
        add("8 rows of 4,157,885 + 8,192, 2,000 tombstones a row", (8,),
            4_157_885, 8192, 8192, vmax=125_000, emax=4_157_885)
        add("4 lanes x 8 rows of 500,001 + 8,192", (4, 8), 500_001, 8192,
            8192, vmax=125_000, emax=500_001)
        add("a shard slot of 1,559,801 + 8,192: parts 8, pid 7", (1,),
            1_559_801, 8192, 8192, vmax=125_000, emax=1_559_801, parts=8,
            pid=7)
        add("tiles' tombstones past the staged slice, 4 rows of 400,003",
            (P,), 400_003, 64, 8192, eidx="unique", total="full",
            tomb="dense")
    return cases


def fresh_merge_args(args):
    """merge_delta args with fresh copies of the slot arrays it merges
    in place (src, dst, rank, eidx)."""
    return (*(a.clone() for a in args[:4]), *args[4:])


# ---------------------------------------------------------------------------
# wcc_step (K13) and sssp_step (K14)
# ---------------------------------------------------------------------------

RELAX_CHUNK = 128         # edges a warp of csrc/relax.cu takes a step
RELAX_BLOCK = 32 * 128    # edges a staged block's 32 warps take a step
RelaxCase = Tuple[str, str, tuple]


def relax_cases(device, seed: int = 0, big: bool = False
                ) -> List[RelaxCase]:
    """(name, kernel, args) cases of `wcc_step` (args: label, active,
    esrc, edst) and `sssp_step` (dist, frontier, esrc, edst and, weighted,
    w): each graph below once for WCC, once for unweighted and once for
    weighted SSSP.  Edges come sorted by destination, as the engine
    uploads them and the reference declares them.  The graphs sit where
    the frontier bits and the reduction by destination run can go wrong:
    no edges, one vertex, n not a multiple of 32 (the bitmap's last word),
    every source masked off, every source on, one destination holding
    every edge (a run over many warps and blocks), runs of one destination
    ending on a lane's 4 edges, on a warp's step of RELAX_CHUNK (and so
    on every warp's and block's range edge, which fall between steps) and
    on a staged block's step of RELAX_BLOCK, and one past and one short
    of each, sentinel values in the mask
    (label INT64_MAX, dist +inf), weights 0.0 and 0.5.  `big=True` adds
    card sizes: n at the staged route's capacity and just past it, one
    destination holding 3,000,000 edges."""
    rng = np.random.default_rng(seed + 6)
    cases: List[RelaxCase] = []

    def add(name, n, edst, on=0.5, sentinel=0.1, esrc=None, wts=None):
        edst = np.sort(np.asarray(edst, np.int64))
        E = edst.size
        if esrc is None:
            esrc = rng.integers(0, max(n, 1), E)
        mask = rng.random(n) < on
        label = rng.permutation(n).astype(np.int64)
        label[rng.random(n) < sentinel] = I64_MAX
        dist = rng.integers(0, 40, n).astype(np.float64)
        dist[rng.random(n) < sentinel] = np.inf
        if wts is None:
            wts = np.where(rng.random(E) < 0.2, 0.5,
                           rng.integers(0, 5, E).astype(np.float64))
        e = (_t(np.asarray(esrc, np.int32), device),
             _t(edst.astype(np.int32), device))
        m = _t(mask, device)
        cases.append((f"wcc: {name}", "wcc_step", (_t(label, device), m,
                                                   *e)))
        cases.append((f"sssp: {name}", "sssp_step", (_t(dist, device), m,
                                                     *e)))
        cases.append((f"sssp weighted: {name}", "sssp_step",
                      (_t(dist, device), m, *e,
                       _t(np.asarray(wts, np.float64), device))))

    n = 3000
    add("E 0", 50, [])
    add("n 1", 1, [0] * 7, on=1.0, sentinel=0.0)
    add("n 1,001 (the last word holds 9 bits)", 1001,
        rng.integers(0, 1001, 9000))
    add("n 33, sources 32 and 0 only", 33, rng.integers(0, 33, 600),
        esrc=rng.choice([0, 32], 600), on=1.0, sentinel=0.0)
    add("every source masked off", n, rng.integers(0, n, 20_000), on=0.0)
    add("every source on", n, rng.integers(0, n, 20_000), on=1.0)
    hub = 5 * RELAX_BLOCK + 77 if not big else 3_000_000
    add(f"one destination holding all {hub:,} edges", n,
        np.full(hub, 1234), on=0.7)
    for run in (4, RELAX_CHUNK, RELAX_BLOCK):
        for r in (run - 1, run, run + 1):
            k = min(max(6 * RELAX_BLOCK // r, 3), n)
            add(f"runs of {r:,} edges a destination", n,
                np.repeat(rng.choice(n, k, replace=False), r))
    add("sentinels in the mask (label INT64_MAX, dist +inf)", 400,
        rng.integers(0, 400, 8000), on=0.8, sentinel=0.5)
    add("weights 0.0 and 0.5 only", n, rng.integers(0, n, 20_000),
        wts=rng.choice([0.0, 0.5], 20_000))
    add("sparse frontier (1%), Zipf in-degrees", n,
        np.minimum(rng.zipf(1.5, 30_000), n) - 1, on=0.01)
    if big:
        from ..algo.kernels import RELAX_SMEM_BYTES
        cap = RELAX_SMEM_BYTES * 8
        for nv in (cap, cap + 1):
            add(f"n {nv:,} ({'at' if nv == cap else 'just past'} the "
                f"staged capacity), 8,000,000 edges", nv,
                rng.integers(0, nv, 8_000_000), on=0.3)
        add("1,000,000 vertices, 30,000,000 Zipf edges, frontier 2%",
            1_000_000, np.minimum(rng.zipf(1.2, 30_000_000),
                                  1_000_000) - 1, on=0.02)
    return cases


# ---------------------------------------------------------------------------
# bfs_probe and bfs_level (K11)
# ---------------------------------------------------------------------------

BfsCase = Tuple[str, str, tuple, dict]


def bfs_cases(device, seed: int = 0, big: bool = False) -> List[BfsCase]:
    """(name, kernel, args, kwargs) cases of `bfs_probe` (args: src, nbr,
    keep, total, fbm, out; kwargs: fbits, fbm's words) and `bfs_level`
    (args: cand, dist, level, fbm_out, unvis_out; kwargs: fbits_out,
    counts).  Bitmaps are the first vmax columns of wider buffers where a
    case says so, the rest of the buffer set; take `fresh_bfs_args` for
    each call.  Probe slots come as expand makes them from a reverse
    block: a row's src ids grouped (sorted local vertices of the row's
    part, runs of one vertex), hub rows' src owned by other parts, and,
    past total[p], ids that would be reached if read.  The cases sit
    where the staged and global probe and the one-warp-a-word level
    update can go wrong: P = 1 and P = 8, vmax not a multiple of 32 (the
    last word's padding bits), strided views, EB not a multiple of 4 (a
    row's vector tail), a row with total 0 beside one with total EB,
    every neighbour on the frontier and none, nbr -1 and >= P * vmax, src
    out of range, keep all False and keep=None, hub rows; a level with
    no fresh vertex, phantom slots, counts as a row of a larger buffer
    and none given.  `big=True` adds card sizes: the BFS's widest
    bottom-up level (8 x 1,928,999 slots of a (8, 125,000) frontier),
    the widest frontier that stages and one column past it (the global
    route)."""
    rng = np.random.default_rng(seed + 7)
    cases: List[BfsCase] = []

    def probe(name, P, vmax, EB, H=0, front=0.3, keep="random", hubs=0.0,
              totals=None, odd=False, ones=0.0):
        lim = P * vmax
        total = rng.integers(0, EB + 1, P).astype(np.int32)
        total[0] = EB
        if P > 1:
            total[1] = 0
        if totals is not None:
            total[:] = totals
        local = np.sort(rng.integers(0, vmax, (P, EB)), axis=1)
        src = local * P + np.arange(P)[:, None]
        hub = rng.random((P, EB)) < hubs
        src[hub] = rng.integers(0, lim, int(hub.sum()))
        nbr = rng.integers(0, lim, (P, EB))
        if odd:
            bad = np.array([-1, lim, lim + 3, -(1 << 31), (1 << 31) - 1])
            at = rng.random((P, EB)) < 0.05
            nbr[at] = rng.choice(bad, int(at.sum()))
            at = rng.random((P, EB)) < 0.05
            src[at] = rng.choice(bad, int(at.sum()))
        fbuf = np.ones((P, vmax + H), bool)
        fbuf[:, :vmax] = rng.random((P, vmax)) < front
        obuf = np.ones((P, vmax + H), bool)
        obuf[:, :vmax] = rng.random((P, vmax)) < ones
        k = {"random": rng.random((P, EB)) < 0.7, "none": None,
             "all False": np.zeros((P, EB), bool)}[keep]
        args = (_t(src.astype(np.int32), device),
                _t(nbr.astype(np.int32), device),
                None if k is None else _t(k, device), _t(total, device),
                _t(fbuf, device)[:, :vmax], _t(obuf, device)[:, :vmax])
        words = pack_bits_plain(torch.from_numpy(
            np.ascontiguousarray(fbuf[:, :vmax]))[None])[0]
        cases.append((name, "bfs_probe", args, {"fbits": words.to(device)}))

    def level(name, P, vmax, lv, H=0, cand=0.3, visited=0.4, phantom=0,
              stale_only=False, fbits=True, counts=True):
        dist = np.where(rng.random((P, vmax)) < visited,
                        rng.integers(0, max(lv, 1), (P, vmax)), -1)
        c = np.ones((P, vmax + H), bool)
        c[:, :vmax] = rng.random((P, vmax)) < cand
        if stale_only:
            c[:, :vmax] &= dist >= 0
        if phantom:
            nv = vmax - rng.integers(0, phantom + 1, P)
            cols = np.arange(vmax)[None, :] >= nv[:, None]
            dist[cols] = -1
            c[:, :vmax][cols] = False
        bufs = [_t(np.ones((P, vmax + H), bool), device)[:, :vmax]
                for _ in range(2)]
        kw = {}
        if fbits:
            kw["fbits_out"] = _t(np.full((P, -(-vmax // 32)), -1,
                                         np.int32), device)
        if counts:
            kw["counts"] = _t(np.zeros((lv + 2, 2), np.int64), device)[lv]
        cases.append((name, "bfs_level",
                      (_t(c, device)[:, :vmax],
                       _t(dist.astype(np.int32), device), lv, *bufs), kw))

    probe("P 8, vmax 3,001 (a last word of 25 bits), EB 4,099 (rows off "
          "16 bytes), views of ld 3,008, totals EB and 0", 8, 3001, 4099,
          H=7)
    probe("P 1, vmax 4,000, EB 10,000, keep None", 1, 4000, 10_000,
          keep="none")
    probe("vmax 2,048 (whole words), EB 4,096, out holding ones", 8, 2048,
          4096, ones=0.3)
    probe("every neighbour on the frontier", 8, 1000, 2001, front=1.0)
    probe("no neighbour on the frontier", 8, 1000, 2001, front=0.0)
    probe("nbr -1, >= P * vmax, -2^31, 2^31 - 1; src out of range", 8,
          1500, 3003, H=5, odd=True)
    probe("keep all False", 8, 1000, 2000, keep="all False")
    probe("hub rows: 30% of the slots' src owned by other parts", 8, 1200,
          3000, H=11, hubs=0.3)
    probe("EB 3, P 3", 3, 700, 3)
    probe("every total 0", 8, 500, 1000, totals=0)
    probe("totals past EB and negative", 4, 800, 1001,
          totals=[2000, -5, 1001, 7])
    level("level 0: the seeds, every dist -1, views of ld 3,008", 8, 3001,
          0, H=7, cand=0.01, visited=0.0)
    level("level 3, vmax 3,001, views of ld 3,010", 8, 3001, 3, H=9)
    level("no fresh vertex: every candidate already visited", 8, 2000, 2,
          stale_only=True)
    level("phantom slots: up to 90 padding columns a part", 8, 3001, 2,
          phantom=90)
    level("P 1, vmax 64 (two whole words), no fbits_out or counts", 1, 64,
          1, fbits=False, counts=False)
    level("vmax 1 (31 padding bits a word)", 8, 1, 1, visited=0.0,
          cand=0.5)
    level("counts None, fbits_out given", 3, 1000, 4, counts=False)
    if big:
        V = 125_000
        probe("the widest bottom-up level: 8 x 1,928,999 slots into "
              "(8, 125,000), ld 125,073, keep None", 8, V, 1_928_999,
              H=73, front=0.05, keep="none", hubs=0.01,
              totals=1_928_999)
        probe("the same, filtered (keep 70%)", 8, V, 1_928_999, H=73,
              front=0.05, hubs=0.01)
        wide = MARK_SMEM_BYTES * 8 // 8       # 232,448 columns a part
        probe(f"(8, {wide:,}): the widest frontier that stages", 8, wide,
              100_003, H=3)
        probe(f"(8, {wide + 1:,}): one column past it (global)", 8,
              wide + 1, 200_001, H=3, odd=True)
        probe("P 1, vmax 1,859,585 (global)", 1, wide * 8 + 1, 1_000_001)
        level("level 2 at (8, 125,000), ld 125,073", 8, V, 2, H=73,
              cand=0.6)
        level(f"level 5 at (8, {wide + 1:,})", 8, wide + 1, 5)
    return cases


def fresh_bfs_args(kname, args, kw):
    """A case's args and kwargs with fresh copies (same layout) of
    everything the kernel writes: probe's out; the level's cand, dist,
    fbm_out, unvis_out, fbits_out and counts."""
    if kname == "bfs_probe":
        return (*args[:5], copy_view(args[5])), dict(kw)
    cand, dist, lv, f, u = args
    return ((copy_view(cand), dist.clone(), lv, copy_view(f), copy_view(u)),
            {k: copy_view(v) for k, v in kw.items()})


ExchangeCase = Tuple[str, str, tuple]


def _bool_view(rng, device, lead, width, ld, offset=0, density=0.4):
    """A random (*lead, width) bool view into a buffer of rows `ld` bytes
    apart, starting `offset` bytes into its first row (the bytes around
    the view random too)."""
    rows = int(np.prod(lead)) if lead else 1
    buf = _t(rng.random(rows * ld + offset + ld) < density, device)
    strides, span = [1], ld
    for n in reversed(lead):
        strides.insert(0, span)
        span *= n
    return buf.as_strided(tuple(lead) + (width,), tuple(strides), offset)


def exchange_cases(device, seed: int = 0, big: bool = False
                   ) -> List[ExchangeCase]:
    """(name, kernel, args) cases of the mesh's exchange kernels,
    `pack_bits`, `unpack_or`, `owned_hub_bits` and `fill_hub_columns`,
    in their one-slot and slot-group forms.  The shapes sit where a
    word-per-thread pack with wide loads and an unpack with stores as
    wide as their alignment allows can go wrong: vmax 1, 31, 32, 33
    (a partial last word) and off 16 bytes; row strides a multiple of 16
    (the group marks' 32 * W rows), of 8, 4 and 1 byte, and a view
    starting off a 16-byte boundary; received words through the
    in-process transport's permuted view and the process-group one's
    merged axes; destination rows of odd stride (the split layout's vmax
    + H) and a view starting one byte in.  The hub pair: one slot and
    groups of 1, 2 and 4 slots whose first part is not 0 (hubs owned
    outside the group give 0), no hubs, lanes.  Outputs written in place
    (unpack_or's out, fill_hub_columns' fbm) are views: take
    `copy_view` of them for each call."""
    rng = np.random.default_rng(seed + 11)
    cases: List[ExchangeCase] = []
    P = 4
    for vmax in (1, 31, 32, 33, 1000):
        w32 = 32 * -(-vmax // 32)
        for ld, off, what in ((w32, 0, "rows 32 * W apart"),
                              (vmax + 8 if vmax % 8 == 0 else w32 + 8, 0,
                               "rows 8 bytes off 16"),
                              (w32 + 4, 4, "rows and base 4 off"),
                              (vmax + 3, 1, "odd rows, base 1 byte in")):
            cases.append((f"pack (2, 3, {P}, {vmax}), {what}", "pack_bits",
                          (_bool_view(rng, device, (2, 3, P), vmax, ld,
                                      off),)))
        cases.append((f"pack one slot (3, {P}, {vmax})", "pack_bits",
                      (_bool_view(rng, device, (3, P), vmax, vmax + 5),)))
        W = -(-vmax // 32)
        words = rng.integers(-(1 << 31), 1 << 31, (P, 3, P, W),
                             dtype=np.int64).astype(np.int32)
        t = _t(words, device)
        # what all_to_all_single gives a rank of 2 slots out of 4:
        # y[r, i, l, j], rank r's slot i to local slot j
        y = t[:2].reshape(2, 2, 3, 2, W)
        recvs = (("the in-process view", t.permute(2, 1, 0, 3)),
                 ("the process-group view",
                  y.permute(3, 2, 0, 1, 4).reshape(2, 3, P, W)),
                 ("contiguous", t))
        for name, r in recvs:
            S = r.shape[0]
            for H, off in ((0, 0), (73, 0), (6, 1)):
                out = _bool_view(rng, device, (S, 3), vmax, vmax + H + off,
                                 off, density=0.5)
                cases.append((f"unpack {name} ({S}, 3, {P}, {W}) -> vmax "
                              f"{vmax}, ld {vmax + H + off}, base {off} in",
                              "unpack_or", (r, vmax, out)))
        cases.append((f"unpack one slot (3, {P}, {W})", "unpack_or",
                      (t[0], vmax, _bool_view(rng, device, (3,), vmax,
                                              vmax + 7))))
    for S, p0, L, H, vmax in ((1, 0, 1, 5, 40), (2, 2, 3, 9, 33),
                              (4, 0, 2, 17, 100), (2, 0, 1, 0, 10),
                              (1, 3, 2, 12, 64)):
        Pm = 4
        dense = rng.choice(Pm * vmax, H, replace=False).astype(np.int32)
        owner, local = _t(dense % Pm, device), _t(dense // Pm, device)
        fbm = _t(rng.random((S, L, 1, vmax + H)) < 0.5, device)
        grp = f"group of {S} from part {p0}, {L} lanes, {H} hubs"
        cases.append((f"owned {grp}", "owned_hub_bits",
                      (fbm, p0, owner, local)))
        if S == 1:
            cases.append((f"owned one slot, part {p0}", "owned_hub_bits",
                          (fbm[0], p0, owner, local)))
        summed = _t(rng.integers(0, 3, (L, H)).astype(np.int32), device)
        cases.append((f"fill {grp}", "fill_hub_columns", (fbm, summed)))
        cases.append((f"fill one slot, {grp}", "fill_hub_columns",
                      (fbm[0], summed)))
    if big:
        V = 125_000
        W = -(-V // 32)
        cases.append(("pack the north star's hop 2: (8, 1, 8, 125,000), "
                      "rows 125,024 apart", "pack_bits",
                      (_bool_view(rng, device, (8, 1, 8), V, 32 * W),)))
        cases.append(("pack (8, 8, 8, 125,000), rows 125,073 apart",
                      "pack_bits",
                      (_bool_view(rng, device, (8, 8, 8), V, V + 73),)))
        t = _t(rng.integers(-(1 << 31), 1 << 31, (8, 8, 8, W),
                            dtype=np.int64).astype(np.int32), device)
        for ld, off in ((V + 73, 0), (V, 0), (V + 16, 2)):
            cases.append((f"unpack (8, 8, 8, {W}) permuted -> ld {ld}, "
                          f"base {off} in", "unpack_or",
                          (t.permute(2, 1, 0, 3), V,
                           _bool_view(rng, device, (8, 8), V, ld, off))))
    return cases
