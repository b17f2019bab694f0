"""Edge cases of the scan kernels, `expand` (K1) and `compact_capture`
(K3 + K5), made from a numpy seed.

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

chip_smoke.py holds each kernel against its plain version on these
cases on the card; tests/test_torch_compact.py holds the plain versions
against the reference's functions on the CPU.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..gpu.kernels import SCAN_TILE

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
