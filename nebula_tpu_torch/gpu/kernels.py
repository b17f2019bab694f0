"""The hand-written CUDA kernels: build, load, and the GO and BFS paths'
wrappers.

The GO path's five kernels, sources in `nebula_tpu_torch/csrc/`:

  expand            Queue B K1 — frontier-bitmap CSR expansion, with the
                    hub rows of a degree-split snapshot
                    (nebula_tpu/tpu/hop.py:_expand_block :58, :104-110);
                    given the hub owner tables, its scan reads each hub's
                    bit from its owner's row: K8, the hub bits
                    (hop.py:_hub_consts :271, _extend_fbm_local :303),
                    has no kernel of its own (`extend_hubs_plain` states
                    it)
  mark              K2 / K6 — kept dst ids into the (P, vmax) bitmap
                    (hop.py:_mark :168, runtime.py:_seed_builder :969):
                    two kernels chosen by shape (`mark_path`), the
                    bitmap staged as bits in shared memory or a direct
                    test-before-set scatter
  predicate_mask    K4 — the WHERE keep mask, a register program from
                    gpu/exprjit.py run over row tiles, four slots a
                    thread, with the column gathers fused; a program of
                    the one-comparison form runs a compiled-in instance
                    (`predicate_path`) (nebula_tpu/tpu/exprjit.py:201/289)
  compact_capture   K3 + K5 — stable compaction of the final hop and
                    the YIELD column gather (hop.py:_compact_cap :238,
                    _build_local_fn :543-550)
  merge_delta       K9 — the delta plane merged into a block's expanded
                    slots: tombstoned base slots masked (one tombstone
                    search a row tile), frontier-active delta rows
                    appended at columns EB + k (hop.py:_merge_delta :118)

On a block with a delta plane, expand writes its slots (P, EB + Dcap)
wide, merge_delta fills the tail in place and returns the merged valid
mask, and predicate_mask and compact_capture read each prop column as a
pair: the base (P, emax) tensor and the delta (P, Dcap) tensor, the
delta half at eidx - emax.

The BFS path (gpu/bfs.py) reuses expand, mark and predicate_mask and
adds two, both in bfs.cu:

  bfs_probe         K11 — the bottom-up membership test: a reverse slot's
                    unvisited src is reached when its in-neighbour is on
                    the frontier (nebula_tpu/algo/frontier.py:136-141),
                    read from the frontier's bits: two kernels chosen by
                    size (`probe_route`), the bits staged in each block's
                    shared memory or read from device memory
  bfs_level         K11 — the level update and the switch's popcounts
                    (nebula_tpu/tpu/bfs.py:153-159, 170-172), one launch
                    that also writes the next frontier as bits

The sharded mesh (gpu/hop.py's run_hops_sharded, gpu/bfs.py's
run_bfs_sharded) adds four, all in exchange.cu, each side of the
transport's data movement, each one launch over a slot group (the slots
that share a device, `Mesh.groups`: on one card, all of them):

  pack_bits         K15 — the group's (S, Ll, P, vmax) mark matrices
                    packed into (S, Ll, P, W) 32-bit words
                    (hop.py:_pack_bits :179)
  unpack_or         K15 — the OR of the P rows each slot received,
                    unpacked into its next frontier (hop.py:_unpack_or
                    :195)
  owned_hub_bits    K16 — the hub bits the group's slots own, (Ll, H)
                    int32 (hop.py:_extend_fbm_sharded_lanes :292)
  fill_hub_columns  K16 — every slot's hub columns set from their sum
                    over the groups (the same function, after its psum)

and expand and merge_delta take the slot's part offset (`parts`,
`pid`): a slot holds one part's CSR row.

The algo plane's three (pagerank.cu, relax.cu) are built into the same
library; their wrappers live in `algo/kernels.py`.

Query lanes (K10, nebula_tpu/tpu/hop.py:619 `build_traverse_fn_lanes`):
every GO-path wrapper also takes its per-statement tensors with a
leading lane axis, (L, P, ...), and runs all L lanes in the same one
launch (see the "query lanes" section below).

Each has a plain PyTorch version here (`*_plain`) with the same outputs,
and a wrapper that runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Each wrapper counts its
launches in a plain int attribute (`expand.launches`, ...), incremented
only where the kernel was launched.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3` compiles each
source to an object (all at once, one process each) and links them into
one shared library with a plain C interface, loaded with ctypes, under
`nebula_tpu_torch/_build/<hash of the sources>/`.  The build runs at the
first launch, or explicitly through `build()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from . import exprjit as X

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("expand.cu", "mark.cu", "predicate.cu",
           "compact_capture.cu", "bfs.cu", "pagerank.cu", "relax.cu",
           "delta.cu", "exchange.cu")
HEADERS = ("scan.cuh", "rowtile.cuh", "fastdiv.cuh", "launch.cuh")
MAX_COLS = 4                  # yield columns compact_capture gathers
SCAN_TILE = 4096              # elements a tile of csrc/scan.cuh's scan takes
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I32 = torch.int32
_lib_cache: dict = {}
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build or its launch returned a CUDA error."""


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (CUDA_HOME or PATH)")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + (" ".join(NVCC_FLAGS),):
        p = CSRC / name
        h.update(p.read_bytes() if p.exists() else name.encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _sources_digest() / "libnebula_kernels.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernels (one nvcc per source, all started together)
    and link them into one library.  Returns (path, seconds, the
    compiler's resource report).  A library already built from the same
    sources is reused."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, objs = [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed on {src}:\n{text}")
            report.append(f"== {src}\n{text}")
            objs.append(str(obj))
        lib = tmp / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0, "\n".join(report)


def _lib() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call of a process
    (the sources do not change while it runs).  Threads that launch at
    once wait for the one build."""
    lib = _lib_cache.get("lib")
    if lib is not None:
        return lib
    with _lib_lock:
        lib = _lib_cache.get("lib")
        if lib is None:
            lib = _load()
            _lib_cache["lib"] = lib
    return lib


def _load() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nt_scan_tile.argtypes, lib.nt_scan_tile.restype = [], I
    lib.nt_expand_scan.argtypes = [P, P, I, I, I, I, P, P, P, P, P, P]
    lib.nt_expand_fill.argtypes = ([P] * 5 + [I] * 4 + [P, I, I, I, LL]
                                   + [P] * 5)
    lib.nt_mark.argtypes = [P, P, LL, I, I, LL, LL, I, P, P]
    lib.nt_predicate_sizes.argtypes = [P]
    lib.nt_merge_delta_sizes.argtypes = [P]
    lib.nt_predicate_mask.argtypes = [P] * 7 + [I] * 5 + [P, I, P]
    lib.nt_compact_capture.argtypes = ([P] * 6 + [I] * 5 + [P] * 4 + [I]
                                       + [P] * 4 + [P] * 4 + [P] * 4
                                       + [P, P, P])
    lib.nt_merge_delta.argtypes = ([P, P, LL, I] + [P] * 4 + [I, P]
                                   + [I] * 7 + [P] * 7)
    lib.nt_pack_bits.argtypes = [P, LL, I, LL, I, P, P]
    lib.nt_unpack_or.argtypes = ([P] + [I] * 4 + [LL] * 3
                                 + [I, LL, LL, P, P])
    lib.nt_owned_hub_bits.argtypes = [P, I, I, LL, LL, I, P, P, I, P, P]
    lib.nt_fill_hub_columns.argtypes = [P, LL, I, LL, I, P, I, P]
    lib.nt_bfs_probe.argtypes = [P] * 4 + [I] * 3 + [P, I, P, LL, P]
    lib.nt_bfs_level.argtypes = [P, LL, P, I, I, I, P, LL, P, LL, P, P, P]
    D = ctypes.c_double
    lib.nt_pagerank_block.argtypes = lib.nt_pagerank_vblock.argtypes = []
    lib.nt_pagerank_step.argtypes = [P] * 6 + [LL, LL, D, D, D] + [P] * 11
    lib.nt_mark_stage_bytes.argtypes = [I, I]
    lib.nt_mark_stage_bytes.restype = LL
    lib.nt_wcc_step.argtypes = [P] * 4 + [LL, LL, P, I] + [P] * 4
    lib.nt_sssp_step.argtypes = [P] * 5 + [LL, LL, P, I] + [P] * 4
    lib.nt_relax_stage_bytes.argtypes = [LL]
    lib.nt_relax_stage_bytes.restype = LL
    for fn in (lib.nt_expand_scan, lib.nt_expand_fill, lib.nt_mark,
               lib.nt_predicate_sizes, lib.nt_merge_delta_sizes,
               lib.nt_predicate_mask, lib.nt_compact_capture,
               lib.nt_bfs_probe, lib.nt_bfs_level, lib.nt_merge_delta,
               lib.nt_pagerank_block, lib.nt_pagerank_vblock,
               lib.nt_pagerank_step, lib.nt_wcc_step, lib.nt_sssp_step,
               lib.nt_pack_bits, lib.nt_unpack_or, lib.nt_owned_hub_bits,
               lib.nt_fill_hub_columns):
        fn.restype = I
    if lib.nt_scan_tile() != SCAN_TILE:
        raise KernelError(f"scan tile {lib.nt_scan_tile()} differs from "
                          f"SCAN_TILE {SCAN_TILE}")
    from ..algo import kernels as AK
    if (lib.nt_pagerank_block(), lib.nt_pagerank_vblock()) != (
            AK.PAGERANK_BLOCK, AK.PAGERANK_VBLOCK):
        raise KernelError("pagerank.cu's block sizes differ from "
                          "algo/kernels.py's")
    for P, vmax in ((8, 125_000), (3, 33), (1, 1)):
        if lib.nt_mark_stage_bytes(P, vmax) != mark_stage_bytes(P, vmax):
            raise KernelError("mark.cu's staged bytes differ from "
                              "mark_stage_bytes")
    for n in (0, 1, 33, 1_000_000, 1_859_585):
        if lib.nt_relax_stage_bytes(n) != AK.relax_stage_bytes(n):
            raise KernelError("relax.cu's staged bytes differ from "
                              "relax_stage_bytes")
    sizes = (I * 2)()
    lib.nt_merge_delta_sizes(sizes)
    if tuple(sizes) != (MERGE_DELTA_TILE, MERGE_DELTA_STAGE):
        raise KernelError(f"delta.cu's tile and stage {tuple(sizes)} differ "
                          f"from gpu/kernels.py's")
    sizes = (I * 7)()
    lib.nt_predicate_sizes(sizes)
    want = (X.MAX_REGS, X.MAX_INSNS, X.MAX_CONSTS, X.MAX_COLS,
            ctypes.sizeof(_ProgramImage), *PREDICATE_TILES.values())
    if tuple(sizes) != want:
        raise KernelError(f"predicate kernel sizes {tuple(sizes)} differ "
                          f"from the lowering's {want}")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's card (the call
    torch.cuda.current_stream makes, without building a Stream object:
    a seed mark's launch is host-bound)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _want(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bitmap_view(t, name: str, shape, device) -> None:
    """A (P, vmax) bool bitmap, or the first vmax columns of a wider one:
    rows contiguous, any row stride.  An (L, P, vmax) stack of lanes'
    bitmaps must have its rows uniformly strided across the lanes (the
    first vmax columns of a contiguous (L, P, vmax + H) buffer)."""
    if t.device != device or t.dtype != torch.bool \
            or tuple(t.shape) != tuple(shape) \
            or (t.numel() and t.stride(-1) != 1) \
            or (t.dim() == 3 and t.numel()
                and t.stride(0) != t.shape[1] * t.stride(1)):
        raise ValueError(f"{name} must be a {tuple(shape)} bool bitmap on "
                         f"{device} with contiguous rows (uniformly "
                         f"strided across lanes)")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_status_words(rows: int, n: int) -> int:
    """The 8-byte scratch words one launch of csrc/scan.cuh's single-pass
    scan needs over `rows` rows of n elements: a status word for each
    tile of SCAN_TILE elements (at least one tile a row, so that an empty
    row still writes its total), then the tile ticket.  The kernel's entry
    point clears them on the stream."""
    return rows * max(_cdiv(n, SCAN_TILE), 1) + 1


def _scan_scratch(rows: int, n: int, dev) -> torch.Tensor:
    return torch.empty(scan_status_words(rows, n), dtype=torch.int64,
                       device=dev)


def _own_wrappers():
    return (expand, mark, predicate_mask, compact_capture,
            bfs_probe, bfs_level, merge_delta, pack_bits, unpack_or,
            owned_hub_bits, fill_hub_columns)


def _wrappers():
    """Every kernel wrapper: the GO and BFS paths', then the algo
    plane's (imported here: algo/kernels.py imports this module)."""
    from ..algo import kernels as AK
    return _own_wrappers() + (AK.pagerank_step, AK.wcc_step, AK.sssp_step)


def _count(fn, route=None) -> None:
    """Add one to a wrapper's launch count, and to its route's where it
    has routes (wrappers launch from several threads when batched
    statements run beside solo ones)."""
    with _count_lock:
        fn.launches += 1
        if route is not None:
            fn.route_launches[route] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in _wrappers():
            fn.launches = 0
            for route in getattr(fn, "route_launches", ()):
                fn.route_launches[route] = 0


def route_launch_counts() -> dict:
    """Launches of each route of the wrappers that have routes (expand's
    "hub owners", bfs_probe's, wcc_step's and sssp_step's two kernels),
    as {"wcc_step (staged)": n, ...}."""
    with _count_lock:
        return {f"{fn.__name__} ({route})": n for fn in _wrappers()
                for route, n in getattr(fn, "route_launches", {}).items()}


def launch_counts() -> dict:
    with _count_lock:
        return {fn.__name__: fn.launches for fn in _wrappers()}


# ---------------------------------------------------------------------------
# query lanes (K10)
# ---------------------------------------------------------------------------
#
# Every wrapper of the GO path takes its per-statement tensors with an
# optional leading lane axis: (L, P, ...) where the solo layout is (P,
# ...), one lane a statement of a batch (nebula_tpu/tpu/hop.py:619,
# `build_traverse_fn_lanes`, vmaps the hop over such an axis with the CSR
# shared).  The CSR, prop and delta tensors stay (P, ...) and shared.
# Each kernel then runs over the L * P rows in one launch: row q = l * P
# + p reads CSR row p = q % P.  A lane's result is the solo call's on its
# slice; L = 1 gives the solo results bit for bit.


def _lead(t, solo_ndim: int) -> Tuple[int, ...]:
    """The leading (P,) or (L, P) dims of a tensor whose solo layout has
    `solo_ndim` dims, the first of them P."""
    if t.dim() == solo_ndim:
        return tuple(t.shape[:1])
    if t.dim() == solo_ndim + 1:
        return tuple(t.shape[:2])
    raise ValueError(f"expected {solo_ndim} dims, or one more for a lane "
                     f"axis; got shape {tuple(t.shape)}")


def _rows(t, lead, view: bool = False) -> torch.Tensor:
    """t with its leading `lead` dims flattened into one row axis (a view
    when `view`, for the in-place writes)."""
    shape = (math.prod(lead), t.shape[-1])
    return t.view(shape) if view else t.reshape(shape)


def _part_of_row(n_rows: int, P: int, device) -> torch.Tensor:
    """(n_rows,) int64: the part (CSR row) of each flattened lane row."""
    return torch.arange(n_rows, device=device) % P


# ---------------------------------------------------------------------------
# expand (K1)
# ---------------------------------------------------------------------------


def _check_owner_tables(P: int, parts, pid: int, hub_dense, hub_owner,
                        hub_local) -> None:
    """Owner tables need the hub ids beside them, come as a pair, and
    need every part's rows: a shard slot has no other part's row."""
    if hub_owner is None and hub_local is None:
        return
    if hub_owner is None or hub_local is None or hub_dense is None:
        raise ValueError("hub_owner and hub_local come together, with "
                         "hub_dense")
    if (P if parts is None else int(parts)) != P or int(pid) != 0:
        raise ValueError(f"owner tables need every part's rows; a shard "
                         f"slot (parts {parts}, pid {pid}) has none but "
                         f"its own, and fills its hub columns instead")


def expand_plain(indptr, nbr, rank, fbm, hub_dense=None, extra: int = 0,
                 parts=None, pid: int = 0, hub_owner=None, hub_local=None):
    """Plain version of `expand`: (src, dst, rank, eidx) (P, EB + extra)
    int32 and total (P,) int32, EB = max(total).  Slot j < total[p] of
    part p is edge eidx of row `row`, where row is the frontier row
    whose degree range holds j; slots past total[p] are padding (-1, -1,
    0, 0).  A local row's src is row * parts + pid + p (parts defaults to
    P).  With hub_dense (H,) the last H of fbm's rows are hub rows and
    their slots' src is hub_dense[row - (rows - H)].  With hub_owner and
    hub_local (H,) each hub row's bit is read from its owner's row,
    fbm[hub_owner[h], hub_local[h]] (`extend_hubs_plain`'s gather), and
    fbm's H tail columns are not read.  With a lane axis, fbm (L, P,
    rows) gives (L, P, EB + extra) slots and (L, P) totals, EB the max
    over every lane; a lane's hubs read that lane's owner rows."""
    P = indptr.shape[0]
    _check_owner_tables(P, parts, pid, hub_dense, hub_owner, hub_local)
    parts = P if parts is None else int(parts)
    lead = _lead(fbm, 2)
    nrows = fbm.shape[-1]
    H = 0 if hub_dense is None else int(hub_dense.numel())
    if hub_owner is not None:
        fbm = extend_hubs_plain(fbm.clone(), hub_owner, hub_local,
                                nrows - H)
    f = _rows(fbm, lead)
    R = f.shape[0]
    dev = fbm.device
    pq = _part_of_row(R, P, dev)
    deg = torch.where(f, (indptr[:, 1:] - indptr[:, :-1])[pq], 0).to(_I32)
    ends = torch.cumsum(deg, 1, dtype=_I32)
    total = ends[:, -1].contiguous()
    starts = ends - deg
    EB = (int(total.max()) if R else 0) + int(extra)
    j = torch.arange(EB, dtype=_I32, device=dev).expand(R, EB).contiguous()
    valid = j < total[:, None]
    row = torch.searchsorted(ends, j, right=True)
    row = torch.where(valid, row, 0)
    rq = pq[:, None]
    eidx = indptr[rq, row] + (j - torch.gather(starts, 1, row))
    eidx = torch.where(valid, eidx, 0).to(_I32)
    el = eidx.long()
    dst = torch.where(valid, nbr[rq, el], -1).to(_I32)
    rk = torch.where(valid, rank[rq, el], 0).to(_I32)
    sid = row * parts + pid + rq
    if H:
        vloc = nrows - H
        hub = hub_dense.long()[(row - vloc).clamp(0, H - 1)]
        sid = torch.where(row < vloc, sid, hub)
    src = torch.where(valid, sid, -1).to(_I32)
    return (*(t.reshape(lead + (EB,)) for t in (src, dst, rk, eidx)),
            total.reshape(lead))


def expand(indptr, nbr, rank, fbm, hub_dense=None, extra: int = 0,
           parts=None, pid: int = 0, hub_owner=None, hub_local=None):
    """Expand one block's CSR from the (P, rows) bool frontier bitmap, or
    from an (L, P, rows) stack of L lanes' bitmaps in the same launch.
    Returns (src, dst, rank, eidx, total) as `expand_plain` does.  An
    unsplit block has rows = vmax; a degree-split one rows = vmax + H,
    with its (H,) int32 hub ids in hub_dense.  With the (H,) int32 owner
    tables hub_owner and hub_local the scan reads each hub row's bit from
    its owner's row of the same lane (counted as the "hub owners" route)
    and never the H tail columns; without them it reads the tail
    columns, which the caller filled (the mesh's fill_hub_columns).
    `extra` padding columns follow the EB slot columns: room for
    `merge_delta`'s delta rows.  `parts` and `pid`: the CSR rows given
    are parts pid .. pid + P - 1 of a `parts`-part snapshot (a shard slot
    gives its one part, and then no owner tables: ValueError; the
    defaults, P and 0, are the whole snapshot).  The one device-to-host
    read is max(total) over every lane and part."""
    if fbm.device.type == "cpu":
        return expand_plain(indptr, nbr, rank, fbm, hub_dense, extra,
                            parts, pid, hub_owner, hub_local)
    P = indptr.shape[0]
    _check_owner_tables(P, parts, pid, hub_dense, hub_owner, hub_local)
    parts = P if parts is None else int(parts)
    lead = _lead(fbm, 2)
    if lead[-1] != P:
        raise ValueError(f"fbm has {lead[-1]} parts, the CSR {P}")
    L = lead[0] if len(lead) == 2 else 1
    nrows = fbm.shape[-1]
    emax = nbr.shape[1]
    dev = fbm.device
    H = 0 if hub_dense is None else int(hub_dense.numel())
    owners = hub_owner is not None
    _want(fbm, "fbm", torch.bool, lead + (nrows,), dev)
    _want(indptr, "indptr", _I32, (P, nrows + 1), dev)
    _want(nbr, "nbr", _I32, (P, emax), dev)
    _want(rank, "rank", _I32, (P, emax), dev)
    if H:
        _want(hub_dense, "hub_dense", _I32, (H,), dev)
    if owners:
        _want(hub_owner, "hub_owner", _I32, (H,), dev)
        _want(hub_local, "hub_local", _I32, (H,), dev)
    lib = _lib()
    starts = torch.empty(lead + (nrows,), dtype=_I32, device=dev)
    total = torch.empty(lead, dtype=_I32, device=dev)
    status = _scan_scratch(L * P, nrows, dev)
    stream = _stream(fbm)
    _check(lib.nt_expand_scan(
        indptr.data_ptr(), fbm.data_ptr(), P, L, nrows, nrows - H,
        hub_owner.data_ptr() if owners else None,
        hub_local.data_ptr() if owners else None, starts.data_ptr(),
        total.data_ptr(), status.data_ptr(), stream), "expand scan")
    EB = int(total.max()) if P else 0        # the one read per hop
    W = EB + int(extra)
    outs = [torch.empty(lead + (W,), dtype=_I32, device=dev)
            for _ in range(4)]
    if W:
        _check(lib.nt_expand_fill(
            indptr.data_ptr(), nbr.data_ptr(), rank.data_ptr(),
            starts.data_ptr(), total.data_ptr(), P, L, nrows,
            nrows - H, hub_dense.data_ptr() if H else None, parts, int(pid),
            emax, W,
            *[o.data_ptr() for o in outs], stream), "expand fill")
    _count(expand, "hub owners" if owners else None)
    return (*outs, total)


# ---------------------------------------------------------------------------
# mark (K2, K6)
# ---------------------------------------------------------------------------


def _mark_lanes(ids, out) -> int:
    """L when `out` is an (L, P, vmax) lane stack (ids then lane-major,
    their first dim L), else 0."""
    if out is None or out.dim() != 3:
        return 0
    L = out.shape[0]
    if ids.dim() < 1 or ids.shape[0] != L:
        raise ValueError(f"{L} lanes of bitmaps but ids of shape "
                         f"{tuple(ids.shape)}")
    return L


def mark_plain(ids, P: int, vmax: int, keep=None, out=None):
    """Plain version of `mark`: set out[d % P, d // P] for every kept id
    d in [0, P*vmax); ids < 0 or outside the range set nothing.  With an
    (L, P, vmax) `out`, ids[l] (and keep[l]) mark lane l."""
    if out is None:
        out = torch.zeros((P, vmax), dtype=torch.bool, device=ids.device)
    L = _mark_lanes(ids, out)
    o = out if L else out[None]
    d = ids.reshape(max(L, 1), -1).long()
    sel = (d >= 0) & (d < P * vmax)
    if keep is not None:
        sel &= keep.reshape(d.shape)
    lane = torch.arange(d.shape[0], device=d.device)[:, None].expand_as(d)
    lane, d = lane[sel], d[sel]
    o[lane, d % P, d // P] = True
    return out


MARK_SMEM_BYTES = 232_448   # shared memory a block may take on an H100
MARK_STAGE_MIN_IDS = 65_536  # a lane's ids below which mark goes direct
MARK_PATHS = ("staged", "direct")


def mark_stage_bytes(P: int, vmax: int) -> int:
    """Shared-memory bytes of mark's staged kernel for a (P, vmax) bitmap:
    P rows of ceil(vmax / 32) 32-bit words, rounded up to 16 bytes."""
    return _cdiv(P * _cdiv(vmax, 32) * 4, 16) * 16


def mark_path(per_lane: int, P: int, vmax: int) -> str:
    """The kernel `mark` launches for `per_lane` ids a lane into (P, vmax)
    bitmaps: "staged" (the bitmap as bits in a block's shared memory,
    flushed in address order) where the bits fit MARK_SMEM_BYTES and a
    lane has at least MARK_STAGE_MIN_IDS ids, else "direct" (one thread a
    slot, test-before-set)."""
    if (per_lane < MARK_STAGE_MIN_IDS
            or mark_stage_bytes(P, vmax) > MARK_SMEM_BYTES):
        return "direct"
    return "staged"


def mark(ids, P: int, vmax: int, keep=None, out=None, path=None):
    """OR the kept int32 dense ids into a (P, vmax) bool bitmap: `out`,
    or a fresh zero bitmap.  `out` may be the first vmax columns of a
    wider bitmap (rows contiguous, any row stride), or an (L, P, vmax)
    stack of lanes' bitmaps (rows uniformly strided, as the first vmax
    columns of a contiguous (L, P, vmax + H) buffer), and then ids[l]
    marks lane l — a hop's (L, P, W) slots or the (L, cap) seed ids — in
    the same launch.  keep=None keeps every id >= 0.  `path` forces one
    of MARK_PATHS on the card (None: `mark_path`'s choice); the result
    is the same bitmap either way."""
    if out is None:
        out = torch.zeros((P, vmax), dtype=torch.bool, device=ids.device)
    if path is not None and path not in MARK_PATHS:
        raise ValueError(f"path must be one of {MARK_PATHS}, got {path!r}")
    if ids.device.type == "cpu":
        return mark_plain(ids, P, vmax, keep, out)
    dev = ids.device
    L = _mark_lanes(ids, out)
    if ids.dtype != _I32 or not ids.is_contiguous():
        _want(ids, "ids", _I32, ids.shape, dev)          # raises
    _bitmap_view(out, "out", ((L,) if L else ()) + (P, vmax), dev)
    if keep is not None:
        _want(keep, "keep", torch.bool, ids.shape, dev)
    n = ids.numel()
    if n == 0:
        return out
    per_lane = n // L if L else n
    if path is None:
        path = mark_path(per_lane, P, vmax)
    elif path == "staged" and mark_stage_bytes(P, vmax) > MARK_SMEM_BYTES:
        raise ValueError(f"a ({P}, {vmax}) bitmap does not fit a block's "
                         f"shared memory as bits")
    keep_ptr = None if keep is None else keep.data_ptr()
    _check(_lib().nt_mark(ids.data_ptr(), keep_ptr, n, P, vmax,
                          out.stride(-2), per_lane, path == "staged",
                          out.data_ptr(), _stream(ids)), "mark")
    _count(mark)
    return out


# ---------------------------------------------------------------------------
# extend_hubs (K8): folded into expand's scan
# ---------------------------------------------------------------------------
#
# K8 has no kernel: on every single-device path `expand` reads a hub
# row's bit from its owner's row (the owner tables), and the mesh fills
# its slots' hub columns with K16.  `extend_hubs_plain` remains as the
# stated semantics that expand's owner route is held against.


def extend_hubs_plain(fbm, hub_owner, hub_local, vmax: int):
    """The hub bits of a degree-split frontier buffer (the reference's
    _extend_fbm_local): fbm[:, vmax + h] = fbm[hub_owner[h], hub_local[h]]
    for every part (of every lane), in place."""
    bits = fbm[..., hub_owner.long(), hub_local.long()]
    fbm[..., vmax:] = bits[..., None, :]
    return fbm


# ---------------------------------------------------------------------------
# predicate_mask (K4)
# ---------------------------------------------------------------------------


class _ProgramImage(ctypes.Structure):
    """The kernel's `Program` parameter (csrc/predicate.cu)."""
    _fields_ = [("n_insns", ctypes.c_int), ("n_cols", ctypes.c_int),
                ("always_false", ctypes.c_int), ("n_regs", ctypes.c_int),
                ("code", ctypes.c_int * (8 * X.MAX_INSNS)),
                ("consts", ctypes.c_longlong * X.MAX_CONSTS),
                ("cols", ctypes.c_void_p * X.MAX_COLS),
                ("dcols", ctypes.c_void_p * X.MAX_COLS)]


def _program_image(prog, cols, dcols=None) -> _ProgramImage:
    img = _ProgramImage()
    img.n_insns, img.n_cols = len(prog.code), len(cols)
    img.always_false = int(prog.always_false)
    img.n_regs = prog.n_regs
    for i, insn in enumerate(prog.code):
        img.code[8 * i:8 * i + 8] = list(insn)
    for i, w in enumerate(prog.consts):
        img.consts[i] = w
    for i, c in enumerate(cols):
        img.cols[i] = c.data_ptr()
    for i, c in enumerate(dcols or ()):
        img.dcols[i] = c.data_ptr()
    return img


def _take_pair(col, dcol, rows, eidx):
    """col (P, emax) at [rows, eidx], or its delta half dcol (P, dcap) at
    [rows, eidx - emax] where eidx >= emax: the two halves are read
    apart, never concatenated.  rows broadcasts against eidx; slots
    outside both halves read 0."""
    emax = col.shape[1]
    el = eidx.long()
    zero = torch.zeros((), dtype=col.dtype, device=col.device)
    out = torch.zeros(el.shape, dtype=col.dtype, device=col.device)
    if emax:
        out = torch.where((el >= 0) & (el < emax),
                          col[rows, el.clamp(0, emax - 1)], zero)
    if dcol is not None and dcol.shape[1]:
        dcap = dcol.shape[1]
        k = el - emax
        out = torch.where((k >= 0) & (k < dcap),
                          dcol[rows, k.clamp(0, dcap - 1)], out)
    return out


def predicate_mask_plain(prog, src, dst, rank, eidx, valid, cols,
                         dcols=None):
    """Plain version of `predicate_mask`: gather each of the program's
    columns (cols, in prog.columns order, each (P, emax), with its delta
    half in dcols) at eidx, run the program with torch ops, and AND with
    the valid mask (or slot < total[p])."""
    lead = _lead(src, 2)
    P, EB = lead[-1], src.shape[-1]
    flat = [_rows(t, lead) for t in (src, dst, rank, eidx)]
    R = flat[0].shape[0]
    v = valid.reshape(R, EB) if valid.dtype == torch.bool else (
        torch.arange(EB, dtype=_I32, device=src.device)
        < valid.reshape(R)[:, None])
    c = {"_rank": flat[2], "_src": flat[0], "_dst": flat[1]}
    dcols = dcols or [None] * len(cols)
    rows = _part_of_row(R, P, src.device)[:, None]
    for name, col, dcol in zip(prog.columns, cols, dcols):
        c[name] = _take_pair(col, dcol, rows, flat[3])
    return (v & prog(c)).reshape(src.shape)


# slots of one row a block of each predicate kernel takes
PREDICATE_TILES = {"compare": 2048, "interpreter": 8192}
PREDICATE_PATHS = tuple(PREDICATE_TILES)


def predicate_path(prog) -> str:
    """The kernel `predicate_mask` runs for `prog`: "compare" for a
    program of the one-comparison form `LOAD col; CONST; CMP` — an int
    or float column against a constant, one of the six comparisons,
    compiled into one of twelve kernel instances — else "interpreter"
    (csrc/predicate.cu)."""
    c = prog.code
    if (len(c) == 3 and not prog.always_false
            and c[0][0] in (X.OP_LOAD_I, X.OP_LOAD_F) and c[0][1] == 0
            and c[1][0] == X.OP_CONST and c[1][1] == 1
            and c[2][1:4] == (0, 0, 1)):
        base = X.OP_EQ_F if c[0][0] == X.OP_LOAD_F else X.OP_EQ_I
        if base <= c[2][0] <= base + 5:
            return "compare"
    return "interpreter"


def predicate_mask(prog, src, dst, rank, eidx, valid, cols, dcols=None,
                   path=None):
    """The (P, EB) bool keep mask of a WHERE predicate program
    (gpu/exprjit.py) over one block's expanded slots: True where the
    slot is valid and the predicate is true (not false, not null).  The
    slots may carry a lane axis, (L, P, EB), one launch for all lanes;
    the columns stay (P, emax).

    valid: the (P,) int32 total when the valid slots are each row's
    prefix, or merge_delta's (P, EB) bool mask (with the slots' lane
    axis).  dcols: the delta halves (P, Dcap) of cols, in the same order,
    on a merged block.  `path` forces one of PREDICATE_PATHS on the card
    (None: `predicate_path`'s choice; "compare" only for a program of
    that form); the mask is the same either way."""
    if prog.error is not None:
        raise prog.error
    if path is not None and path not in PREDICATE_PATHS:
        raise ValueError(f"path must be one of {PREDICATE_PATHS}, got "
                         f"{path!r}")
    if path == "compare" and predicate_path(prog) != "compare":
        raise ValueError("the program is not of the one-comparison form")
    if src.device.type == "cpu":
        return predicate_mask_plain(prog, src, dst, rank, eidx, valid, cols,
                                    dcols)
    lead = _lead(src, 2)
    P, EB = lead[-1], src.shape[-1]
    L = lead[0] if len(lead) == 2 else 1
    dev = src.device
    for name, t in (("src", src), ("dst", dst), ("rank", rank),
                    ("eidx", eidx)):
        _want(t, name, _I32, lead + (EB,), dev)
    by_mask = valid.dtype == torch.bool
    if by_mask:
        _want(valid, "valid", torch.bool, lead + (EB,), dev)
    else:
        _want(valid, "total", _I32, lead, dev)
    if len(cols) != len(prog.columns):
        raise ValueError(f"the program reads {len(prog.columns)} columns, "
                         f"got {len(cols)}")
    emax = cols[0].shape[1] if cols else 0
    for name, c in zip(prog.columns, cols):
        if c.dtype not in (torch.int64, torch.float64):
            raise ValueError(f"column {name} is {c.dtype}; int64 or "
                             f"float64")
        _want(c, f"column {name}", c.dtype, (P, emax), dev)
    dcap = _check_dcols(cols, dcols, P, dev)
    keep = torch.empty(lead + (EB,), dtype=torch.bool, device=dev)
    if P * EB == 0:
        return keep
    lib = _lib()
    img = _program_image(prog, cols, dcols)
    _check(lib.nt_predicate_mask(
        ctypes.addressof(img), src.data_ptr(), dst.data_ptr(),
        rank.data_ptr(), eidx.data_ptr(),
        None if by_mask else valid.data_ptr(),
        valid.data_ptr() if by_mask else None, P, L, EB, emax, dcap,
        keep.data_ptr(), (path or predicate_path(prog)) == "compare",
        _stream(src)), "predicate_mask")
    _count(predicate_mask)
    return keep


def _check_dcols(cols, dcols, P: int, dev) -> int:
    """Check the delta halves against their base columns; returns dcap
    (0 without them)."""
    if dcols is None:
        return 0
    if len(dcols) != len(cols):
        raise ValueError(f"{len(cols)} columns but {len(dcols)} delta "
                         f"halves")
    dcap = dcols[0].shape[1] if dcols else 0
    for i, (c, d) in enumerate(zip(cols, dcols)):
        _want(d, f"delta column {i}", c.dtype, (P, dcap), dev)
    return dcap


# ---------------------------------------------------------------------------
# compact_capture (K3 + K5)
# ---------------------------------------------------------------------------


def compact_capture_plain(src, dst, rank, eidx, keep,
                          cols: Sequence[torch.Tensor] = (), dcols=None,
                          extent=None):
    """Plain version of `compact_capture`: per part, the kept slots of
    src/dst/rank/eidx in order at the front of the row, each yield
    column's value at [p, eidx] beside them (its delta half at
    eidx - emax, with dcols), kcount (P,) int32; the rest of each row is
    padding (-1, -1, 0, 0, column words 0).  A slot at or past its row's
    `extent` (P,) int32, when given, is not kept.  With a lane axis
    every output gains it, kcount (L, P)."""
    lead = _lead(keep, 2)
    P, EB = lead[-1], keep.shape[-1]
    kf = _rows(keep, lead)
    if extent is not None:
        kf = kf & (torch.arange(EB, device=kf.device)
                   < extent.reshape(-1, 1))
    kcount = kf.sum(1, dtype=_I32)
    pos = torch.cumsum(kf, 1, dtype=torch.int64) - 1
    pi, si = kf.nonzero(as_tuple=True)
    di = pos[pi, si]

    def put(a, fill):
        a = _rows(a, lead)
        o = torch.full_like(a, fill)
        o[pi, di] = a[pi, si]
        return o.reshape(lead + (EB,))

    outs = [put(src, -1), put(dst, -1), put(rank, 0), put(eidx, 0)]
    e = _rows(eidx, lead)[pi, si]
    props = []
    for i, c in enumerate(cols):
        d = None if dcols is None else dcols[i]
        o = torch.zeros(kf.shape, dtype=c.dtype, device=c.device)
        o[pi, di] = _take_pair(c, d, pi % P, e)
        props.append(o.reshape(lead + (EB,)))
    return (*outs, props, kcount.reshape(lead))


def compact_capture(src, dst, rank, eidx, keep,
                    cols: Sequence[torch.Tensor] = (), dcols=None,
                    extent=None):
    """Compact the kept slots of each part to the front of its row and
    gather up to four 8-byte YIELD columns at their eidx; on a merged
    block, `dcols` are the columns' (P, Dcap) delta halves, in the same
    order.  `extent`, expand's total where the valid slots are each
    row's prefix: no slot at or past it is kept, and the kernel reads
    keep only below it.  The slots and keep may carry a lane axis, (L, P,
    EB), one launch for all lanes.  Returns (src, dst, rank, eidx,
    [cols], kcount) as `compact_capture_plain`."""
    if keep.device.type == "cpu":
        return compact_capture_plain(src, dst, rank, eidx, keep, cols, dcols,
                                     extent)
    lead = _lead(keep, 2)
    P, EB = lead[-1], keep.shape[-1]
    L = lead[0] if len(lead) == 2 else 1
    dev = keep.device
    _want(keep, "keep", torch.bool, lead + (EB,), dev)
    for name, t in (("src", src), ("dst", dst), ("rank", rank),
                    ("eidx", eidx)):
        _want(t, name, _I32, lead + (EB,), dev)
    if len(cols) > MAX_COLS:
        raise ValueError(f"compact_capture gathers at most {MAX_COLS} "
                         f"columns, got {len(cols)}")
    emax = cols[0].shape[1] if cols else 0
    for i, c in enumerate(cols):
        if c.dtype not in (torch.int64, torch.float64):
            raise ValueError(f"column {i} is {c.dtype}; int64 or float64")
        _want(c, f"column {i}", c.dtype, (P, emax), dev)
    dcap = _check_dcols(cols, dcols, P, dev)
    if extent is not None:
        _want(extent, "extent", _I32, lead, dev)
    lib = _lib()
    outs = [torch.empty(lead + (EB,), dtype=_I32, device=dev)
            for _ in range(4)]
    props: List[torch.Tensor] = [torch.empty(lead + (EB,), dtype=c.dtype,
                                             device=dev) for c in cols]
    kcount = torch.empty(lead, dtype=_I32, device=dev)
    status = _scan_scratch(L * P, EB, dev)

    def ptrs(ts):
        return [t.data_ptr() for t in ts] + [None] * (MAX_COLS - len(ts))

    _check(lib.nt_compact_capture(
        src.data_ptr(), dst.data_ptr(), rank.data_ptr(), eidx.data_ptr(),
        keep.data_ptr(), None if extent is None else extent.data_ptr(),
        P, L, EB, len(cols), emax, *ptrs(cols), dcap,
        *ptrs(dcols or ()), *[o.data_ptr() for o in outs], *ptrs(props),
        kcount.data_ptr(), status.data_ptr(), _stream(keep)),
        "compact_capture")
    _count(compact_capture)
    return (*outs, props, kcount)


# ---------------------------------------------------------------------------
# merge_delta (K9)
# ---------------------------------------------------------------------------


MERGE_DELTA_TILE = 2048      # base slots of one row a block takes
MERGE_DELTA_STAGE = 1024     # tombstones a block stages in shared memory


def merge_delta_plain(src, dst, rank, eidx, total, fbm, d_src, d_dst,
                      d_rank, d_valid, d_tomb, emax: int, parts=None,
                      pid: int = 0):
    """Plain version of `merge_delta`, the reference's `_merge_delta` for
    all parts.  src/dst/rank/eidx are expand's (P, EB + Dcap) slots;
    fbm the (P, vmax) frontier bitmap; d_src/d_dst/d_rank/d_valid (P,
    Dcap), d_tomb (P, Tcap) sorted and MAXI-padded.  In place: a base
    slot whose eidx is tombstoned gets dst = -1; column EB + k gets delta
    row k (src = d_src*parts + pid + p, dst, rank; parts defaults to P)
    when it is active — d_valid set and its source on the frontier — else
    padding (-1, -1, 0), and eidx = emax + k.  Returns (valid (P, EB +
    Dcap) bool, total + the active count (P,) int32).  With a lane axis
    on the slots, total and fbm, each lane merges against its own
    frontier; the d_* stay (P, ...)."""
    lead = _lead(src, 2)
    P, W = lead[-1], src.shape[-1]
    parts = P if parts is None else int(parts)
    Dcap, Tcap = d_src.shape[1], d_tomb.shape[1]
    EB = W - Dcap
    dev = src.device
    src, dst, rank, eidx = (_rows(t, lead, view=True)
                            for t in (src, dst, rank, eidx))
    R = src.shape[0]
    pq = _part_of_row(R, P, dev)
    tot = total.reshape(R)
    vb = torch.arange(EB, dtype=_I32, device=dev) < tot[:, None]
    if Tcap:
        e = eidx[:, :EB].contiguous()
        tomb = d_tomb[pq]
        pos = torch.searchsorted(tomb, e).clamp(max=Tcap - 1)
        hit = vb & (torch.gather(tomb, 1, pos) == e)
        vb &= ~hit
        dst[:, :EB] = torch.where(hit, -1, dst[:, :EB])
    vmax = fbm.shape[-1]
    f = _rows(fbm, lead)
    ds = d_src[pq]
    act = d_valid[pq] & torch.gather(f, 1, ds.clamp(0, vmax - 1).long())
    src[:, EB:] = torch.where(act, ds * parts + pid + pq[:, None].to(_I32),
                              -1)
    dst[:, EB:] = torch.where(act, d_dst[pq], -1)
    rank[:, EB:] = torch.where(act, d_rank[pq], 0)
    eidx[:, EB:] = emax + torch.arange(Dcap, dtype=_I32, device=dev)
    return (torch.cat([vb, act], 1).reshape(lead + (W,)),
            (tot + act.sum(1, dtype=_I32)).to(_I32).reshape(lead))


def merge_delta(src, dst, rank, eidx, total, fbm, d_src, d_dst, d_rank,
                d_valid, d_tomb, emax: int, parts=None, pid: int = 0):
    """Merge one block's delta plane into its expanded slots, in place,
    for all P parts — and all L lanes of (L, P, ...) slots, totals and
    frontiers — in one launch (see `merge_delta_plain` for the
    contract).  fbm may be the first vmax columns of a wider buffer (rows
    uniformly strided, any row stride).  `parts` and `pid` as `expand`'s:
    the rows given are parts pid .. pid + P - 1 of a `parts`-part
    snapshot.  Returns (valid, total_out)."""
    if src.device.type == "cpu":
        return merge_delta_plain(src, dst, rank, eidx, total, fbm, d_src,
                                 d_dst, d_rank, d_valid, d_tomb, emax,
                                 parts, pid)
    lead = _lead(src, 2)
    P, W = lead[-1], src.shape[-1]
    parts = P if parts is None else int(parts)
    L = lead[0] if len(lead) == 2 else 1
    Dcap, Tcap = d_src.shape[1], d_tomb.shape[1]
    dev = src.device
    for name, t in (("src", src), ("dst", dst), ("rank", rank),
                    ("eidx", eidx)):
        _want(t, name, _I32, lead + (W,), dev)
    _want(total, "total", _I32, lead, dev)
    for name, t in (("d_src", d_src), ("d_dst", d_dst),
                    ("d_rank", d_rank)):
        _want(t, name, _I32, (P, Dcap), dev)
    _want(d_valid, "d_valid", torch.bool, (P, Dcap), dev)
    _want(d_tomb, "d_tomb", _I32, (P, Tcap), dev)
    vmax = fbm.shape[-1]
    _bitmap_view(fbm, "fbm", lead + (vmax,), dev)
    if W < Dcap or P == 0 or vmax == 0:
        raise ValueError(f"slots of width {W} cannot hold {Dcap} delta "
                         f"rows over {P} parts of {vmax} rows")
    valid = torch.empty(lead + (W,), dtype=torch.bool, device=dev)
    total_out = torch.empty(lead, dtype=_I32, device=dev)
    _check(_lib().nt_merge_delta(
        total.data_ptr(), fbm.data_ptr(), fbm.stride(-2), vmax,
        d_src.data_ptr(), d_dst.data_ptr(), d_rank.data_ptr(),
        d_valid.data_ptr(), Dcap, d_tomb.data_ptr(), Tcap, P, L, W - Dcap,
        int(emax), parts, int(pid), src.data_ptr(), dst.data_ptr(),
        rank.data_ptr(),
        eidx.data_ptr(), valid.data_ptr(), total_out.data_ptr(),
        _stream(src)), "merge_delta")
    _count(merge_delta)
    return valid, total_out


# ---------------------------------------------------------------------------
# bfs_probe, bfs_level (K11)
# ---------------------------------------------------------------------------


PROBE_ROUTES = ("staged", "global")


def probe_stage_bytes(P: int, vmax: int) -> int:
    """Bytes of a (P, vmax) frontier as bits, the shared memory
    bfs_probe's staged route takes: mark's staged bitmap, the same
    bits."""
    return mark_stage_bytes(P, vmax)


def probe_route(P: int, vmax: int, smem_bytes: int = MARK_SMEM_BYTES) -> str:
    """The kernel `bfs_probe` launches for a (P, vmax) frontier: "staged"
    (each block copies the frontier's words into its shared memory and
    tests every slot there) where probe_stage_bytes(P, vmax) fits
    `smem_bytes`, else "global" (the same kernel reading the words from
    device memory, where they sit in L2)."""
    return "staged" if probe_stage_bytes(P, vmax) <= smem_bytes \
        else "global"


def bfs_probe_plain(src, nbr, keep, total, fbm, out, fbits=None):
    """Plain version of `bfs_probe`: for every slot j < total[p] whose
    nbr id is on the frontier (and kept, when keep is given), set
    out[src % P, src // P]; ids < 0 or outside [0, P*vmax) set nothing.
    Membership is read from fbm, or, given fbits, from its (P, W) words
    (bit i of word w = column 32w + i)."""
    P, EB = src.shape
    vmax = fbm.shape[1]
    nb = nbr.long()
    ok = (torch.arange(EB, device=src.device) < total[:, None]) \
        & (nb >= 0) & (nb < P * vmax)
    if keep is not None:
        ok &= keep
    nb = torch.where(ok, nb, 0)
    if fbits is None:
        on = fbm[nb % P, nb // P]
    else:
        col = nb // P
        on = ((fbits[nb % P, col >> 5] >> (col & 31)) & 1).bool()
    return mark_plain(src, P, vmax, keep=ok & on, out=out)


def bfs_probe(src, nbr, keep, total, fbm, out, fbits=None, route=None):
    """The bottom-up membership test over one reverse block's expanded
    slots (src the unvisited vertex, nbr its in-neighbour): OR into the
    (P, vmax) candidate bitmap `out` every src with a valid, kept slot
    whose nbr is set in the (P, vmax) frontier bitmap `fbm`.  fbm and out
    may each be the first vmax columns of a wider buffer.  keep=None
    keeps every valid slot.  fbits: fbm's (P, ceil(vmax / 32)) int32
    words (`bfs_level`'s fbits_out, or pack_bits(fbm[None])[0]); the
    kernel reads the frontier only there, so on the card it is required.
    `route` forces one of PROBE_ROUTES on the card (None: `probe_route`'s
    choice); the result is the same bit for bit.  Returns out, updated
    in place."""
    if route is not None and route not in PROBE_ROUTES:
        raise ValueError(f"route must be one of {PROBE_ROUTES}, got "
                         f"{route!r}")
    if src.device.type == "cpu":
        return bfs_probe_plain(src, nbr, keep, total, fbm, out, fbits)
    P, EB = src.shape
    vmax = fbm.shape[1]
    dev = src.device
    _want(src, "src", _I32, (P, EB), dev)
    _want(nbr, "nbr", _I32, (P, EB), dev)
    _want(total, "total", _I32, (P,), dev)
    if keep is not None:
        _want(keep, "keep", torch.bool, (P, EB), dev)
    _bitmap_view(fbm, "fbm", (P, vmax), dev)
    _bitmap_view(out, "out", (P, vmax), dev)
    if fbits is None:
        raise ValueError("bfs_probe on the card reads the frontier as "
                         "bits: pass fbits, fbm's (P, W) int32 words")
    _want(fbits, "fbits", _I32, (P, _words(vmax)), dev)
    if route is None:
        route = probe_route(P, vmax)
    elif route == "staged" and probe_route(P, vmax) != "staged":
        raise ValueError(f"a ({P}, {vmax}) frontier as bits does not fit "
                         f"a block's shared memory")
    if P * EB == 0:
        return out
    _check(_lib().nt_bfs_probe(
        src.data_ptr(), nbr.data_ptr(),
        None if keep is None else keep.data_ptr(), total.data_ptr(), P, EB,
        vmax, fbits.data_ptr(), route == "staged", out.data_ptr(),
        out.stride(0), _stream(src)), "bfs_probe")
    _count(bfs_probe, route)
    return out


def bfs_level_plain(cand, dist, level: int, fbm_out, unvis_out,
                    fbits_out=None, counts=None):
    """Plain version of `bfs_level`: new = cand & (dist < 0); dist =
    where(new, level, dist); fbm_out = new; unvis_out = dist < 0; given
    fbits_out, the (P, W) int32 words of new (pack_bits); cand cleared;
    all in place.  Returns (|new|, |unvis|) as a (2,) int64 tensor:
    `counts` with them added, when given, else a fresh one."""
    new = cand & (dist < 0)
    dist.copy_(torch.where(new, level, dist))
    unvis = dist < 0
    fbm_out.copy_(new)
    unvis_out.copy_(unvis)
    if fbits_out is not None:
        fbits_out.copy_(pack_bits_plain(new[None])[0])
    cand.zero_()
    found = torch.stack([new.sum(), unvis.sum()]).to(torch.int64)
    return found if counts is None else counts.add_(found)


def bfs_level(cand, dist, level: int, fbm_out, unvis_out, fbits_out=None,
              counts=None):
    """One BFS level update over the (P, vmax) int32 depth array `dist`,
    in place, one launch: the candidates `cand` not yet visited become
    the next frontier `fbm_out` at depth `level`, `unvis_out` is the
    next unvisited bitmap, and cand is cleared (its last reader in a
    level), ready for the next level's marks.  cand, fbm_out and
    unvis_out are (P, vmax) bool bitmaps (or the first vmax columns of
    wider buffers); cand must not share memory with the outputs.
    fbits_out, a (P, ceil(vmax / 32)) int32 tensor, gets the next
    frontier as words, the bits `bfs_probe` reads.  counts: a zeroed
    (2,) int64 tensor on the device (a row of a larger buffer) that
    (|new frontier|, |unvisited|) are added to; None zeroes a fresh one.
    Returns the counts; phantom slots count as unvisited."""
    if dist.device.type == "cpu":
        return bfs_level_plain(cand, dist, level, fbm_out, unvis_out,
                               fbits_out, counts)
    P, vmax = dist.shape
    dev = dist.device
    _want(dist, "dist", _I32, (P, vmax), dev)
    for name, t in (("cand", cand), ("fbm_out", fbm_out),
                    ("unvis_out", unvis_out)):
        _bitmap_view(t, name, (P, vmax), dev)
    if fbits_out is not None:
        _want(fbits_out, "fbits_out", _I32, (P, _words(vmax)), dev)
    if counts is None:
        counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    else:
        _want(counts, "counts", torch.int64, (2,), dev)
    if P * vmax == 0:
        return counts
    _check(_lib().nt_bfs_level(
        cand.data_ptr(), cand.stride(0), dist.data_ptr(), P, vmax,
        int(level), fbm_out.data_ptr(), fbm_out.stride(0),
        unvis_out.data_ptr(), unvis_out.stride(0),
        None if fbits_out is None else fbits_out.data_ptr(),
        counts.data_ptr(), _stream(dist)), "bfs_level")
    _count(bfs_level)
    return counts


# ---------------------------------------------------------------------------
# pack_bits, unpack_or (K15); owned_hub_bits, fill_hub_columns (K16)
# ---------------------------------------------------------------------------
#
# The sharded mesh's exchange (csrc/exchange.cu): a shard slot's (Ll, P,
# vmax) mark matrix is packed into (Ll, P, W) 32-bit words, W =
# ceil(vmax / 32), bit i of word w = column 32w + i; the transport ships
# row d to slot d; the slot ORs its P received rows and unpacks them into
# its next frontier.  The words are an int32 tensor holding the
# reference's uint32 bits (torch's uint32 has no CPU shifts, and the
# collectives carry int32).  Each wrapper takes a slot group's tensors
# with a leading slot axis (S, ...) and covers every slot in one launch
# (gpu/mesh.py `Mesh.groups`); the forms without it are the one-slot case.


def _words(vmax: int) -> int:
    return -(-int(vmax) // 32)


def _row_stride(t):
    """The one stride between consecutive rows of t, read as
    prod(shape[:-1]) rows of shape[-1] elements, or None where its
    leading axes do not step by whole rows uniformly."""
    shape, stride = t.shape, t.stride()
    ld, span = None, 1
    for i in range(len(shape) - 2, -1, -1):
        n = shape[i]
        if n > 1:
            if ld is None:
                ld = stride[i]
            elif stride[i] != ld * span:
                return None
        span *= n
    return shape[-1] if ld is None else ld


def _slot_axis(t, solo_ndim: int, name: str):
    """t with its leading slot axis: t itself in the group form, t[None]
    in the one-slot form."""
    if t.dim() == solo_ndim + 1:
        return t
    if t.dim() == solo_ndim:
        return t[None]
    raise ValueError(f"{name} must have {solo_ndim} axes, or {solo_ndim + 1}"
                     f" with a leading slot axis; got {tuple(t.shape)}")


def pack_bits_plain(marks):
    """Plain version of `pack_bits`: (..., P, vmax) bool → (..., P, W)
    int32, bit i of word w = marks[..., 32w + i], padding bits 0 (the
    reference's shift-weighted sum over disjoint bits)."""
    vmax = marks.shape[-1]
    W = _words(vmax)
    m = torch.nn.functional.pad(marks.to(torch.int64), (0, W * 32 - vmax))
    m = m.reshape(marks.shape[:-1] + (W, 32))
    weights = torch.ones((), dtype=torch.int64, device=marks.device) \
        << torch.arange(32, device=marks.device)
    v = (m * weights).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(_I32)


def pack_bits(marks):
    """Pack a slot's (Ll, P, vmax) bool mark matrix, or a slot group's
    (S, Ll, P, vmax) stack of them — rows contiguous, uniformly strided —
    into (..., W) int32 words, one launch."""
    if marks.device.type == "cpu":
        return pack_bits_plain(marks)
    dev = marks.device
    m = _slot_axis(marks, 3, "marks")
    ld = _row_stride(m)
    if m.dtype != torch.bool or (m.numel() and (
            m.stride(-1) != 1 or ld is None or ld < m.shape[-1])):
        raise ValueError(f"marks must be a bool bitmap with contiguous rows,"
                         f" uniformly strided; got {m.dtype} "
                         f"{tuple(m.shape)} strides {m.stride()}")
    vmax = m.shape[-1]
    W = _words(vmax)
    out = torch.empty(marks.shape[:-1] + (W,), dtype=_I32, device=dev)
    if out.numel() == 0:
        return out
    rows = m.numel() // vmax
    _check(_lib().nt_pack_bits(m.data_ptr(), rows, vmax, ld, W,
                               out.data_ptr(), _stream(marks)), "pack_bits")
    _count(pack_bits)
    return out


def unpack_or_plain(recv, vmax: int, out):
    """Plain version of `unpack_or`: out[..., l, c] = bit c of the OR
    over p of recv[..., l, p, :], for c < vmax; in place."""
    ored = recv[..., 0, :]
    for p in range(1, recv.shape[-2]):
        ored = ored | recv[..., p, :]
    bits = (ored[..., None] >> torch.arange(32, device=recv.device)) & 1
    out.copy_(bits.reshape(ored.shape[:-1] + (-1,))[..., :vmax].bool())
    return out


def unpack_or(recv, vmax: int, out):
    """OR the P received word rows of a slot, (Ll, P, W) int32, and unpack
    them into `out`, its (Ll, vmax) next-frontier bitmap — or do so for
    every slot of a group at once: recv (S, Ll, P, W), out (S, Ll, vmax).
    recv may have any strides but a unit-stride word axis (the
    transport's view); out is the first vmax columns of the slots'
    buffers, any row strides.  One launch.  Returns out."""
    if recv.device.type == "cpu":
        return unpack_or_plain(recv, vmax, out)
    dev = recv.device
    r = _slot_axis(recv, 3, "recv")
    o = _slot_axis(out, 2, "out")
    S, L, P, W = r.shape
    if r.dtype != _I32 or (r.numel() and r.stride(-1) != 1):
        raise ValueError(f"recv must be int32 words with a unit-stride word "
                         f"axis; got {r.dtype} strides {r.stride()}")
    if W != _words(vmax) or P < 1:
        raise ValueError(f"{P} rows of {W} words cannot hold {vmax} "
                         f"columns")
    if o.device != dev or o.dtype != torch.bool \
            or tuple(o.shape) != (S, L, vmax) \
            or (o.numel() and o.stride(-1) != 1):
        raise ValueError(f"out must be a {(S, L, vmax)} bool bitmap on "
                         f"{dev} with contiguous rows; got {o.dtype} "
                         f"{tuple(o.shape)} on {o.device}")
    if S * L * vmax == 0:
        return out
    _check(_lib().nt_unpack_or(r.data_ptr(), S, L, P, W, r.stride(0),
                               r.stride(1), r.stride(2), vmax, o.stride(0),
                               o.stride(1), o.data_ptr(), _stream(recv)),
           "unpack_or")
    _count(unpack_or)
    return out


def owned_hub_bits_plain(fbm, pid: int, hub_owner, hub_local):
    """Plain version of `owned_hub_bits`: (Ll, H) int32, 1 where hub h is
    owned by slot s of the group (part pid + s) and its bit
    fbm[s, l, 0, hub_local[h]] is set (the reference's
    `where(hub_owner == pid, fbm[hub_local], False)`, over the group)."""
    f = _slot_axis(fbm, 3, "fbm")
    slot = hub_owner.long() - int(pid)
    mine = (slot >= 0) & (slot < f.shape[0])
    bits = f[slot.clamp(0, f.shape[0] - 1), :, 0, hub_local.long()]
    return (bits.T & mine).to(_I32)


def owned_hub_bits(fbm, pid: int, hub_owner, hub_local):
    """The hub bits a shard slot owns, from its (Ll, 1, vmax + H) frontier
    buffer (`pid` its part) — or a slot group's, from the group's (S, Ll,
    1, vmax + H) buffers (`pid` the first slot's part; the group's slots
    hold consecutive parts): (Ll, H) int32, one launch.  The transport
    sums them over the groups (`fill_hub_columns` then sets the hub
    columns)."""
    if fbm.device.type == "cpu":
        return owned_hub_bits_plain(fbm, pid, hub_owner, hub_local)
    dev = fbm.device
    f = _slot_axis(fbm, 3, "fbm")
    S, L, rows, width = f.shape
    H = int(hub_owner.numel())
    _want(f, "fbm", torch.bool, (S, L, 1, width), dev)
    _want(hub_owner, "hub_owner", _I32, (H,), dev)
    _want(hub_local, "hub_local", _I32, (H,), dev)
    if S < 1:
        raise ValueError("fbm holds no slot")
    out = torch.empty((L, H), dtype=_I32, device=dev)
    if L * H == 0:
        return out
    _check(_lib().nt_owned_hub_bits(f.data_ptr(), S, L, L * width, width,
                                    int(pid), hub_owner.data_ptr(),
                                    hub_local.data_ptr(), H,
                                    out.data_ptr(), _stream(fbm)),
           "owned_hub_bits")
    _count(owned_hub_bits)
    return out


def fill_hub_columns_plain(fbm, summed):
    """Plain version of `fill_hub_columns`: fbm[..., l, 0, vmax + h] =
    summed[l, h] > 0 for every slot, in place."""
    H = summed.shape[1]
    fbm[..., 0, fbm.shape[-1] - H:] = summed > 0
    return fbm


def fill_hub_columns(fbm, summed):
    """Set the H hub columns of a shard slot's (Ll, 1, vmax + H) frontier
    buffer — or of every slot's in a group's (S, Ll, 1, vmax + H) — from
    the (Ll, H) int32 hub bits summed over the slots, one launch.
    Returns fbm, updated in place."""
    if fbm.device.type == "cpu":
        return fill_hub_columns_plain(fbm, summed)
    dev = fbm.device
    f = _slot_axis(fbm, 3, "fbm")
    S, L, rows, width = f.shape
    H = summed.shape[1] if summed.dim() == 2 else -1
    _want(f, "fbm", torch.bool, (S, L, 1, width), dev)
    _want(summed, "summed", _I32, (L, H), dev)
    if H > width:
        raise ValueError(f"{H} hub columns in a buffer {width} wide")
    if S * L * H == 0:
        return fbm
    _check(_lib().nt_fill_hub_columns(f.data_ptr(), S * L, L, width,
                                      width - H, summed.data_ptr(), H,
                                      _stream(fbm)), "fill_hub_columns")
    _count(fill_hub_columns)
    return fbm


for _fn in _own_wrappers():
    _fn.launches = 0
bfs_probe.route_launches = dict.fromkeys(PROBE_ROUTES, 0)
expand.route_launches = {"hub owners": 0}
