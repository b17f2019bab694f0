"""The hand-written CUDA kernels of the GO path: build, load, wrappers.

Three kernels, sources in `nebula_tpu_torch/csrc/`:

  expand            Queue B K1 — frontier-bitmap CSR expansion
                    (nebula_tpu/tpu/hop.py:_expand_block :58)
  mark              K2 / K6 — kept dst ids into the (P, vmax) bitmap
                    (hop.py:_mark :168, runtime.py:_seed_builder :969)
  compact_capture   K3 + K5 — stable compaction of the final hop and
                    the YIELD column gather (hop.py:_compact_cap :238,
                    _build_local_fn :543-550)

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
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("expand.cu", "mark.cu", "compact_capture.cu")
HEADERS = ("scan.cuh",)
MAX_COLS = 4                  # yield columns compact_capture gathers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I32 = torch.int32
_lib_cache: dict = {}


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
    (the sources do not change while it runs)."""
    lib = _lib_cache.get("lib")
    if lib is not None:
        return lib
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nt_scan_chunk.argtypes, lib.nt_scan_chunk.restype = [], I
    lib.nt_expand_scan.argtypes = [P, P, I, I, P, P, P, P]
    lib.nt_expand_fill.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                   P, P, P, P, P]
    lib.nt_mark.argtypes = [P, P, LL, I, I, P, P]
    lib.nt_compact_capture.argtypes = ([P] * 5 + [I] * 4 + [P] * 4
                                       + [P] * 4 + [P] * 4 + [P, P, P])
    for fn in (lib.nt_expand_scan, lib.nt_expand_fill, lib.nt_mark,
               lib.nt_compact_capture):
        fn.restype = I
    _lib_cache["lib"] = lib
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launch_counts() -> None:
    for fn in (expand, mark, compact_capture):
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in (expand, mark,
                                                compact_capture)}


# ---------------------------------------------------------------------------
# expand (K1)
# ---------------------------------------------------------------------------


def expand_plain(indptr, nbr, rank, fbm):
    """Plain version of `expand`: (src, dst, rank, eidx) (P, EB) int32
    and total (P,) int32, EB = max(total).  Slot j < total[p] of part p
    is edge eidx of row `row`, where row is the frontier row whose
    degree range holds j; slots past total[p] are padding (-1, -1, 0,
    0)."""
    P, vmax = fbm.shape
    deg = torch.where(fbm, indptr[:, 1:] - indptr[:, :-1], 0).to(_I32)
    ends = torch.cumsum(deg, 1, dtype=_I32)
    total = ends[:, -1].contiguous()
    starts = ends - deg
    EB = int(total.max()) if P else 0
    dev = fbm.device
    j = torch.arange(EB, dtype=_I32, device=dev).expand(P, EB).contiguous()
    valid = j < total[:, None]
    row = torch.searchsorted(ends, j, right=True)
    row = torch.where(valid, row, 0)
    eidx = torch.gather(indptr, 1, row) + (j - torch.gather(starts, 1, row))
    eidx = torch.where(valid, eidx, 0).to(_I32)
    el = eidx.long()
    dst = torch.where(valid, torch.gather(nbr, 1, el), -1).to(_I32)
    rk = torch.where(valid, torch.gather(rank, 1, el), 0).to(_I32)
    pid = torch.arange(P, dtype=torch.int64, device=dev)[:, None]
    src = torch.where(valid, row * P + pid, -1).to(_I32)
    return src, dst, rk, eidx, total


def expand(indptr, nbr, rank, fbm):
    """Expand one block's CSR from the (P, vmax) bool frontier bitmap.
    Returns (src, dst, rank, eidx, total) as `expand_plain` does."""
    if fbm.device.type == "cpu":
        return expand_plain(indptr, nbr, rank, fbm)
    P, vmax = fbm.shape
    emax = nbr.shape[1]
    dev = fbm.device
    _want(fbm, "fbm", torch.bool, (P, vmax), dev)
    _want(indptr, "indptr", _I32, (P, vmax + 1), dev)
    _want(nbr, "nbr", _I32, (P, emax), dev)
    _want(rank, "rank", _I32, (P, emax), dev)
    lib = _lib()
    starts = torch.empty((P, vmax), dtype=_I32, device=dev)
    total = torch.empty((P,), dtype=_I32, device=dev)
    sums = torch.empty((P, max(_cdiv(vmax, lib.nt_scan_chunk()), 1)),
                       dtype=_I32, device=dev)
    stream = _stream(fbm)
    _check(lib.nt_expand_scan(indptr.data_ptr(), fbm.data_ptr(), P, vmax,
                              starts.data_ptr(), total.data_ptr(),
                              sums.data_ptr(), stream), "expand scan")
    EB = int(total.max()) if P else 0        # the one read per hop
    outs = [torch.empty((P, EB), dtype=_I32, device=dev) for _ in range(4)]
    if EB:
        _check(lib.nt_expand_fill(
            indptr.data_ptr(), nbr.data_ptr(), rank.data_ptr(),
            fbm.data_ptr(), starts.data_ptr(), total.data_ptr(), P, vmax,
            emax, EB, *[o.data_ptr() for o in outs], stream), "expand fill")
    expand.launches += 1
    return (*outs, total)


# ---------------------------------------------------------------------------
# mark (K2, K6)
# ---------------------------------------------------------------------------


def mark_plain(ids, P: int, vmax: int, keep=None, out=None):
    """Plain version of `mark`: set out[d % P, d // P] for every kept id
    d in [0, P*vmax); ids < 0 or outside the range set nothing."""
    if out is None:
        out = torch.zeros((P, vmax), dtype=torch.bool, device=ids.device)
    d = ids.reshape(-1).long()
    sel = (d >= 0) & (d < P * vmax)
    if keep is not None:
        sel &= keep.reshape(-1)
    d = d[sel]
    out.view(-1)[(d % P) * vmax + d // P] = True
    return out


def mark(ids, P: int, vmax: int, keep=None, out=None):
    """OR the kept int32 dense ids into a (P, vmax) bool bitmap (`out`,
    or a fresh zero bitmap).  keep=None keeps every id >= 0."""
    if out is None:
        out = torch.zeros((P, vmax), dtype=torch.bool, device=ids.device)
    if ids.device.type == "cpu":
        return mark_plain(ids, P, vmax, keep, out)
    dev = ids.device
    _want(ids, "ids", _I32, ids.shape, dev)
    _want(out, "out", torch.bool, (P, vmax), dev)
    if keep is not None:
        _want(keep, "keep", torch.bool, ids.shape, dev)
    n = ids.numel()
    if n == 0:
        return out
    keep_ptr = None if keep is None else keep.data_ptr()
    _check(_lib().nt_mark(ids.data_ptr(), keep_ptr, n, P, vmax,
                          out.data_ptr(), _stream(ids)), "mark")
    mark.launches += 1
    return out


# ---------------------------------------------------------------------------
# compact_capture (K3 + K5)
# ---------------------------------------------------------------------------


def compact_capture_plain(src, dst, rank, eidx, keep,
                          cols: Sequence[torch.Tensor] = ()):
    """Plain version of `compact_capture`: per part, the kept slots of
    src/dst/rank/eidx in order at the front of the row, each yield
    column's value at [p, eidx] beside them, kcount (P,) int32; the rest
    of each row is padding (-1, -1, 0, 0, column words 0)."""
    P, EB = keep.shape
    kcount = keep.sum(1, dtype=_I32)
    pos = torch.cumsum(keep, 1, dtype=torch.int64) - 1
    pi, si = keep.nonzero(as_tuple=True)
    di = pos[pi, si]

    def put(a, fill):
        o = torch.full_like(a, fill)
        o[pi, di] = a[pi, si]
        return o

    outs = [put(src, -1), put(dst, -1), put(rank, 0), put(eidx, 0)]
    e = eidx[pi, si].long()
    props = []
    for c in cols:
        ok = (e >= 0) & (e < c.shape[1])
        o = torch.zeros((P, EB), dtype=c.dtype, device=c.device)
        o[pi, di] = torch.where(ok, c[pi, e.clamp(0, c.shape[1] - 1)],
                                torch.zeros((), dtype=c.dtype,
                                            device=c.device))
        props.append(o)
    return (*outs, props, kcount)


def compact_capture(src, dst, rank, eidx, keep,
                    cols: Sequence[torch.Tensor] = ()):
    """Compact the kept slots of each part to the front of its row and
    gather up to four 8-byte YIELD columns at their eidx.  Returns
    (src, dst, rank, eidx, [cols], kcount) as `compact_capture_plain`."""
    if keep.device.type == "cpu":
        return compact_capture_plain(src, dst, rank, eidx, keep, cols)
    P, EB = keep.shape
    dev = keep.device
    _want(keep, "keep", torch.bool, (P, EB), dev)
    for name, t in (("src", src), ("dst", dst), ("rank", rank),
                    ("eidx", eidx)):
        _want(t, name, _I32, (P, EB), dev)
    if len(cols) > MAX_COLS:
        raise ValueError(f"compact_capture gathers at most {MAX_COLS} "
                         f"columns, got {len(cols)}")
    emax = cols[0].shape[1] if cols else 0
    for i, c in enumerate(cols):
        if c.dtype not in (torch.int64, torch.float64):
            raise ValueError(f"column {i} is {c.dtype}; int64 or float64")
        _want(c, f"column {i}", c.dtype, (P, emax), dev)
    lib = _lib()
    outs = [torch.empty((P, EB), dtype=_I32, device=dev) for _ in range(4)]
    props: List[torch.Tensor] = [torch.empty((P, EB), dtype=c.dtype,
                                             device=dev) for c in cols]
    kcount = torch.empty((P,), dtype=_I32, device=dev)
    sums = torch.empty((P, max(_cdiv(EB, lib.nt_scan_chunk()), 1)),
                       dtype=_I32, device=dev)
    in_cols = [c.data_ptr() for c in cols] + [None] * (MAX_COLS - len(cols))
    out_cols = [o.data_ptr() for o in props] + [None] * (MAX_COLS
                                                         - len(props))
    _check(lib.nt_compact_capture(
        src.data_ptr(), dst.data_ptr(), rank.data_ptr(), eidx.data_ptr(),
        keep.data_ptr(), P, EB, len(cols), emax, *in_cols,
        *[o.data_ptr() for o in outs], *out_cols, kcount.data_ptr(),
        sums.data_ptr(), _stream(keep)), "compact_capture")
    compact_capture.launches += 1
    return (*outs, props, kcount)


expand.launches = 0
mark.launches = 0
compact_capture.launches = 0
