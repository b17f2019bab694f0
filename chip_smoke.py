#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one NVIDIA GPU and prove its GO path.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                 # the north-star size
    python3 chip_smoke.py --persons 20000 # a quick check

Phases, in order; any failure exits non-zero before the result line:
  1. the card's name and power limit (nvidia-smi) and torch's name for it;
  2. build the kernels from nebula_tpu_torch/csrc (nvcc, sm_90a);
  3. the north-star GO (datagen.north_star): make_social_arrays(persons,
     30, seed=7) → snapshot_from_arrays(parts=8) → GpuRuntime().pin_prebuilt,
     then GO 3 STEPS from 16 seeds YIELD dst(edge) AS d, KNOWS.w AS w,
     unfiltered and WHERE KNOWS.w > 50, each checked against the host
     oracle host_csr_traverse (rows by lexsorted equality, traversed
     edges by count); launch counters are zeroed just before and read
     just after, and every kernel must have launched;
  4. each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it (expand at hop 3, mark at hop 2 and
     for the seeds, compact_capture at the filtered hop 3, with the w
     column and again with the int64/float64 columns w, f, city, w): exact
     equality, kernel / plain / one-library-call times from CUDA events,
     and the byte bound at 3.35 TB/s;
  5. the `kernels` JSON line, the card line, and the result line
     {"ok": true, "device": {...}} last.
Without CUDA it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT32_OPS_PER_S = 33.5e12        # half the 67 TFLOP/s float32 CUDA-core rate
ROUTE_SOURCES = {
    "expand": ("nebula_tpu_torch/csrc/expand.cu",
               "nebula_tpu/tpu/hop.py:58"),
    "mark": ("nebula_tpu_torch/csrc/mark.cu",
             "nebula_tpu/tpu/hop.py:168"),
    "compact_capture": ("nebula_tpu_torch/csrc/compact_capture.cu",
                        "nebula_tpu/tpu/hop.py:238"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, by CUDA events,
    after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over tensors that must be identical; also
    raises unless they are equal bit for bit."""
    import torch
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if a.dtype == torch.float64:
            both_nan = a.isnan() & b.isnan()
            d = torch.where(both_nan, 0.0, (a - b).abs())
            bits_equal = torch.equal(a.view(torch.int64),
                                     b.view(torch.int64))
        else:
            d = (a.long() - b.long()).abs()
            bits_equal = torch.equal(a, b)
        if d.numel():
            err = max(err, float(d.max()))
        if not bits_equal:
            raise AssertionError(f"kernel differs from plain version "
                                 f"(max abs err {err})")
    return err


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from nebula_tpu_torch.bench.datagen import host_csr_traverse, north_star
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu import kernels as K

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    path, build_s, report = K.build()
    log(f"[2] built {path.name} in {build_s:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("    " + line.strip())

    # -- 3. the north-star GO ----------------------------------------------
    t0 = time.perf_counter()
    ns = north_star(args.persons)
    snap, store, seeds, yields = ns.snap, ns.store, ns.seeds, ns.yields
    log(f"[3] graph: {args.persons} persons, {ns.n_edges} KNOWS edges,"
        f" built in {time.perf_counter() - t0:.1f} s")
    rt = GpuRuntime()
    t0 = time.perf_counter()
    rt.pin_prebuilt(snap)
    torch.cuda.synchronize()
    log(f"    pinned {rt.hbm_bytes()} bytes in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    results = {}
    for label, filt, w_gt in (("unfiltered", None, None),
                              (f"w>{ns.w_gt}", ns.w_filter, ns.w_gt)):
        lat, dev_lat = [], []
        for _ in range(args.repeats + 1):      # the first run is warm-up
            t = time.perf_counter()
            rows, st = rt.traverse(store, "ns", seeds, ["KNOWS"], "out", 3,
                                   edge_filter=filt, yields=yields)
            lat.append(time.perf_counter() - t)
            dev_lat.append(st.device_s)
        total, kept, want_d, want_w = host_csr_traverse(
            snap, seeds, 3, w_gt=w_gt, materialize=True)
        if st.edges_traversed() != total or len(rows) != kept:
            raise AssertionError(f"{label}: edges {st.edges_traversed()} vs "
                                 f"{total}, rows {len(rows)} vs {kept}")
        d = np.asarray(rows.column_array("d"), np.int64)
        w = np.asarray(rows.column_array("w"), np.int64)
        a, b = np.lexsort((w, d)), np.lexsort((want_w, want_d))
        if not (np.array_equal(d[a], want_d[b])
                and np.array_equal(w[a], want_w[b])):
            raise AssertionError(f"{label}: rows differ from the oracle")
        p50 = float(np.median(lat[1:]))
        results[label] = {
            "rows": len(rows), "edges": total,
            "hop_edges": st.hop_edges, "frontier_sizes": st.frontier_sizes,
            "e_cap": st.e_cap, "p50_ms": p50 * 1e3,
            "min_ms": min(lat[1:]) * 1e3, "max_ms": max(lat[1:]) * 1e3,
            "device_p50_ms": float(np.median(dev_lat[1:])) * 1e3,
            "fetch_ms": st.fetch_s * 1e3, "mat_ms": st.mat_s * 1e3,
            "edges_per_s": total / p50, "samples": len(lat) - 1}
        log(f"    GO 3 STEPS {label}: {json.dumps(results[label])}")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    queries = 2 * (args.repeats + 1)
    log(f"    launches over {queries} queries: {launches}; hbm_bytes "
        f"{rt.hbm_bytes()}; max_memory_allocated {peak}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    # -- 4. kernels against their plain versions at the path's shapes ----
    dev = rt.snapshots["ns"]
    blk = dev.blocks[("KNOWS", "out")]
    P, vmax = dev.num_parts, dev.vmax
    seed_ids = torch.tensor(sorted(set(seeds)), dtype=torch.int32,
                            device=rt.device)
    fbm = K.mark_plain(seed_ids, P, vmax)
    hop_in = [fbm]
    for _ in range(2):                         # frontiers entering hops 2, 3
        src, dst, rk, eidx, total = K.expand_plain(blk.indptr, blk.nbr,
                                                   blk.rank, hop_in[-1])
        hop_in.append(K.mark_plain(dst, P, vmax))
    dst2 = K.expand_plain(blk.indptr, blk.nbr, blk.rank, hop_in[1])[1]
    fbm3 = hop_in[2]
    reps = 20
    rows_out = []

    def record(name, got, want, ms, plain_ms, lib_ms, nbytes, ops):
        err = max_abs_err(got, want)
        b_ms, b_by = bound(nbytes, ops)
        src_path, replaces = ROUTE_SOURCES[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        log(f"[4] {name}: {json.dumps(rows_out[-1])}")

    # expand at hop 3
    args3 = (blk.indptr, blk.nbr, blk.rank, fbm3)
    got = K.expand(*args3)
    want = K.expand_plain(*args3)
    tot = int(want[4].sum())
    EB3 = want[0].shape[1]
    nbytes = (P * (vmax + 1) * 4 + P * vmax + 8 * tot
              + 16 * P * EB3 + 4 * P)

    def lib_expand(indptr=blk.indptr, nbr=blk.nbr, rank=blk.rank,
                   f=fbm3):
        # repeat_interleave of the active rows over their degrees
        rows = f.view(-1).nonzero().view(-1)
        p, r = rows // vmax, rows % vmax
        beg = indptr[p, r].long()
        deg = indptr[p, r + 1].long() - beg
        slot_row = torch.repeat_interleave(torch.arange(
            rows.numel(), device=f.device), deg)
        off = torch.arange(slot_row.numel(), device=f.device) \
            - torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
        e = beg[slot_row] + off
        return nbr[p[slot_row], e], rank[p[slot_row], e]

    record("expand", got, want,
           cuda_ms(lambda: K.expand(*args3), reps),
           cuda_ms(lambda: K.expand_plain(*args3), reps),
           cuda_ms(lib_expand, reps), nbytes,
           P * vmax * 3 + tot)

    # mark at hop 2 (the largest mark of the path), then the seed call
    n2 = dst2.numel()
    got = [K.mark(dst2, P, vmax)]
    want = [K.mark_plain(dst2, P, vmax)]
    keep2 = (dst2 % 3) == 0
    got.append(K.mark(dst2, P, vmax, keep=keep2))
    want.append(K.mark_plain(dst2, P, vmax, keep=keep2))
    got.append(K.mark(seed_ids, P, vmax))
    want.append(K.mark_plain(seed_ids, P, vmax))

    def lib_mark(d=dst2):
        out = torch.zeros((P, vmax), dtype=torch.bool, device=d.device)
        dl = d.view(-1).long()
        dl = dl[dl >= 0]
        out.index_put_((dl % P, dl // P), torch.ones((), dtype=torch.bool,
                                                     device=d.device))
        return out

    record("mark", got, want,
           cuda_ms(lambda: K.mark(dst2, P, vmax), reps),
           cuda_ms(lambda: K.mark_plain(dst2, P, vmax), reps),
           cuda_ms(lib_mark, reps), 4 * n2 + P * vmax, 3 * n2)

    # compact_capture at the filtered hop 3 with the w yield column (the
    # main path's call), then with four columns of both word types
    src, dst, rk, eidx, total = K.expand_plain(*args3)
    keep = torch.arange(EB3, dtype=torch.int32, device=rt.device) \
        < total[:, None]
    keep &= torch.gather(blk.props["w"], 1, eidx.long()) > ns.w_gt
    cargs = (src, dst, rk, eidx, keep, [blk.props["w"]])
    got, want = [], []
    for cols in (cargs[5], [blk.props[c] for c in ("w", "f", "city", "w")]):
        for out, fn in ((got, K.compact_capture),
                        (want, K.compact_capture_plain)):
            r = fn(*cargs[:5], cols)
            out.extend([*r[:4], *r[4], r[5]])
    kept = int(want[-1].sum())

    def lib_compact(a=cargs):
        pi, si = a[4].nonzero(as_tuple=True)
        flat = pi * EB3 + si
        outs = [t.view(-1).index_select(0, flat) for t in a[:4]]
        outs.append(a[5][0][pi, a[3][pi, si].long()])
        return outs

    record("compact_capture", got, want,
           cuda_ms(lambda: K.compact_capture(*cargs), reps),
           cuda_ms(lambda: K.compact_capture_plain(*cargs), reps),
           cuda_ms(lib_compact, reps),
           # every slot's 17 bytes: at about half kept, each 32-byte sector
           # holds a kept slot (see compact_capture.cu)
           17 * P * EB3 + 8 * kept + (16 + 8) * P * EB3 + 4 * P,
           2 * P * EB3)

    # -- 5. result ---------------------------------------------------------
    log(json.dumps({"go3": results, "hbm_bytes": rt.hbm_bytes(),
                    "max_memory_allocated": peak, "queries": queries}))
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
