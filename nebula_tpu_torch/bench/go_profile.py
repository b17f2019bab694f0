"""Where a north-star GO 3 STEPS spends its time on one CUDA card.

    python3 -m nebula_tpu_torch.bench.go_profile [--persons N] [--queries Q]
                                                 [--split T]

Builds the north-star graph of chip_smoke.py (datagen.north_star(N)),
pins it — degree-split at threshold T, 2048 by default as bench.py runs
it, or unsplit with --split 0 — warms up, then runs Q queries of its
GO 3 STEPS WHERE
KNOWS.w > 50 YIELD dst(edge), KNOWS.w and prints one JSON line with:
  phases_ms  the median TraverseStats phases (seed put, device hop loop,
             fetch, host materialization, total) over the Q queries;
  kernels    device time by kernel name over the profiled window
             (torch.profiler, CUDA activity), with launch counts;
  busy_share device time of all kernels and copies / the window's wall
             time — 1 minus it is the device's idle share.
Times are the card's: run it where `torch.cuda.is_available()`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict


def profiled(call, n: int, warm: int = 2):
    """Run call() `warm` times, then n times under torch.profiler.
    Returns (the n results' stats, window µs, device µs, the top 25
    device activities by time as {name, calls, ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    stats = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            stats.append(call()[1])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name[evt.name]
            rec[0] += 1
            rec[1] += evt.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    device_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return stats, window_us, device_us, [
        {"name": name[:90], "calls": c, "ms": us / 1e3}
        for name, (c, us) in top[:25]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--split", type=int, default=2048,
                    help="degree-split threshold (0 = unsplit)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("go_profile: CUDA is not available", file=sys.stderr)
        return 2
    from ..gpu import GpuRuntime
    from .datagen import north_star

    ns = north_star(args.persons, split_threshold=args.split)
    rt = GpuRuntime(degree_split_threshold=ns.split_threshold)
    rt.pin_prebuilt(ns.snap)

    def query():
        return rt.traverse(ns.store, "ns", ns.seeds, ["KNOWS"], "out", 3,
                           edge_filter=ns.w_filter, yields=ns.yields)

    stats, window_us, device_us, kernels = profiled(query, args.queries)
    phases = {k: float(np.median([getattr(s, k) for s in stats])) * 1e3
              for k in ("put_s", "device_s", "fetch_s", "mat_s", "total_s")}
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "queries": args.queries,
        "split": args.split, "hubs": rt.snapshots["ns"].num_hubs,
        "e_cap": stats[-1].e_cap,
        "edges_per_query": stats[-1].edges_traversed(),
        "rows_per_query": stats[-1].result_edges,
        "phases_ms": phases,
        "window_ms": window_us / 1e3, "device_ms": device_us / 1e3,
        "busy_share": device_us / window_us, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
