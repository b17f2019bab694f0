"""Where bench.py config 5's device BFS spends its time on one CUDA card.

    python3 -m nebula_tpu_torch.bench.bfs_profile [--persons N] [--runs R]
                                                  [--split T] [--filtered]

Builds the north-star graph of chip_smoke.py (datagen.north_star(N)),
pins it — degree-split at threshold T, 2048 by default as bench.py runs
it, or unsplit with --split 0 — warms up, then runs R BFS of config 5,
`bfs(store, "ns", [seeds[0]], ["KNOWS"], "out", 5)` (with --filtered,
WHERE KNOWS.w > 50), and prints one JSON line with:
  phases_ms  the median TraverseStats phases (seed put, device level
             loop, total) over the R runs;
  hop_edges, e_cap  the last run's slots and slot width per level;
  kernels    device time by kernel name over the profiled window
             (torch.profiler, CUDA activity), with launch counts;
  busy_share device time of all kernels and copies / the window's wall
             time — 1 minus it is the device's idle share;
  working_set_bytes  torch.cuda.max_memory_allocated() over the window
             minus what was allocated before it (the pinned snapshot).
Times are the card's: run it where `torch.cuda.is_available()`.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--split", type=int, default=2048,
                    help="degree-split threshold (0 = unsplit)")
    ap.add_argument("--filtered", action="store_true",
                    help="WHERE KNOWS.w > 50 at every level")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bfs_profile: CUDA is not available", file=sys.stderr)
        return 2
    from ..gpu import GpuRuntime
    from .datagen import north_star
    from .go_profile import profiled

    ns = north_star(args.persons, split_threshold=args.split)
    rt = GpuRuntime(degree_split_threshold=ns.split_threshold)
    rt.pin_prebuilt(ns.snap)
    filt = ns.w_filter if args.filtered else None

    def run():
        return rt.bfs(ns.store, "ns", ns.seeds[:1], ["KNOWS"], "out", 5,
                      edge_filter=filt)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats, window_us, device_us, kernels = profiled(run, args.runs)
    phases = {k: float(np.median([getattr(s, k) for s in stats])) * 1e3
              for k in ("put_s", "device_s", "total_s")}
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "runs": args.runs,
        "split": args.split, "filtered": args.filtered,
        "hubs": rt.snapshots["ns"].num_hubs, "seed": ns.seeds[0],
        "hop_edges": stats[-1].hop_edges, "e_cap": stats[-1].e_cap,
        "phases_ms": phases,
        "window_ms": window_us / 1e3, "device_ms": device_us / 1e3,
        "busy_share": device_us / window_us,
        "working_set_bytes": torch.cuda.max_memory_allocated() - base,
        "pinned_bytes": rt.hbm_bytes(), "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
