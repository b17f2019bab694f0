"""algo-bench — device vs numpy-host A/B per algorithm on the north-star
social array graph, the port's copy of `nebula_tpu/tools/algo_bench.py`.

Per algorithm:

  device_s    median end-to-end device run (prep cached, kernels warm)
  host_s      median numpy-oracle run (power iteration / union-find /
              Dijkstra — genuinely different algorithm families)
  speedup     host_s / device_s
  iterations  device iterations to convergence/cap
  iter_ms_p50 per-iteration device wall ms (p50 over the timed runs)
  rows_match  device rows == oracle rows (exact for wcc/sssp;
              pagerank max |Δrank| reported, bar PAGERANK_TOL)

The work is fixed: PageRank runs 20 iterations on both sides (tol=0),
WCC runs to convergence, SSSP runs from vid 0 weighted by the w prop.

Usage (on a machine with a CUDA card; the runtime defaults to cuda:0):
    python3 -m nebula_tpu_torch.tools.algo_bench
    python3 -m nebula_tpu_torch.tools.algo_bench --persons 300000 \\
        --degree 30

Prints one JSON object on stdout.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

PAGERANK_TOL = 1e-8        # documented rank parity bar (abs, per vid)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def _build_graph(persons: int, degree: int, parts: int, seed: int):
    from ..bench.datagen import (SnapshotStore, make_social_arrays,
                                 snapshot_from_arrays)
    arrs = make_social_arrays(persons, degree, seed=seed)
    snap = snapshot_from_arrays(arrs, parts=parts, space="algo_ns")
    return SnapshotStore(snap), snap


def run_suite(persons: int = 120_000, degree: int = 12,
              parts: int = 8, seed: int = 7, repeats: int = 3,
              runtime=None,
              algos=("pagerank", "wcc", "sssp")) -> Dict:
    """Device-vs-host A/B per algorithm on one social array graph, on
    `runtime` (a GpuRuntime; None means GpuRuntime(), cuda:0)."""
    from ..algo.engine import run_algorithm
    from ..gpu import GpuRuntime
    rt = runtime if runtime is not None else GpuRuntime()
    store, snap = _build_graph(persons, degree, parts, seed)
    sd = store.space("algo_ns")

    base_params: Dict[str, Dict] = {
        # fixed work on both sides: tol=0 never converges early
        "pagerank": {"max_iter": 20, "tol": 0.0},
        "wcc": {},
        "sssp": {"src": 0, "weight": "w"},
    }
    out: Dict = {"graph": {"persons": persons, "degree": degree,
                           "parts": parts,
                           "edges": int(snap.block("KNOWS", "out")
                                        .indptr[:, -1].sum())}}
    for func in algos:
        params = dict(base_params[func])
        # warmup: kernel build + edge-array upload settle
        run_algorithm(func, {**params, "mode": "device"}, snap, sd, rt=rt)
        dev_lat, host_lat, iter_all = [], [], []
        dev_rows = host_rows = None
        iters = 0
        for _ in range(repeats):
            iter_us: List[int] = []
            t0 = time.perf_counter()
            dev_rows, info = run_algorithm(
                func, {**params, "mode": "device"}, snap, sd, rt=rt,
                iter_us=iter_us)
            dev_lat.append(time.perf_counter() - t0)
            iters = info["iterations"]
            iter_all.extend(iter_us)
            t0 = time.perf_counter()
            host_rows, _ = run_algorithm(
                func, {**params, "mode": "host"}, snap, sd)
            host_lat.append(time.perf_counter() - t0)
        if func == "pagerank":
            dv = {r[0]: r[1] for r in dev_rows}
            hv = {r[0]: r[1] for r in host_rows}
            same_vids = set(dv) == set(hv)
            # diff over the intersection so a vid-domain parity bug
            # reports rows_match=False with the diff intact
            max_diff = max((abs(dv[k] - hv[k]) for k in dv
                            if k in hv), default=0.0)
            rows_match = same_vids and max_diff <= PAGERANK_TOL
        else:
            max_diff = 0.0
            rows_match = dev_rows == host_rows
        dev_s, host_s = _median(dev_lat), _median(host_lat)
        out[func] = {
            "device_s": dev_s,
            "host_s": host_s,
            "speedup": host_s / dev_s if dev_s > 0 else 0.0,
            "iterations": iters,
            "iter_ms_p50": _median(iter_all) / 1000.0 if iter_all else 0.0,
            "rows": len(dev_rows),
            "rows_match": bool(rows_match),
            "pagerank_max_abs_diff": max_diff
            if func == "pagerank" else None,
        }
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=120_000)
    ap.add_argument("--degree", type=int, default=12)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    res = run_suite(persons=args.persons, degree=args.degree,
                    parts=args.parts, seed=args.seed,
                    repeats=args.repeats)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
