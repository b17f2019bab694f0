"""Mesh A/B bench: one slot against N shard slots, the port's copy of
`nebula_tpu/tools/multichip_bench.py`.

What it measures, on one arm:

  * **HBM scale-out**: with a per-device budget of a quarter of the
    snapshot (`GpuRuntime(hbm_limit_bytes=)`), the one-slot pin refuses
    while the N-slot pin fits, each device holding its slots' share;
    the per-slot ledger (`shard_hbm_bytes`) must sum to the pinned
    total.  The proof needs the N slots spread over four devices or
    more: where the layout puts more than the budget on one device (on
    one card every slot shares it) it is reported as not applicable,
    with the reason, and nothing is pinned under the budget.
  * **Parity**: GO 3 STEPS rows from the N-slot runtime equal the
    one-slot runtime's and the numpy CSR walk's (`host_csr_traverse`).
  * **Goodput and exchange**: edges/s of each, the per-slot bytes, and
    the bit-packed frontier exchange a hop (`TraverseStats.
    exchange_bytes`).

Each arm runs in a throwaway subprocess with a hard deadline (the
probe's containment, `probe_device`).  The virtual arm always runs: N
slots on N CPU "devices" (`make_mesh(N, devices=[cpu] * N)`, the
reference's virtual CPU mesh), where each slot is its own device to the
budget.  The device arm runs when the probe finds a CUDA card: N slots
laid over the cards (`make_mesh(N)`; on one H100 every slot on
cuda:0).  Its times are the card's, printed beside the card's name and
power limit; the virtual arm's are the CPU's, and name no device
metric.

CLI:
  python -m nebula_tpu_torch.tools.multichip_bench            # both arms
  python -m nebula_tpu_torch.tools.multichip_bench --child [--virtual]
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

_SENTINEL = "NEBULA_MULTICHIP:"
SLOTS = 8                         # the N of the A/B
BUDGET_SHARE = 4                  # the per-device budget: snapshot / 4
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _card_line():
    """nvidia-smi's `name, power.limit`, or None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


# -- child: one bounded in-process measurement ------------------------------

def budget_proof(snap, mesh, one, snap_bytes: int, shard_bytes) -> dict:
    """The HBM scale-out proof at a per-device budget of a quarter of the
    snapshot: the one-slot runtime (`one(hbm_limit_bytes=)`) refuses the
    pin, an N-slot runtime on `mesh()` takes it within the budget on
    every device.  Not applicable, with the reason, where the layout puts
    more than the budget on one device (every slot on one card): then
    nothing is pinned under the budget.  `shard_bytes` is the unlimited
    N-slot pin's ledger, `snap_bytes` its total."""
    from ..gpu import GpuRuntime, GpuUnavailable
    from ..gpu.device import pin_home_bytes

    limit = max(snap_bytes // BUDGET_SHARE, 1)
    N = mesh().size
    homes = pin_home_bytes(snap, mesh())
    proof: dict = {"per_device_limit_bytes": limit,
                   "graph_over_budget_x": round(snap_bytes / limit, 2),
                   "devices_under_slots": len(homes),
                   "shard_hbm_bytes": {str(k): int(v)
                                       for k, v in shard_bytes.items()},
                   "shard_sum_matches_total":
                       sum(shard_bytes.values()) == snap_bytes}
    if max(homes.values()) > limit:
        proof["applicable"] = False
        proof["reason"] = (
            f"the {N} slots lie on {len(homes)} device(s), so one device "
            f"holds {max(homes.values()):,} bytes, past the per-device "
            f"budget of {limit:,} (a 1/{BUDGET_SHARE} of the graph): the "
            f"proof needs the slots spread over {BUDGET_SHARE} devices or "
            f"more")
        return proof
    proof["applicable"] = True
    try:
        one(hbm_limit_bytes=limit).pin_prebuilt(snap)
        proof["single_chip_refused"] = False    # should NOT happen
    except GpuUnavailable as ex:
        proof["single_chip_refused"] = True
        proof["refusal"] = str(ex)[:200]
    fitted = GpuRuntime(mesh=mesh(), hbm_limit_bytes=limit)
    per = fitted.pin_prebuilt(snap).home_bytes()
    proof["sharded_pin_ok"] = max(per.values()) <= limit
    return proof


def _run_measurement(persons: int, degree: int, steps: int, repeats: int,
                     virtual: bool) -> dict:
    import numpy as np
    import torch

    from ..bench.datagen import (SnapshotStore, host_csr_traverse,
                                 make_social_arrays, snapshot_from_arrays)
    from ..gpu import GpuRuntime
    from ..gpu.device import make_mesh
    from ..utils.stats import stats

    N = SLOTS
    if virtual:
        cpu = torch.device("cpu")
        out: dict = {"platform": "cpu", "device_name": None,
                     "n_devices": N}

        def one(**kw):
            return GpuRuntime(device="cpu", **kw)

        def mesh():
            return make_mesh(N, devices=[cpu] * N)
    else:
        if not torch.cuda.is_available():
            return {"error": "no CUDA device for the device arm"}
        out = {"platform": "gpu",
               "device_name": torch.cuda.get_device_name(0),
               "n_devices": torch.cuda.device_count(),
               "card": _card_line()}

        def one(**kw):
            return GpuRuntime(**kw)

        def mesh():
            return make_mesh(N)
    out.update({"shards": N, "persons": persons, "degree": degree,
                "steps": steps})

    arrs = make_social_arrays(persons, degree, seed=7)
    snap = snapshot_from_arrays(arrs, parts=N, space="mc")
    sstore = SnapshotStore(snap)
    rt1 = one()
    rtN = GpuRuntime(mesh=mesh())
    dev = rtN.pin_prebuilt(snap)
    snap_bytes = dev.hbm_bytes()
    shard_bytes = dev.shard_hbm_bytes()
    out["snapshot_bytes"] = snap_bytes

    out["hbm_scaleout"] = budget_proof(snap, mesh, one, snap_bytes,
                                       shard_bytes)

    # ---- parity + goodput A/B ----------------------------------------
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    rt1.pin_prebuilt(snap)

    def one_arm(rt):
        rows, st = rt.traverse(sstore, "mc", seeds, ["KNOWS"], "out",
                               steps)                  # warm-up
        lat = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            rows, st = rt.traverse(sstore, "mc", seeds, ["KNOWS"],
                                   "out", steps)
            lat.append(time.perf_counter() - t0)
        edges = st.edges_traversed()
        xhops = max(steps - 1, 0)
        med = statistics.median(lat)
        arm = {"shards": st.shards,
               "edges_traversed": edges,
               "median_s": med,
               "edges_per_s": int(edges / med),
               "exchange_bytes": st.exchange_bytes,
               "exchange_bytes_per_hop":
                   st.exchange_bytes // xhops if xhops else 0,
               "device_s": st.device_s}
        key = sorted((int(e.src), e.name, int(e.ranking), int(e.dst))
                     for _, e, _ in rows)
        return arm, key

    armN, keyN = one_arm(rtN)
    arm1, key1 = one_arm(rt1)
    out["single_chip"] = arm1
    out["sharded"] = armN
    out["speedup_Nshard_vs_1"] = armN["edges_per_s"] / max(
        arm1["edges_per_s"], 1)
    out["rows_identical_1_vs_N"] = key1 == keyN

    # numpy oracle: same CSR arrays, vectorized host expansion
    total, kept, dst, w = host_csr_traverse(snap, seeds, steps,
                                            materialize=True)
    devd = np.asarray(sorted(k[3] for k in keyN), np.int64)
    out["rows_identical_vs_numpy"] = (
        kept == len(keyN) and
        bool((np.sort(dst.astype(np.int64)) == devd).all()))
    out["numpy_edges_traversed"] = int(total)

    # the mesh gauges the run left behind
    snapm = stats().snapshot()
    out["tpu_shards_gauge"] = snapm.get("tpu_shards")
    out["tpu_all_to_all_bytes"] = snapm.get("tpu_all_to_all_bytes", 0)
    return out


def _child_main(args) -> int:
    try:
        res = _run_measurement(args.persons, args.degree, args.steps,
                               args.repeats, args.virtual)
    except Exception as ex:  # noqa: BLE001 — verdict, not traceback
        res = {"error": repr(ex)[:400]}
    print(_SENTINEL + json.dumps(res))
    return 0 if "error" not in res else 1


# -- parent: bounded subprocess arms + probe verdict ------------------------

def _run_child(virtual: bool, persons: int, degree: int, steps: int,
               repeats: int, timeout_s: float) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "nebula_tpu_torch.tools.multichip_bench",
           "--child", "--persons", str(persons), "--degree", str(degree),
           "--steps", str(steps), "--repeats", str(repeats)]
    if virtual:
        cmd.append("--virtual")
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "timeout_s": timeout_s}
    for line in out.stdout.splitlines():
        if line.startswith(_SENTINEL):
            try:
                res = json.loads(line[len(_SENTINEL):])
                res["status"] = "ok" if "error" not in res else "error"
                return res
            except ValueError:
                pass
    return {"status": "error", "rc": out.returncode,
            "stderr": (out.stderr or "").strip()[-400:]}


def multichip_sweep(persons: int = 120_000, degree: int = 6,
                    steps: int = 3, repeats: int = 5,
                    timeout_s: float = 600.0) -> dict:
    """The probe's verdict, the virtual arm (always) and the device arm
    (when the probe finds a card).  Never raises, never hangs past its
    deadlines."""
    from .probe_device import probe
    verdict = probe()
    result = {"probe_status": verdict["probe_status"],
              "probe": verdict,
              "virtual": _run_child(True, persons, degree, steps,
                                    repeats, timeout_s)}
    if verdict["probe_status"] == "ok":
        result["device"] = _run_child(False, persons, degree, steps,
                                      repeats, timeout_s)
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="1-vs-N-slot mesh execution A/B")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--virtual", action="store_true",
                    help="(with --child) the N slots on N CPU devices")
    ap.add_argument("--persons", type=int,
                    default=int(os.environ.get(
                        "NEBULA_BENCH_MULTICHIP_PERSONS", 120_000)))
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--timeout", type=float,
                    default=float(os.environ.get(
                        "NEBULA_BENCH_MULTICHIP_TIMEOUT", 600)))
    args = ap.parse_args(argv)
    if args.child:
        return _child_main(args)
    res = multichip_sweep(args.persons, args.degree, args.steps,
                          args.repeats, args.timeout)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
