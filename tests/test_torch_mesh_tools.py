"""The port's two mesh tools on the CPU: `nebula_tpu_torch.tools.
probe_device` (the bounded-timeout CUDA probe) and `nebula_tpu_torch.
tools.multichip_bench` (the one-slot against N-slot A/B).

No unit test of the JAX package names either tool, so these tests twin
nothing.  The probe's verdict is held against children that time out,
fail, print no verdict, report a card, and against the real child here,
which finds no card; the bench's virtual arm runs at a small size
(parity with the one-slot runtime and the numpy walk, the shard ledger
summing to the pinned total, the per-device budget proof holding), and
its budget proof is reported as not applicable where every slot shares
one device, as on one card.
"""
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import torch

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.gpu import GpuRuntime
from nebula_tpu_torch.gpu.device import make_mesh
from nebula_tpu_torch.gpu.hop import a2a_payload_bytes
from nebula_tpu_torch.tools import multichip_bench as MB
from nebula_tpu_torch.tools import probe_device as P

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _child(tmp_path, body: str) -> str:
    """A stand-in for the probe's interpreter: a shell script that
    ignores its arguments and runs `body`."""
    path = tmp_path / "child.sh"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_probe_verdict_of_a_child_that_times_out(tmp_path):
    res = P.probe(timeout_s=0.5, python=_child(tmp_path, "sleep 30\n"))
    assert res["probe_status"] == "timeout" and res["rc"] == -1
    assert P._EXIT[res["probe_status"]] == 3


def test_probe_verdict_of_a_child_that_fails(tmp_path):
    res = P.probe(timeout_s=30, python=_child(
        tmp_path, "echo 'cuda init failed' >&2\nexit 7\n"))
    assert res["probe_status"] == "error" and res["rc"] == 7
    assert "cuda init failed" in res["detail"]
    res = P.probe(timeout_s=30, python=_child(tmp_path, "echo noise\n"))
    assert res["probe_status"] == "error" and res["rc"] == 0
    assert "no probe sentinel" in res["detail"]


def test_probe_verdict_of_a_child_that_finds_a_card(tmp_path):
    line = P._SENTINEL + json.dumps({"platform": "gpu", "n": 1,
                                     "name": "NVIDIA H100 80GB HBM3"})
    res = P.probe(timeout_s=30, python=_child(
        tmp_path, f"echo 'warning'\necho '{line}'\n"))
    assert (res["probe_status"], res["platform"], res["n_devices"],
            res["device_name"]) == ("ok", "gpu", 1, "NVIDIA H100 80GB HBM3")


def test_probe_cli_here():
    """The real child through the CLI: no card in a CPU-only process
    (`no_devices`, exit 2), the card's name where there is one (`ok`,
    exit 0); one JSON line with the reference's keys."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "nebula_tpu_torch.tools.probe_device",
         "--timeout", "120"], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=180)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"probe_status", "platform", "n_devices", "rc", "detail",
            "timeout_s"} <= set(res)
    if torch.cuda.is_available():
        assert (out.returncode, res["probe_status"], res["platform"]) == \
            (0, "ok", "gpu")
        assert res["device_name"] == torch.cuda.get_device_name(0)
    else:
        assert (out.returncode, res["probe_status"], res["platform"],
                res["n_devices"]) == (2, "no_devices", "cpu", 0)


def test_multichip_bench_virtual_arm():
    """The virtual arm at 2,000 persons: eight slots on eight CPU
    devices give the one-slot runtime's rows and the numpy walk's, the
    shard ledger sums to the pinned total, and with a per-device budget
    of a quarter of the graph the one-slot pin refuses while the
    eight-slot pin fits."""
    res = MB._run_child(True, persons=2000, degree=6, steps=3, repeats=1,
                        timeout_s=300)
    assert res["status"] == "ok", res
    assert res["platform"] == "cpu" and res["shards"] == 8
    assert res["rows_identical_1_vs_N"] and res["rows_identical_vs_numpy"]
    proof = res["hbm_scaleout"]
    assert proof["shard_sum_matches_total"]
    assert sum(proof["shard_hbm_bytes"].values()) == res["snapshot_bytes"]
    assert proof["applicable"] and proof["single_chip_refused"]
    assert proof["sharded_pin_ok"]
    assert res["single_chip"]["edges_traversed"] == \
        res["sharded"]["edges_traversed"] == res["numpy_edges_traversed"]
    vmax = D.snapshot_from_arrays(D.make_social_arrays(2000, 6, seed=7),
                                  parts=8).vmax
    assert res["sharded"]["exchange_bytes_per_hop"] == \
        a2a_payload_bytes(8, vmax)


def test_budget_proof_is_not_applicable_with_every_slot_on_one_device():
    """On one card every slot shares its device, so a budget of a
    quarter of the graph cannot hold the slots' sum: the proof says so,
    with the reason, and pins nothing under the budget."""
    snap = D.snapshot_from_arrays(D.make_social_arrays(400, 5), parts=8)
    rt = GpuRuntime(mesh=make_mesh(8, devices=[CPU]))
    dev = rt.pin_prebuilt(snap)
    pinned = []

    def one(**kw):
        pinned.append(kw)
        return GpuRuntime(device="cpu", **kw)

    proof = MB.budget_proof(snap, lambda: make_mesh(8, devices=[CPU]), one,
                            dev.hbm_bytes(), dev.shard_hbm_bytes())
    assert proof["applicable"] is False and not pinned
    assert "8 slots lie on 1 device(s)" in proof["reason"]
    assert proof["shard_sum_matches_total"]
    assert "single_chip_refused" not in proof
