"""Bounded-timeout device probe with a structured verdict, the port's copy
of `nebula_tpu/tools/probe_device.py`.

A CUDA runtime or a card can wedge: a hung context makes the next
`torch.cuda` call block.  The probe asks `torch.cuda` for the card in a
throwaway subprocess (the parent never touches CUDA, so only the child
can hang) under a hard deadline, and returns a machine-readable verdict:

    {"probe_status": "ok" | "timeout" | "no_devices" | "error",
     "platform":  "gpu" | "cpu" | None,
     "n_devices": int,
     "device_name": the first card's name, or None,
     "rc":        child exit code (-1 on timeout),
     "detail":    last stderr/stdout fragment for the log line}

`probe_status`:

  ok          a CUDA card answered within the deadline
  no_devices  the child ran fine but found no CUDA card
  timeout     the child exceeded the deadline (a wedged CUDA runtime or card)
  error       the child exited non-zero (import error, a failed CUDA init)

CLI: ``python -m nebula_tpu_torch.tools.probe_device [--timeout S]``
prints the verdict as one JSON line and exits 0 on "ok", 2 on
"no_devices", 3 on "timeout", 4 on "error".
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

# one parsable line, whatever else the child prints
_SENTINEL = "NEBULA_PROBE:"
_CHILD = ("import json, torch; n = torch.cuda.device_count() "
          "if torch.cuda.is_available() else 0; "
          "print('" + _SENTINEL + "' + json.dumps("
          "{'platform': 'gpu' if n else 'cpu', 'n': n, "
          "'name': torch.cuda.get_device_name(0) if n else None}))")

DEFAULT_TIMEOUT_S = 150


def probe(timeout_s: Optional[float] = None,
          python: Optional[str] = None) -> dict:
    """Run the subprocess probe; never raises, never hangs past the
    deadline.  `timeout_s` defaults to $NEBULA_BENCH_PROBE_TIMEOUT or
    150 s; `python` is the interpreter the child runs under."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("NEBULA_BENCH_PROBE_TIMEOUT",
                                         DEFAULT_TIMEOUT_S))
    res = {"probe_status": "error", "platform": None, "n_devices": 0,
           "device_name": None, "rc": -1, "detail": "",
           "timeout_s": timeout_s}

    def _txt(v) -> str:
        if isinstance(v, bytes):
            v = v.decode(errors="replace")
        return (v or "").strip()[-400:]

    try:
        out = subprocess.run(
            [python or sys.executable, "-c", _CHILD],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as ex:
        res.update(probe_status="timeout",
                   detail=_txt(ex.stderr)
                   or "probe exceeded deadline (wedged CUDA runtime or card)")
        return res
    except OSError as ex:  # interpreter itself unrunnable
        res.update(probe_status="error", detail=repr(ex)[-400:])
        return res

    res["rc"] = out.returncode
    if out.returncode != 0:
        res.update(probe_status="error", detail=_txt(out.stderr))
        return res
    payload = None
    for line in out.stdout.splitlines():
        if line.startswith(_SENTINEL):
            try:
                payload = json.loads(line[len(_SENTINEL):])
            except ValueError:
                pass
    if payload is None:
        res.update(probe_status="error",
                   detail="no probe sentinel in child stdout: "
                          + _txt(out.stdout))
        return res
    res["platform"] = str(payload.get("platform"))
    res["n_devices"] = int(payload.get("n", 0))
    res["device_name"] = payload.get("name")
    res["probe_status"] = "ok" if res["platform"] == "gpu" \
        and res["n_devices"] > 0 else "no_devices"
    res["detail"] = _txt(out.stdout)
    return res


_EXIT = {"ok": 0, "no_devices": 2, "timeout": 3, "error": 4}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="bounded-timeout CUDA probe (JSON verdict)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="probe deadline in seconds (default: "
                         "$NEBULA_BENCH_PROBE_TIMEOUT or 150)")
    args = ap.parse_args(argv)
    res = probe(timeout_s=args.timeout)
    print(json.dumps(res))
    return _EXIT.get(res["probe_status"], 4)


if __name__ == "__main__":
    sys.exit(main())
