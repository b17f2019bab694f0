"""Wire (de)serialization of the Value model — the thrift-struct analog.

Every nGQL value maps to a JSON-safe form and back, losslessly (null
kinds, temporal types, vertex/edge/path, sets, DataSet).  This is the
process-boundary encoding used by cluster RPC (NebulaGraph: the thrift
serialization of src/common/datatypes).  A copy of
`nebula_tpu/core/wire.py`.

Plain JSON scalars pass through untouched; composite/typed values become
{"@t": tag, ...} dicts (plain maps are tagged too, so user maps whose
keys include "@t" round-trip safely).
"""
from __future__ import annotations

import json
from typing import Any, Dict

from .value import (ColumnarDataSet, DataSet, Date, DateTime, Duration,
                    Edge, EmptyValue, NullKind, NullValue, Path, Step, Tag,
                    Time, Vertex)


# row-form DataSets at/above this size probe for columnar encoding;
# below it the type scan costs more than per-cell JSON saves
COLUMNAR_MIN_ROWS = 64

_SCALAR_DTYPES = {int: "<i8", float: "<f8", bool: "|b1"}

# transport narrowing probes columns at/above this size; below it the
# min/max scan costs more than the saved bytes
_NARROW_MIN = 4096


def _narrow_dtype(arr):
    """Smallest signed int dtype that holds arr losslessly, when it is
    strictly narrower than arr's own — else None.  Transport-only: the
    declared dtype (`dt`) is restored on decode, so int64 semantics
    survive; at loopback/NIC throughputs the width scan + astype copy
    is far cheaper than shipping the spare bytes."""
    import numpy as np
    if arr.size < _NARROW_MIN or arr.dtype.kind not in "iu":
        return None
    lo, hi = int(arr.min()), int(arr.max())
    for dt in (np.int8, np.int16, np.int32):
        if np.dtype(dt).itemsize >= arr.dtype.itemsize:
            return None
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return np.dtype(dt)
    return None


def encode_array(arr) -> Any:
    """Typed-blob wire entry for a 1-D numeric numpy array: the numpy
    buffer itself as a memoryview (zero copy), narrowed for transport
    when the value range allows."""
    import numpy as np
    arr = np.ascontiguousarray(arr)
    entry: Dict[str, Any] = {"dt": arr.dtype.str}
    nd = _narrow_dtype(arr)
    if nd is not None:
        entry["wdt"] = nd.str
        entry["b"] = memoryview(arr.astype(nd))
    else:
        entry["b"] = memoryview(arr)
    return entry


def encode_column(col) -> Any:
    """Typed-blob encoding of one column of plain scalars, or None.

    Exact by construction: the column is accepted only when EVERY cell
    is the same plain scalar type (set(map(type, ...)) — C-level scan),
    so int/float/bool identity survives the round trip (a numpy
    dtype-inference coercion like [1, 2.5] → float64 can never happen).
    """
    ts = set(map(type, col))
    if len(ts) != 1:
        return None
    dt = _SCALAR_DTYPES.get(next(iter(ts)))
    if dt is None:
        return None
    import numpy as np
    try:
        arr = np.array(col, dtype=np.dtype(dt))
    except (OverflowError, ValueError):   # >int64 Python ints
        return None
    return encode_array(arr)


def decode_column(cj: Any):
    """Inverse of encode_column/encode_array → 1-D numpy array
    (zero-copy over RPC blob views; base64 fallback for file/raft
    serialization).  Transport-narrowed int columns STAY narrow —
    value-exact (int8/32 cells materialize to identical Python ints),
    and widening 100MB eagerly was measured to cost more than the
    narrowing saved; only ints are ever narrowed (_narrow_dtype), so
    no lossy float path exists."""
    import numpy as np
    b = cj["b"]
    if isinstance(b, dict):               # {"@t":"b64",...} fallback
        b = from_wire(b)
    return np.frombuffer(b, dtype=np.dtype(cj.get("wdt") or cj["dt"]))


def _dataset_columnar(v: "DataSet") -> Any:
    """Columnar wire form of a row DataSet when at least one column is
    a homogeneous plain-scalar column; None → keep the row encoding."""
    cols = list(zip(*v.rows))
    if len(cols) != len(v.column_names):
        return None                        # ragged rows: stay row-form
    data = []
    hit = False
    for col in cols:
        enc = encode_column(col)
        if enc is not None:
            hit = True
            data.append(enc)
        else:
            data.append({"v": [to_wire(x) for x in col]})
    if not hit:
        return None
    return {"@t": "coldataset", "cols": list(v.column_names),
            "data": data}


def to_wire(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, NullValue):
        return {"@t": "null", "k": v.kind.name}
    if isinstance(v, EmptyValue):
        return {"@t": "empty"}
    if isinstance(v, Geography):
        return {"@t": "geo", "v": v.wkt()}
    if isinstance(v, Date):
        return {"@t": "date", "v": [v.year, v.month, v.day]}
    if isinstance(v, Time):
        return {"@t": "time", "v": [v.hour, v.minute, v.sec, v.microsec]}
    if isinstance(v, DateTime):
        return {"@t": "datetime", "v": [v.year, v.month, v.day, v.hour,
                                        v.minute, v.sec, v.microsec]}
    if isinstance(v, Duration):
        return {"@t": "duration", "v": [v.seconds, v.microseconds, v.months]}
    if isinstance(v, Tag):
        return {"@t": "tag", "n": v.name,
                "p": {k: to_wire(x) for k, x in v.props.items()}}
    if isinstance(v, Vertex):
        return {"@t": "vertex", "vid": to_wire(v.vid),
                "tags": [to_wire(t) for t in v.tags]}
    if isinstance(v, Edge):
        return {"@t": "edge", "src": to_wire(v.src), "dst": to_wire(v.dst),
                "n": v.name, "r": v.ranking, "et": v.etype,
                "p": {k: to_wire(x) for k, x in v.props.items()}}
    if isinstance(v, Step):
        return {"@t": "step", "dst": to_wire(v.dst), "n": v.name,
                "r": v.ranking, "et": v.etype,
                "p": {k: to_wire(x) for k, x in v.props.items()}}
    if isinstance(v, Path):
        return {"@t": "path", "src": to_wire(v.src),
                "steps": [to_wire(s) for s in v.steps]}
    if isinstance(v, ColumnarDataSet) and v._cols is not None:
        # device-plane results stay columnar THROUGH the wire: numeric
        # columns ship as RAW
        # buffers — the RPC layer hoists the bytes into out-of-band
        # binary frames (ZERO copy: the numpy column's own buffer rides
        # to sendall as a memoryview), file/raft serialization falls
        # back to base64 — and the client decodes straight back into
        # numpy with no per-row object cost; object columns (strings,
        # vertices) use per-value encoding.  Materialized ones
        # (something already touched .rows) ship as a plain dataset.
        import numpy as np
        data = []
        for c in v._cols:
            c = np.asarray(c)
            if c.dtype.kind in "biuf":
                data.append(encode_array(c))
            else:
                data.append({"v": [to_wire(x) for x in c.tolist()]})
        return {"@t": "coldataset", "cols": list(v.column_names),
                "data": data}
    if isinstance(v, DataSet):
        # the GO/MATCH bulk result path: a row-form result
        # whose columns are homogeneous plain scalars ships columnar
        # too — typed blobs instead of one JSON token per cell — and
        # decodes into a lazy ColumnarDataSet (no per-row boxing until
        # a consumer actually crosses the row boundary)
        if len(v.rows) >= COLUMNAR_MIN_ROWS and v.column_names:
            enc = _dataset_columnar(v)
            if enc is not None:
                return enc
        return {"@t": "dataset", "cols": list(v.column_names),
                "rows": [[to_wire(c) for c in r] for r in v.rows]}
    if isinstance(v, list):
        return {"@t": "list", "v": [to_wire(x) for x in v]}
    if isinstance(v, tuple):
        return {"@t": "list", "v": [to_wire(x) for x in v]}
    if isinstance(v, set):
        return {"@t": "set", "v": [to_wire(x) for x in sorted(v, key=repr)]}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v):
            return {"@t": "map", "v": {k: to_wire(x) for k, x in v.items()}}
        # non-string keys (int vids, (rank,dst) tuples): JSON objects
        # would silently coerce them to strings, so ship pairs instead
        return {"@t": "kvmap",
                "v": [[to_wire(k), to_wire(x)] for k, x in v.items()]}
    raise TypeError(f"not wire-serializable: {type(v).__name__}")


def from_wire(j: Any) -> Any:
    if j is None or isinstance(j, (bool, int, float, str)):
        return j
    if isinstance(j, list):            # bare JSON list (rpc params etc.)
        return [from_wire(x) for x in j]
    if not isinstance(j, dict):
        raise TypeError(f"bad wire value: {type(j).__name__}")
    t = j.get("@t")
    if t is None:                      # bare JSON object
        return {k: from_wire(x) for k, x in j.items()}
    if t == "geo":
        return from_wkt(j["v"])
    if t == "null":
        return NullValue(NullKind[j["k"]])
    if t == "empty":
        return EmptyValue()
    if t == "date":
        return Date(*j["v"])
    if t == "time":
        return Time(*j["v"])
    if t == "datetime":
        return DateTime(*j["v"])
    if t == "duration":
        return Duration(*j["v"])
    if t == "tag":
        return Tag(j["n"], {k: from_wire(x) for k, x in j["p"].items()})
    if t == "vertex":
        return Vertex(from_wire(j["vid"]), [from_wire(x) for x in j["tags"]])
    if t == "edge":
        return Edge(from_wire(j["src"]), from_wire(j["dst"]), j["n"],
                    j["r"], {k: from_wire(x) for k, x in j["p"].items()},
                    etype=j["et"])
    if t == "step":
        return Step(from_wire(j["dst"]), j["n"], j["r"],
                    {k: from_wire(x) for k, x in j["p"].items()},
                    etype=j["et"])
    if t == "path":
        return Path(from_wire(j["src"]), [from_wire(s) for s in j["steps"]])
    if t == "dataset":
        return DataSet(list(j["cols"]),
                       [[from_wire(c) for c in r] for r in j["rows"]])
    if t == "coldataset":
        import numpy as np
        arrs = []
        for cj in j["data"]:
            if cj.get("b") is not None:
                arrs.append(decode_column(cj))
            else:
                vals = [from_wire(x) for x in cj["v"]]
                # element-wise fill: np.array() would collapse a column
                # of equal-length lists into a 2-D array
                a = np.empty(len(vals), dtype=object)
                for i, x in enumerate(vals):
                    a[i] = x
                arrs.append(a)
        return ColumnarDataSet(list(j["cols"]), arrs)
    if t == "b64":
        import base64
        return base64.b64decode(j["v"])
    if t == "list":
        return [from_wire(x) for x in j["v"]]
    if t == "set":
        return {from_wire(x) for x in j["v"]}
    if t == "map":
        return {k: from_wire(x) for k, x in j["v"].items()}
    if t == "kvmap":
        out = {}
        for kj, xj in j["v"]:
            k = from_wire(kj)
            if isinstance(k, list):      # tuple keys decode as lists
                k = tuple(k)
            out[k] = from_wire(xj)
        return out
    raise TypeError(f"unknown wire tag {t!r}")


def b64_default(o):
    """json.dumps default for wire objects: raw bytes (columnar buffers)
    degrade to tagged base64 when no binary framing is available."""
    if isinstance(o, (bytes, bytearray, memoryview)):
        import base64
        return {"@t": "b64", "v": base64.b64encode(bytes(o)).decode()}
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def dumps(v: Any) -> bytes:
    """Wire-encode + JSON-serialize (raft entries, snapshots, files)."""
    return json.dumps(to_wire(v), separators=(",", ":"),
                      default=b64_default).encode()


def loads(data: bytes) -> Any:
    return from_wire(json.loads(data.decode()))
from .geo import Geography, from_wkt
