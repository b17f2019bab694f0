"""Builtin scalar function registry — analog of NebulaGraph's
FunctionManager (src/common/function/FunctionManager.cpp); a copy of
`nebula_tpu/core/functions.py`.

Functions take ``(ctx, args: list)`` and return a Value.  Null handling:
most functions propagate null inputs; type mismatches yield BAD_TYPE.
"""
from __future__ import annotations

import datetime as _dt
import hashlib
import math
import random
import time as _time
from typing import Any, Callable, Dict, List

from .value import (NULL, NULL_BAD_DATA, NULL_BAD_TYPE, DataSet, Date,
                    DateTime, Duration, Edge, NullValue, Path, Time, Vertex,
                    is_empty, is_null, total_order_key, type_name, v_lt,
                    value_to_string)

FUNCTIONS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FUNCTIONS[name.lower()] = fn
        return fn
    return deco


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _nullprop(args) -> Any:
    for a in args:
        if is_null(a):
            return a
    return None


def _math1(name: str, f: Callable[[float], float], integer_passthrough=False):
    @register(name)
    def _fn(ctx, args, _f=f, _ip=integer_passthrough):
        n = _nullprop(args)
        if n is not None:
            return n
        v = args[0]
        if not _num(v):
            return NULL_BAD_TYPE
        try:
            r = _f(v)
        except (ValueError, OverflowError):
            return NULL_BAD_DATA
        if _ip and isinstance(v, int) and float(r).is_integer():
            return int(r)
        return r
    return _fn


_math1("abs", abs, integer_passthrough=True)
_math1("floor", lambda v: float(math.floor(v)))
_math1("ceil", lambda v: float(math.ceil(v)))
_math1("ceiling", lambda v: float(math.ceil(v)))
_math1("sqrt", math.sqrt)
_math1("cbrt", lambda v: math.copysign(abs(v) ** (1 / 3), v))
_math1("exp", math.exp)
_math1("exp2", lambda v: 2.0 ** v)
_math1("log", math.log)
_math1("log2", math.log2)
_math1("log10", math.log10)
_math1("sin", math.sin)
_math1("cos", math.cos)
_math1("tan", math.tan)
_math1("asin", math.asin)
_math1("acos", math.acos)
_math1("atan", math.atan)
_math1("sign", lambda v: (v > 0) - (v < 0))


@register("round")
def _round(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if not _num(v):
        return NULL_BAD_TYPE
    places = args[1] if len(args) > 1 else 0
    if not isinstance(places, int):
        return NULL_BAD_TYPE
    # round-half-away-from-zero, like the reference (not banker's rounding)
    scale = 10 ** places
    return math.floor(abs(v) * scale + 0.5) / scale * (1 if v >= 0 else -1)


@register("pow")
def _pow(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    a, b = args[0], args[1]
    if not _num(a) or not _num(b):
        return NULL_BAD_TYPE
    try:
        r = a ** b
    except (OverflowError, ZeroDivisionError):
        return NULL_BAD_DATA
    if isinstance(a, int) and isinstance(b, int) and b >= 0:
        return int(r)
    return float(r)


@register("hypot")
def _hypot(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not _num(args[0]) or not _num(args[1]):
        return NULL_BAD_TYPE
    return math.hypot(args[0], args[1])


@register("rand")
def _rand(ctx, args):
    return random.random()


@register("rand32")
def _rand32(ctx, args):
    if len(args) == 2:
        return random.randrange(args[0], args[1])
    if len(args) == 1:
        return random.randrange(args[0])
    return random.randrange(2**31)


@register("rand64")
def _rand64(ctx, args):
    if len(args) == 2:
        return random.randrange(args[0], args[1])
    return random.randrange(2**63)


@register("pi")
def _pi(ctx, args):
    return math.pi


@register("e")
def _e(ctx, args):
    return math.e


@register("range")
def _range(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not all(isinstance(a, int) for a in args):
        return NULL_BAD_TYPE
    start, end = args[0], args[1]
    step = args[2] if len(args) > 2 else 1
    if step == 0:
        return NULL_BAD_DATA
    return list(range(start, end + (1 if step > 0 else -1), step))


# ---- string ----------------------------------------------------------------


def _str1(name, f):
    @register(name)
    def _fn(ctx, args, _f=f):
        n = _nullprop(args)
        if n is not None:
            return n
        if not isinstance(args[0], str):
            return NULL_BAD_TYPE
        return _f(args[0])
    return _fn


_str1("lower", str.lower)
_str1("tolower", str.lower)
_str1("upper", str.upper)
_str1("toupper", str.upper)
_str1("trim", str.strip)
_str1("ltrim", str.lstrip)
_str1("rtrim", str.rstrip)


@register("reverse")
def _reverse(ctx, args):
    """String or list reversal — the reference overloads one name."""
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if isinstance(v, (str, list)):
        return v[::-1]
    return NULL_BAD_TYPE


@register("length")
def _length(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if isinstance(v, str):
        return len(v)
    if isinstance(v, Path):
        return v.length()
    return NULL_BAD_TYPE


@register("size")
def _size(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if isinstance(v, (str, list, set, dict)):
        return len(v)
    if isinstance(v, DataSet):
        return len(v.rows)
    return NULL_BAD_TYPE


@register("substr")
@register("substring")
def _substr(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    s = args[0]
    if not isinstance(s, str) or not isinstance(args[1], int):
        return NULL_BAD_TYPE
    start = args[1]
    if start < 0:
        return NULL_BAD_DATA
    ln = args[2] if len(args) > 2 else len(s) - start
    if not isinstance(ln, int) or ln < 0:
        return NULL_BAD_DATA if isinstance(ln, int) else NULL_BAD_TYPE
    return s[start:start + ln]


@register("left")
def _left(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str) or not isinstance(args[1], int):
        return NULL_BAD_TYPE
    if args[1] < 0:
        return NULL_BAD_DATA
    return args[0][:args[1]]


@register("right")
def _right(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str) or not isinstance(args[1], int):
        return NULL_BAD_TYPE
    if args[1] < 0:
        return NULL_BAD_DATA
    return args[0][-args[1]:] if args[1] > 0 else ""


@register("replace")
def _replace(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not all(isinstance(a, str) for a in args[:3]):
        return NULL_BAD_TYPE
    return args[0].replace(args[1], args[2])


@register("atan2")
def _atan2(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    a, b = args[0], args[1]
    if not _num(a) or not _num(b):
        return NULL_BAD_TYPE
    return math.atan2(a, b)


@register("split")
def _split(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str) or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    return args[0].split(args[1])


@register("concat")
def _concat(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    out = []
    for a in args:
        if isinstance(a, str):
            out.append(a)
        elif isinstance(a, bool):
            out.append("true" if a else "false")
        elif _num(a):
            out.append(str(a))
        else:
            return NULL_BAD_TYPE
    return "".join(out)


@register("concat_ws")
def _concat_ws(ctx, args):
    if is_null(args[0]) or not isinstance(args[0], str):
        return NULL_BAD_TYPE if not is_null(args[0]) else NULL
    sep = args[0]
    parts = []
    for a in args[1:]:
        if is_null(a):
            continue
        if isinstance(a, str):
            parts.append(a)
        elif isinstance(a, bool):
            parts.append("true" if a else "false")
        elif _num(a):
            parts.append(str(a))
    return sep.join(parts)


@register("lpad")
def _lpad(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    s, size, pad = args
    if not isinstance(s, str) or not isinstance(size, int) or not isinstance(pad, str):
        return NULL_BAD_TYPE
    if size < len(s):
        return s[:size]
    if not pad:
        return s
    fill = (pad * size)[: size - len(s)]
    return fill + s


@register("rpad")
def _rpad(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    s, size, pad = args
    if not isinstance(s, str) or not isinstance(size, int) or not isinstance(pad, str):
        return NULL_BAD_TYPE
    if size < len(s):
        return s[:size]
    if not pad:
        return s
    fill = (pad * size)[: size - len(s)]
    return s + fill


@register("strcasecmp")
def _strcasecmp(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str) or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    a, b = args[0].lower(), args[1].lower()
    return 0 if a == b else (-1 if a < b else 1)


@register("hash")
def _hash(ctx, args):
    v = args[0]
    if isinstance(v, str):
        h = int.from_bytes(hashlib.md5(v.encode()).digest()[:8], "little", signed=True)
        return h
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if is_null(v):
        return 0
    return hash(value_to_string(v)) & 0x7FFFFFFFFFFFFFFF


@register("md5")
def _md5(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str):
        return NULL_BAD_TYPE
    return hashlib.md5(args[0].encode()).hexdigest()


@register("sha1")
def _sha1(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str):
        return NULL_BAD_TYPE
    return hashlib.sha1(args[0].encode()).hexdigest()


@register("sha256")
def _sha256(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str):
        return NULL_BAD_TYPE
    return hashlib.sha256(args[0].encode()).hexdigest()


# ---- casts -----------------------------------------------------------------


def cast_value(target: str, v: Any) -> Any:
    if target in ("int", "int64", "integer"):
        return FUNCTIONS["tointeger"](None, [v])
    if target in ("float", "double"):
        return FUNCTIONS["tofloat"](None, [v])
    if target == "bool":
        return FUNCTIONS["toboolean"](None, [v])
    if target == "string":
        return FUNCTIONS["tostring"](None, [v])
    if target == "set":
        return FUNCTIONS["toset"](None, [v])
    return NULL_BAD_TYPE


@register("tointeger")
@register("toint")
def _toint(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, bool):
        return NULL_BAD_TYPE
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v != v or v in (math.inf, -math.inf):
            return NULL_BAD_DATA
        return int(v)
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            try:
                return int(float(v.strip()))
            except ValueError:
                return NULL
    return NULL_BAD_TYPE


@register("tofloat")
def _tofloat(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, bool):
        return NULL_BAD_TYPE
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            return NULL
    return NULL_BAD_TYPE


@register("toboolean")
def _tobool(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        s = v.strip().lower()
        if s == "true":
            return True
        if s == "false":
            return False
        return NULL
    return NULL_BAD_TYPE


@register("tostring")
def _tostring(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        s = f"{v:.15g}"
        return s if ("." in s or "e" in s or "n" in s or "i" in s) else s + ".0"
    if isinstance(v, int):
        return str(v)
    return value_to_string(v).strip('"')


@register("toset")
def _toset(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, set):
        return v
    if isinstance(v, list):
        try:
            return set(v)
        except TypeError:
            return NULL_BAD_TYPE
    return NULL_BAD_TYPE


# ---- list ------------------------------------------------------------------


@register("head")
def _head(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if not isinstance(v, list):
        return NULL_BAD_TYPE
    return v[0] if v else NULL


@register("last")
def _last(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if not isinstance(v, list):
        return NULL_BAD_TYPE
    return v[-1] if v else NULL


@register("tail")
def _tail(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if not isinstance(v, list):
        return NULL_BAD_TYPE
    return v[1:]


@register("coalesce")
def _coalesce(ctx, args):
    for a in args:
        if not is_null(a) and not is_empty(a):
            return a
    return NULL


@register("keys")
def _keys(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, dict):
        return sorted(v.keys())
    if isinstance(v, (Vertex,)):
        return sorted(v.properties().keys())
    if isinstance(v, Edge):
        return sorted(v.props.keys())
    return NULL_BAD_TYPE


# ---- graph accessors -------------------------------------------------------


@register("id")
def _id(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Vertex):
        return v.vid
    return NULL_BAD_TYPE


@register("tags")
@register("labels")
def _tags(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Vertex):
        return v.tag_names()
    return NULL_BAD_TYPE


@register("properties")
def _properties(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Vertex):
        return v.properties()
    if isinstance(v, Edge):
        return dict(v.props)
    if isinstance(v, dict):
        return v
    return NULL_BAD_TYPE


@register("type")
def _type(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Edge):
        return v.name
    return NULL_BAD_TYPE


@register("typeid")
def _typeid(ctx, args):
    v = args[0]
    if isinstance(v, Edge):
        return v.etype
    return NULL_BAD_TYPE


@register("src")
def _src(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Edge):
        return v.src if v.etype >= 0 else v.dst
    return NULL_BAD_TYPE


@register("dst")
def _dst(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Edge):
        return v.dst if v.etype >= 0 else v.src
    return NULL_BAD_TYPE


@register("rank")
def _rank(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Edge):
        return v.ranking
    return NULL_BAD_TYPE


@register("startnode")
def _startnode(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Path):
        return v.src
    return NULL_BAD_TYPE


@register("endnode")
def _endnode(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Path):
        return v.nodes()[-1]
    return NULL_BAD_TYPE


@register("nodes")
def _nodes(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Path):
        return v.nodes()
    return NULL_BAD_TYPE


@register("relationships")
def _relationships(ctx, args):
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, Path):
        return v.relationships()
    return NULL_BAD_TYPE


@register("hassameedgeinpath")
def _has_same_edge(ctx, args):
    v = args[0]
    if isinstance(v, Path):
        return v.has_duplicate_edges()
    return NULL_BAD_TYPE


@register("hassamevertexinpath")
def _has_same_vertex(ctx, args):
    v = args[0]
    if isinstance(v, Path):
        return v.has_duplicate_vertices()
    return NULL_BAD_TYPE


@register("reversepath")
def _reverse_path(ctx, args):
    from .value import Step
    v = args[0]
    if not isinstance(v, Path):
        return NULL_BAD_TYPE
    nodes = v.nodes()
    p = Path(nodes[-1])
    prev = nodes[-1]
    for i in range(len(v.steps) - 1, -1, -1):
        s = v.steps[i]
        src_v = v.src if i == 0 else v.steps[i - 1].dst
        p.steps.append(Step(src_v, s.name, s.ranking, s.props, -s.etype))
        prev = src_v
    return p


# ---- temporal --------------------------------------------------------------


def _parse_date(s: str):
    try:
        d = _dt.date.fromisoformat(s)
        return Date(d.year, d.month, d.day)
    except ValueError:
        return NULL_BAD_DATA


@register("date")
def _date(ctx, args):
    if not args:
        t = _dt.date.today()
        return Date(t.year, t.month, t.day)
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, str):
        return _parse_date(v)
    if isinstance(v, dict):
        try:
            return Date(v.get("year", 1970), v.get("month", 1), v.get("day", 1))
        except Exception:
            return NULL_BAD_DATA
    if isinstance(v, Date):
        return v
    return NULL_BAD_TYPE


@register("time")
def _time_fn(ctx, args):
    if not args:
        t = _dt.datetime.utcnow()
        return Time(t.hour, t.minute, t.second, t.microsecond)
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, str):
        try:
            t = _dt.time.fromisoformat(v)
            return Time(t.hour, t.minute, t.second, t.microsecond)
        except ValueError:
            return NULL_BAD_DATA
    if isinstance(v, dict):
        return Time(v.get("hour", 0), v.get("minute", 0), v.get("second", 0),
                    v.get("microsecond", 0))
    if isinstance(v, Time):
        return v
    return NULL_BAD_TYPE


@register("datetime")
def _datetime_fn(ctx, args):
    if not args:
        t = _dt.datetime.utcnow()
        return DateTime(t.year, t.month, t.day, t.hour, t.minute, t.second, t.microsecond)
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, str):
        try:
            t = _dt.datetime.fromisoformat(v)
            return DateTime(t.year, t.month, t.day, t.hour, t.minute, t.second, t.microsecond)
        except ValueError:
            return NULL_BAD_DATA
    if isinstance(v, dict):
        return DateTime(v.get("year", 1970), v.get("month", 1), v.get("day", 1),
                        v.get("hour", 0), v.get("minute", 0), v.get("second", 0),
                        v.get("microsecond", 0))
    if isinstance(v, (int, float)):
        t = _dt.datetime.utcfromtimestamp(v)
        return DateTime(t.year, t.month, t.day, t.hour, t.minute, t.second, t.microsecond)
    if isinstance(v, DateTime):
        return v
    return NULL_BAD_TYPE


@register("timestamp")
def _timestamp(ctx, args):
    if not args:
        return int(_time.time())
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, DateTime):
        return v.to_timestamp()
    if isinstance(v, str):
        try:
            t = _dt.datetime.fromisoformat(v)
            return int(t.replace(tzinfo=_dt.timezone.utc).timestamp())
        except ValueError:
            return NULL_BAD_DATA
    return NULL_BAD_TYPE


@register("now")
def _now(ctx, args):
    return int(_time.time())


# NebulaGraph's format-string subset for date_format/time_format (the
# last FunctionManager entries): strftime-style
# two-char specifiers over the temporal's components.  Specifiers whose
# component the value doesn't carry (e.g. %H over a plain date) and
# unknown specifiers answer NULL_BAD_DATA — a tested refusal, not a
# silent passthrough.
_DATE_SPECS = frozenset("YmdeFjW")
_TIME_SPECS = frozenset("HMiSsfT")


def _format_components(fmt: str, comp: dict):
    out = []
    i, n = 0, len(fmt)
    while i < n:
        ch = fmt[i]
        if ch != "%":
            out.append(ch)
            i += 1
            continue
        if i + 1 >= n:
            return None
        sp = fmt[i + 1]
        i += 2
        if sp == "%":
            out.append("%")
            continue
        if sp in _DATE_SPECS and "Y" not in comp:
            return None
        if sp in _TIME_SPECS and "H" not in comp:
            return None
        if sp == "Y":
            out.append(f"{comp['Y']:04d}")
        elif sp == "m":
            out.append(f"{comp['m']:02d}")
        elif sp in ("d",):
            out.append(f"{comp['d']:02d}")
        elif sp == "e":
            out.append(str(comp["d"]))
        elif sp == "F":
            out.append(f"{comp['Y']:04d}-{comp['m']:02d}-{comp['d']:02d}")
        elif sp == "j":
            doy = (_dt.date(comp["Y"], comp["m"], comp["d"])
                   - _dt.date(comp["Y"], 1, 1)).days + 1
            out.append(f"{doy:03d}")
        elif sp == "W":
            out.append(_dt.date(comp["Y"], comp["m"],
                                comp["d"]).strftime("%W"))
        elif sp == "H":
            out.append(f"{comp['H']:02d}")
        elif sp in ("M", "i"):
            out.append(f"{comp['M']:02d}")
        elif sp in ("S", "s"):
            out.append(f"{comp['S']:02d}")
        elif sp == "f":
            out.append(f"{comp['f']:06d}")
        elif sp == "T":
            out.append(f"{comp['H']:02d}:{comp['M']:02d}:{comp['S']:02d}")
        else:
            return None
    return "".join(out)


def _temporal_components(v):
    if isinstance(v, DateTime):
        return {"Y": v.year, "m": v.month, "d": v.day, "H": v.hour,
                "M": v.minute, "S": v.sec, "f": v.microsec}
    if isinstance(v, Date):
        return {"Y": v.year, "m": v.month, "d": v.day}
    if isinstance(v, Time):
        return {"H": v.hour, "M": v.minute, "S": v.sec, "f": v.microsec}
    if isinstance(v, int) and not isinstance(v, bool):
        t = _dt.datetime.fromtimestamp(v, _dt.timezone.utc)
        return {"Y": t.year, "m": t.month, "d": t.day, "H": t.hour,
                "M": t.minute, "S": t.second, "f": t.microsecond}
    return None


@register("date_format")
def _date_format(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if len(args) != 2 or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    comp = _temporal_components(args[0])
    if comp is None or "Y" not in comp:
        return NULL_BAD_TYPE
    s = _format_components(args[1], comp)
    return NULL_BAD_DATA if s is None else s


@register("time_format")
def _time_format(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if len(args) != 2 or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    comp = _temporal_components(args[0])
    if comp is None or "H" not in comp:
        return NULL_BAD_TYPE
    s = _format_components(args[1], comp)
    return NULL_BAD_DATA if s is None else s


# ---- internal helpers used by MATCH planning -------------------------------


@register("_hastag")
def _hastag(ctx, args):
    v, tag = args[0], args[1]
    if isinstance(v, Vertex):
        return tag in v.tag_names()
    return False


@register("_exists")
def _exists(ctx, args):
    v = args[0]
    return not is_null(v) and not is_empty(v)


@register("_edges_distinct")
def _edges_distinct(ctx, args):
    """Internal: relationship-uniqueness gate the MATCH planner plants
    when a pattern has two or more edge variables (Cypher relationship
    isomorphism; reference: MATCH edges within one pattern never bind
    the same edge twice).  Each arg is an Edge, a list of Edges (a
    variable-length binding), or NULL (zero-hop) — True iff no edge key
    appears twice across all of them."""
    seen = set()
    for v in args:
        edges = v if isinstance(v, list) else ([] if is_null(v) else [v])
        for e in edges:
            if not isinstance(e, Edge):
                continue
            k = e.key()
            if k in seen:
                return False
            seen.add(k)
    return True


@register("duration")
def _duration(ctx, args):
    if len(args) == 2:
        # two-timestamp overload (reference convenience form): the
        # elapsed Duration t1 → t2, i.e. exactly t2 - t1
        n = _nullprop(args)
        if n is not None:
            return n
        a, b = args
        if isinstance(a, DateTime) and isinstance(b, DateTime):
            # calendar-exact epoch-µs diff (to_timestamp truncates toward
            # zero, which is off by 1s for pre-1970 values with µs)
            def us(v):
                delta = (_dt.datetime(v.year, v.month, v.day, v.hour,
                                      v.minute, v.sec, v.microsec,
                                      tzinfo=_dt.timezone.utc)
                         - _dt.datetime(1970, 1, 1,
                                        tzinfo=_dt.timezone.utc))
                return ((delta.days * 86400 + delta.seconds) * 1_000_000
                        + delta.microseconds)
            diff = us(b) - us(a)
            return Duration(diff // 1_000_000, diff % 1_000_000, 0)
        if (isinstance(a, int) and isinstance(b, int)
                and not isinstance(a, bool) and not isinstance(b, bool)):
            return Duration(int(b - a), 0, 0)
        return NULL_BAD_TYPE
    v = args[0]
    if is_null(v):
        return v
    if isinstance(v, dict):
        secs = (v.get("seconds", 0) + v.get("minutes", 0) * 60
                + v.get("hours", 0) * 3600 + v.get("days", 0) * 86400)
        months = v.get("months", 0) + v.get("years", 0) * 12
        return Duration(int(secs), v.get("microseconds", 0), int(months))
    return NULL_BAD_TYPE


# ---------------------------------------------------------------------------
# Spatial functions — the ST_* family over the Geography value type
# (NebulaGraph's src/common/function geo functions, backed by S2;
# simplifications documented in core/geo.py).
# ---------------------------------------------------------------------------


def _geo_args(args, n):
    from .geo import Geography
    nl = _nullprop(args)
    if nl is not None:
        return nl, None
    if len(args) < n:
        return NULL_BAD_TYPE, None
    for a in args[:n]:
        if not isinstance(a, Geography):
            return NULL_BAD_TYPE, None
    return None, args


@register("st_point")
def _st_point(ctx, args):
    from .geo import Geography
    n = _nullprop(args)
    if n is not None:
        return n
    if len(args) != 2 or not _num(args[0]) or not _num(args[1]):
        return NULL_BAD_TYPE
    g = Geography("point", (float(args[0]), float(args[1])))
    return g if g.is_valid() else NULL_BAD_DATA


def _from_text(ctx, args):
    from .geo import GeoError, from_wkt
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str):
        return NULL_BAD_TYPE
    try:
        return from_wkt(args[0])
    except GeoError:
        return NULL_BAD_DATA


register("st_geogfromtext")(_from_text)
register("st_pointfromtext")(_from_text)
register("st_linestringfromtext")(_from_text)
register("st_polygonfromtext")(_from_text)


@register("st_astext")
def _st_astext(ctx, args):
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    return a[0].wkt()


@register("st_x")
def _st_x(ctx, args):
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    if a[0].kind != "point":
        return NULL_BAD_TYPE
    return a[0].coords[0]


@register("st_y")
def _st_y(ctx, args):
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    if a[0].kind != "point":
        return NULL_BAD_TYPE
    return a[0].coords[1]


@register("st_centroid")
def _st_centroid(ctx, args):
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    return a[0].centroid()


@register("st_isvalid")
def _st_isvalid(ctx, args):
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    return a[0].is_valid()


@register("st_distance")
def _st_distance(ctx, args):
    from .geo import distance_m
    err, a = _geo_args(args, 2)
    if a is None:
        return err
    return distance_m(a[0], a[1])


@register("st_dwithin")
def _st_dwithin(ctx, args):
    from .geo import distance_m
    err, a = _geo_args(args, 2)
    if a is None:
        return err
    if len(args) < 3 or not _num(args[2]):
        return NULL_BAD_TYPE
    return distance_m(a[0], a[1]) <= float(args[2])


@register("st_intersects")
def _st_intersects(ctx, args):
    from .geo import intersects
    err, a = _geo_args(args, 2)
    if a is None:
        return err
    return intersects(a[0], a[1])


@register("st_covers")
def _st_covers(ctx, args):
    from .geo import covers
    err, a = _geo_args(args, 2)
    if a is None:
        return err
    return covers(a[0], a[1])


@register("st_coveredby")
def _st_coveredby(ctx, args):
    from .geo import covers
    err, a = _geo_args(args, 2)
    if a is None:
        return err
    return covers(a[1], a[0])


@register("s2_cellidfrompoint")
def _s2_cellid(ctx, args):
    from .geo import cell_token
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    level = args[1] if len(args) > 1 else 30
    if not isinstance(level, int):
        return NULL_BAD_TYPE
    return cell_token(a[0], level)


@register("s2_coveringcellids")
def _s2_covering(ctx, args):
    from .geo import Geography, cell_token
    err, a = _geo_args(args, 1)
    if a is None:
        return err
    level = args[1] if len(args) > 1 else 8
    if not isinstance(level, int):
        return NULL_BAD_TYPE
    return sorted({cell_token(Geography("point", p), level)
                   for p in a[0].points()})


# ---------------------------------------------------------------------------
# Remaining scalar families (bit ops, trig conversions, temporal
# components, list/string helpers) — FunctionManager parity fill-in.
# ---------------------------------------------------------------------------


_math1("radians", math.radians)
_math1("degrees", math.degrees)
_math1("sinh", math.sinh)
_math1("cosh", math.cosh)
_math1("tanh", math.tanh)


@register("udf_is_in")
def _udf_is_in(ctx, args):
    if not args:
        return NULL_BAD_TYPE
    from .value import v_eq
    needle = args[0]
    for x in args[1:]:
        if v_eq(needle, x) is True:
            return True
    return False


@register("cos_similarity")
def _cos_similarity(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    if len(args) % 2 != 0 or not args:
        return NULL_BAD_DATA
    half = len(args) // 2
    xs, ys = args[:half], args[half:]
    if not all(_num(v) for v in xs + ys):
        return NULL_BAD_TYPE
    dot = sum(x * y for x, y in zip(xs, ys))
    nx = math.sqrt(sum(x * x for x in xs))
    ny = math.sqrt(sum(y * y for y in ys))
    if nx == 0.0 or ny == 0.0:
        return NULL_BAD_DATA
    return dot / (nx * ny)


@register("edges")
def _edges_of_path(ctx, args):
    if not args:
        return NULL_BAD_TYPE
    n = _nullprop(args)
    if n is not None:
        return n
    if isinstance(args[0], Path):
        return FUNCTIONS["relationships"](ctx, args)
    return NULL_BAD_TYPE


@register("extract")
def _extract(ctx, args):
    """extract(string, regex) — all non-overlapping matches."""
    import re as _re
    n = _nullprop(args)
    if n is not None:
        return n
    if len(args) != 2 or not isinstance(args[0], str) \
            or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    try:
        # full matched substrings — findall would return capture-group
        # contents (or tuples) when the regex has groups
        return [m.group(0) for m in _re.finditer(args[1], args[0])]
    except _re.error:
        return NULL_BAD_DATA


@register("json_extract")
def _json_extract(ctx, args):
    import json as _json
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str):
        return NULL_BAD_TYPE
    try:
        v = _json.loads(args[0])
    except ValueError:
        return NULL_BAD_DATA
    return v if isinstance(v, dict) else NULL_BAD_DATA


def _temporal_part(name, attr):
    @register(name)
    def _fn(ctx, args, _attr=attr):
        n = _nullprop(args)
        if n is not None:
            return n
        v = args[0]
        for cls in (Date, Time, DateTime):
            if isinstance(v, cls) and hasattr(v, _attr):
                return getattr(v, _attr)
        return NULL_BAD_TYPE
    return _fn


_temporal_part("year", "year")
_temporal_part("month", "month")
_temporal_part("day", "day")
_temporal_part("hour", "hour")
_temporal_part("minute", "minute")
_temporal_part("second", "sec")
_temporal_part("microsecond", "microsec")


@register("dayofweek")
def _dayofweek(ctx, args):
    """1 = Sunday ... 7 = Saturday (the reference's convention)."""
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if not isinstance(v, (Date, DateTime)):
        return NULL_BAD_TYPE
    d = _dt.date(v.year, v.month, v.day)
    return (d.weekday() + 1) % 7 + 1


@register("dayofyear")
def _dayofyear(ctx, args):
    n = _nullprop(args)
    if n is not None:
        return n
    v = args[0]
    if not isinstance(v, (Date, DateTime)):
        return NULL_BAD_TYPE
    return _dt.date(v.year, v.month, v.day).timetuple().tm_yday


# ---- text-search predicates (the full-text listener's) --------------------
# LOOKUP's PREFIX/WILDCARD/REGEXP/FUZZY normally plan into a
# FulltextIndexScan; these host evaluators keep the SAME value-level
# semantics (graphstore/fulltext.py) for every other placement — a
# second text conjunct, OR/NOT composition, residual re-checks.

def _text2(args):
    """-> (value, pattern) or a null to propagate / NULL_BAD_TYPE."""
    n = _nullprop(args)
    if n is not None:
        return n
    if not isinstance(args[0], str) or not isinstance(args[1], str):
        return NULL_BAD_TYPE
    return None


@register("prefix")
def _fn_prefix(ctx, args):
    bad = _text2(args)
    if bad is not None:
        return bad
    return args[0].lower().startswith(args[1].lower())


@register("wildcard")
def _fn_wildcard(ctx, args):
    import fnmatch as _fn
    bad = _text2(args)
    if bad is not None:
        return bad
    return _fn.fnmatch(args[0].lower(), args[1].lower())


@register("regexp")
def _fn_regexp(ctx, args):
    import re as _re
    bad = _text2(args)
    if bad is not None:
        return bad
    try:
        return _re.search(args[1], args[0]) is not None
    except _re.error:
        return NULL_BAD_DATA


@register("fuzzy")
def _fn_fuzzy(ctx, args):
    from ..graphstore.fulltext import analyze, levenshtein_leq
    bad = _text2(args)
    if bad is not None:
        return bad
    toks = analyze(args[1])
    if not toks:
        return False
    q = toks[0]
    k = 1 if len(q) < 6 else 2
    return any(levenshtein_leq(t, q, k) for t in analyze(args[0]))
