"""The port's copy of `nebula_tpu/graphstore/fulltext.py`, whole.

Full-text search plane: inverted index + async listener.

Reference architecture (SURVEY §2 row 10 `Listener`, §1 L4): storaged
replicates each part's committed raft log to an external
Elasticsearch sink via a `Listener` (a raft learner), and
LOOKUP's text predicates (PREFIX / WILDCARD / REGEXP / FUZZY) are served
from that sink, eventually-consistent with the base data.

This build keeps the same shape with the sink in-process:

  * every write-path mutation enqueues (never applies inline) to a
    `FulltextListener` — a single background thread that is the ONLY
    writer to the `FulltextIndexData` structures, mirroring the
    one-way replication of the reference (base writes never wait for
    the text index);
  * text LOOKUPs call `drain()` first, upgrading the reference's
    eventual consistency to read-your-writes — cheap in-process, and it
    keeps TCK scenarios deterministic (a documented deviation);
  * cluster replicas apply the same raw write commands through the same
    store hooks, so each replica maintains its own sink — the
    leader-local search result equals what the reference's shared ES
    cluster would return for that part.

Query semantics (value-level, matching the reference's LOOKUP text ops):
  PREFIX(tag.prop, "b")      — value starts with "b" (case-folded)
  WILDCARD(tag.prop, "*b?")  — fnmatch over the whole value (case-folded)
  REGEXP(tag.prop, "re")     — re.search over the raw value
  FUZZY(tag.prop, "word")    — some TOKEN within Levenshtein distance
                               (auto: 1 for len<6, else 2) of the query
The token inverted index accelerates FUZZY (vocabulary scan, not corpus
scan); the other ops scan per-part value maps, which are dicts small
enough that Python-loop cost matches the host parity plan everywhere
else in the engine.
"""
from __future__ import annotations

import fnmatch
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .index import norm


def analyze(text: str) -> List[str]:
    """Lowercased alphanumeric word tokens (the `standard` analyzer)."""
    return re.findall(r"[0-9a-z]+", text.lower())


def levenshtein_leq(a: str, b: str, k: int) -> bool:
    """Edit distance(a, b) <= k, banded (O(len*k))."""
    if abs(len(a) - len(b)) > k:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        lo = max(1, i - k)
        hi = min(len(b), i + k)
        if lo > 1:
            cur[lo - 1] = k + 1
        for j in range(lo, hi + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != b[j - 1]))
        if hi < len(b):
            cur[hi + 1:] = [k + 1] * (len(b) - hi)
        if min(cur) > k:
            return False
        prev = cur
    return prev[len(b)] <= k


class TextServiceRegistry:
    """SIGN IN/OUT TEXT SERVICE target list (the reference registers
    external Elasticsearch clients in metad; the in-process fulltext
    plane doesn't need one to FUNCTION, but the statement surface and
    SHOW TEXT SEARCH CLIENTS must reflect what an operator signed in).
    Process-local; the cluster graphd layer shares one process."""

    def __init__(self):
        self.clients: list = []     # [{"host", "port", "user"}]

    def sign_in(self, endpoints, user=None, password=None):
        for ep in endpoints:
            host, _, port = ep.partition(":")
            self.clients.append({"host": host,
                                 "port": int(port) if port else 9200,
                                 "user": user or "", "conn": "http"})

    def sign_out(self):
        if not self.clients:
            raise ValueError("no text service clients signed in")
        self.clients.clear()


def text_services(store) -> TextServiceRegistry:
    """The store's registry (created on demand) — store-scoped so every
    engine/test gets isolated sign-in state, like the rest of the
    catalog."""
    reg = getattr(store, "_text_services", None)
    if reg is None:
        reg = store._text_services = TextServiceRegistry()
    return reg


class FulltextIndexData:
    """One full-text index over one string field of one tag/edge.

    Per part: `values` entity→raw string (the scan corpus) and an
    inverted `tokens` token→set(entity) map (the FUZZY vocabulary).
    Single-writer: only the FulltextListener thread mutates these."""

    def __init__(self, name: str, schema_name: str, field: str,
                 is_edge: bool, num_parts: int, index_id: int,
                 analyzer: str = "standard"):
        self.name = name
        self.schema_name = schema_name
        self.field = field
        self.is_edge = is_edge
        self.index_id = index_id
        self.analyzer = analyzer
        # guards values/tokens: the listener thread writes while query
        # threads search — unsynchronized dict iteration would raise
        # "dictionary changed size during iteration" mid-LOOKUP
        from ..utils.racecheck import make_lock
        self.lock = make_lock("fulltext_data")
        self.values: List[Dict[Any, str]] = [dict()
                                             for _ in range(num_parts)]
        self.tokens: List[Dict[str, set]] = [dict()
                                             for _ in range(num_parts)]

    def add(self, part: int, text: str, entity: Any):
        with self.lock:
            self.values[part][entity] = text
            tm = self.tokens[part]
            for tok in set(analyze(text)):
                tm.setdefault(tok, set()).add(entity)

    def remove(self, part: int, entity: Any):
        with self.lock:
            text = self.values[part].pop(entity, None)
            if text is None:
                return
            tm = self.tokens[part]
            for tok in set(analyze(text)):
                s = tm.get(tok)
                if s is not None:
                    s.discard(entity)
                    if not s:
                        del tm[tok]

    def clear(self):
        with self.lock:
            for d in self.values:
                d.clear()
            for d in self.tokens:
                d.clear()

    def count(self) -> int:
        with self.lock:
            return sum(len(d) for d in self.values)

    # -- search ----------------------------------------------------------

    def search(self, op: str, pattern: str,
               parts: Optional[List[int]] = None) -> List[Any]:
        """Entities whose value matches, part-ordered then value-ordered
        (deterministic rows for the executor)."""
        op = op.upper()
        part_ids = parts if parts is not None \
            else range(len(self.values))
        out: List[Any] = []
        if op == "REGEXP":
            try:
                rx = re.compile(pattern)
            except re.error as ex:
                raise ValueError(f"bad REGEXP pattern: {ex}") from None
        elif op == "WILDCARD":
            rx = re.compile(fnmatch.translate(pattern.lower()))
        with self.lock:
            for pid in part_ids:
                vals = self.values[pid]
                if op == "PREFIX":
                    pat = pattern.lower()
                    hits = [e for e, v in vals.items()
                            if v.lower().startswith(pat)]
                elif op == "WILDCARD":
                    hits = [e for e, v in vals.items()
                            if rx.match(v.lower())]
                elif op == "REGEXP":
                    hits = [e for e, v in vals.items() if rx.search(v)]
                elif op == "FUZZY":
                    toks = analyze(pattern)
                    if not toks:
                        hits = []
                    else:
                        q = toks[0]
                        k = 1 if len(q) < 6 else 2
                        ents: set = set()
                        for tok, posting in self.tokens[pid].items():
                            if levenshtein_leq(tok, q, k):
                                ents |= posting
                        hits = list(ents)
                else:
                    raise ValueError(f"unknown text-search op `{op}'")
                hits.sort(key=lambda e: tuple(norm(x) for x in e)
                          if isinstance(e, tuple) else (norm(e),))
                out.extend(hits)
        return out


class FulltextListener:
    """The async replication thread feeding every full-text index of one
    store process (reference: one Listener replica per part shipping
    committed logs to ES; here one thread draining a queue of
    already-committed mutations).

    Single consumer; producers are the store's write paths.  `drain()`
    blocks until everything enqueued before the call has applied."""

    def __init__(self):
        self.q: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self.applied = 0
        self._lock = threading.Lock()
        self._targets: Dict[Tuple[str, str], FulltextIndexData] = {}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ft-listener")
        self._thread.start()

    def register(self, space: str, data: FulltextIndexData):
        with self._lock:
            self._targets[(space, data.name)] = data

    def unregister(self, space: str, name: str):
        with self._lock:
            self._targets.pop((space, name), None)

    def target(self, space: str, name: str) -> Optional[FulltextIndexData]:
        with self._lock:
            return self._targets.get((space, name))

    # -- producer side ---------------------------------------------------

    def enqueue(self, op: str, space: str, name: str, part: int = 0,
                text: str = "", entity: Any = None, gen: int = 0):
        """`gen` is the target index's index_id: ops in flight across a
        DROP + re-CREATE of the same name must NOT apply to the new
        incarnation (it starts empty until REBUILD)."""
        self.q.put((op, space, name, part, text, entity, gen))

    def drain(self, stall_timeout: float = 30.0):
        """Wait until the queue as of now is fully applied.

        The timeout is PROGRESS-aware, not absolute: a full-corpus
        REBUILD can legitimately take minutes, so only a listener that
        stops applying for `stall_timeout` seconds raises."""
        done = threading.Event()
        self.q.put(("__mark__", done))
        last, stalled_since = -1, time.monotonic()
        while not done.wait(0.2):
            now = time.monotonic()
            if self.applied != last:
                last, stalled_since = self.applied, now
            elif now - stalled_since > stall_timeout:
                raise TimeoutError("fulltext listener failed to drain")

    def lag(self) -> int:
        return self.q.qsize()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._targets)
        return {"type": "ELASTICSEARCH", "status": "ONLINE",
                "indexes": n, "applied": self.applied,
                "lag": self.lag()}

    def stop(self):
        self.q.put(None)
        self._thread.join(timeout=5)

    # -- consumer side ---------------------------------------------------

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if item[0] == "__mark__":
                item[1].set()
                continue
            op, space, name, part, text, entity, gen = item
            tgt = self.target(space, name)
            if tgt is None or tgt.index_id != gen:
                continue        # index dropped/recreated with ops in flight
            try:
                if op == "add":
                    tgt.add(part, text, entity)
                elif op == "remove":
                    tgt.remove(part, entity)
                elif op == "clear":
                    tgt.clear()
            except Exception:       # a poison row must not kill the sink
                pass
            self.applied += 1
