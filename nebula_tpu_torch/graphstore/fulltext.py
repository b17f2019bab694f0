"""The full-text analyzer and the fuzzy match, copied from
`nebula_tpu/graphstore/fulltext.py`.

Only what the FUZZY predicate of `core/functions.py` calls: `analyze`
(the standard analyzer's word tokens) and `levenshtein_leq`.  The
inverted index and its listener wait for the port's store.
"""
from __future__ import annotations

import re
from typing import List


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
