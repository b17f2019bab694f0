"""nGQL lexer.

A copy of `nebula_tpu/query/tokenizer.py`.  Replaces NebulaGraph's flex
scanner (src/parser/scanner.lex) with a hand-written tokenizer: the
grammar is the spec; parse time is microseconds against millisecond queries,
so a generated scanner buys nothing here.

Token kinds: KEYWORD (uppercased), IDENT, STRING, INT, FLOAT, BOOL, and
punctuation/operator tokens whose `kind` is the operator text itself
('==', '->', '..', '$-', etc.).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

KEYWORDS = {
    # statements
    "GO", "FROM", "OVER", "WHERE", "YIELD", "AS", "STEPS", "STEP", "TO",
    "REVERSELY", "BIDIRECT", "USE", "CREATE", "DROP", "SPACE", "SPACES",
    "TAG", "TAGS", "EDGE", "EDGES", "IF", "NOT", "EXISTS", "ALTER", "ADD",
    "CHANGE", "DESCRIBE", "DESC", "SHOW", "HOSTS", "PARTS", "PARTITION",
    "INSERT", "VERTEX", "VERTICES", "VALUES", "DELETE", "UPDATE", "UPSERT",
    "SET", "WHEN", "FETCH", "PROP", "ON", "LOOKUP", "MATCH", "OPTIONAL",
    "RETURN", "WITH", "UNWIND", "SKIP", "LIMIT", "OFFSET", "ORDER", "BY",
    "ASC", "ASCENDING", "DESCENDING", "GROUP", "DISTINCT", "FIND", "PATH",
    "SHORTEST", "ALL", "NOLOOP", "UPTO", "GET", "SUBGRAPH", "BOTH", "IN",
    "OUT", "EXPLAIN", "PROFILE", "FORMAT", "UNION", "INTERSECT", "MINUS",
    "INDEX", "INDEXES", "REBUILD", "STATS", "SUBMIT", "JOB", "JOBS",
    "BALANCE", "DATA", "LEADER", "SNAPSHOT", "SNAPSHOTS", "SESSION",
    "SESSIONS", "KILL", "QUERY", "QUERIES", "CONFIGS", "TTL_DURATION",
    "TTL_COL", "DEFAULT", "NULL", "COMMENT", "SAMPLE", "INGEST",
    "USER", "USERS", "PASSWORD", "GRANT", "REVOKE", "ROLE", "ROLES",
    "ZONE", "ZONES", "INTO", "FULLTEXT", "LISTENER", "ELASTICSEARCH",
    "REMOVE", "CHARSET", "COLLATION", "CLEAR", "STOP", "RECOVER", "SIGN",
    "MERGE", "RENAME", "DIVIDE", "TEXT", "SERVICE", "SEARCH", "CLIENTS",
    "STATUS",
    "META", "GRAPH", "STORAGE", "DOWNLOAD", "HDFS",
    "BACKUP", "BACKUPS", "RESTORE", "NEW", "LOCAL", "TRACES",
    "FLIGHT", "RECORDER", "SLO", "STALLS", "CALL", "REPAIRS",
    "STATEMENTS", "HOTSPOTS", "TENANTS",
    # types
    "INT", "INT64", "INT32", "INT16", "INT8", "FLOAT", "DOUBLE", "STRING",
    "FIXED_STRING", "BOOL", "TIMESTAMP", "DATE", "TIME", "DATETIME",
    "DURATION", "GEOGRAPHY",
    # expression keywords
    "AND", "OR", "XOR", "TRUE", "FALSE", "CONTAINS", "STARTS", "ENDS",
    "IS", "CASE", "THEN", "ELSE", "END", "EMPTY",
    # reserved column-ish
    "VID_TYPE", "PARTITION_NUM", "REPLICA_FACTOR",
}

PUNCT2 = ["==", "!=", ">=", "<=", "=~", "->", "<-", "..", "|>", "+=", "::",
          "$-", "$^", "$$", "//", "--"]
PUNCT1 = list("()[]{}<>+-*/%!=.,:;|@?&^~#")


class Token(NamedTuple):
    kind: str         # 'KEYWORD' | 'IDENT' | 'STRING' | 'INT' | 'FLOAT' | op-text
    value: Any
    pos: int
    raw: str = ""     # keyword tokens keep the source spelling so an
                      # unreserved keyword used as an identifier (a tag
                      # named `User`, a prop named `role`) round-trips
                      # case-sensitively through Parser.ident()

    def __repr__(self):
        return f"{self.kind}({self.value!r})"


class LexError(Exception):
    def __init__(self, msg: str, pos: int):
        super().__init__(f"{msg} near position {pos}")
        self.pos = pos


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        # comments: # ... EOL and // ... EOL
        if c == "#" or text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise LexError("unterminated comment", i)
            i = j + 2
            continue
        # strings
        if c in "'\"":
            s, j = _scan_string(text, i)
            toks.append(Token("STRING", s, i))
            i = j
            continue
        # backquoted identifier
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise LexError("unterminated backquoted identifier", i)
            toks.append(Token("IDENT", text[i + 1:j], i))
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            tok, j = _scan_number(text, i)
            toks.append(tok)
            i = j
            continue
        # identifiers / keywords / $var
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            up = word.upper()
            if up in KEYWORDS:
                toks.append(Token("KEYWORD", up, i, word))
            else:
                toks.append(Token("IDENT", word, i))
            i = j
            continue
        if c == "$":
            # $-, $^, $$ handled below via PUNCT2; $name here
            two = text[i:i + 2]
            if two in ("$-", "$^", "$$"):
                toks.append(Token(two, two, i))
                i += 2
                continue
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            if j == i + 1:
                raise LexError("bare `$'", i)
            toks.append(Token("VAR", text[i + 1:j], i))
            i = j
            continue
        # two-char operators
        two = text[i:i + 2]
        if two in PUNCT2 and two not in ("$-", "$^", "$$", "//", "--"):
            toks.append(Token(two, two, i))
            i += 2
            continue
        if c in PUNCT1:
            toks.append(Token(c, c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r}", i)
    toks.append(Token("EOF", None, n))
    return toks


def _scan_string(text: str, i: int):
    quote = text[i]
    out = []
    j = i + 1
    n = len(text)
    while j < n:
        c = text[j]
        if c == "\\" and j + 1 < n:
            nxt = text[j + 1]
            esc = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'",
                   '"': '"', "0": "\0", "b": "\b", "f": "\f"}.get(nxt)
            out.append(esc if esc is not None else nxt)
            j += 2
            continue
        if c == quote:
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise LexError("unterminated string", i)


def _scan_number(text: str, i: int):
    n = len(text)
    j = i
    if text.startswith("0x", i) or text.startswith("0X", i):
        j = i + 2
        while j < n and text[j] in "0123456789abcdefABCDEF":
            j += 1
        return Token("INT", int(text[i:j], 16), i), j
    is_float = False
    while j < n and text[j].isdigit():
        j += 1
    if j < n and text[j] == "." and not text.startswith("..", j):
        if j + 1 < n and text[j + 1].isdigit():
            is_float = True
            j += 1
            while j < n and text[j].isdigit():
                j += 1
    if j < n and text[j] in "eE":
        k = j + 1
        if k < n and text[k] in "+-":
            k += 1
        if k < n and text[k].isdigit():
            is_float = True
            j = k
            while j < n and text[j].isdigit():
                j += 1
    s = text[i:j]
    if is_float:
        return Token("FLOAT", float(s), i), j
    return Token("INT", int(s), i), j
