"""nGQL parser: hand-written recursive descent + Pratt expressions.

A copy of `nebula_tpu/query/parser.py`.  Replaces NebulaGraph's bison
grammar (src/parser/parser.yy).  The grammar below is the supported
subset: GO / FETCH / LOOKUP / MATCH / FIND PATH / GET SUBGRAPH / YIELD,
DDL (space/tag/edge/index), DML (insert/update/upsert/delete), admin
(SHOW/DESCRIBE/EXPLAIN/PROFILE/jobs/snapshot), composition (`;`, `|`,
assignment, UNION/INTERSECT/MINUS).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.expr import (AggExpr, AttributeExpr, Binary, Case, EdgeExpr,
                         Expr, FunctionCall, InputProp, LabelExpr,
                         ListComprehension, ListExpr, Literal, MapExpr,
                         PatternPredExpr, PredicateExpr, Reduce, SetExpr,
                         Slice, SrcProp, Subscript, Unary, VarExpr, VarProp,
                         VertexExpr, DstProp)
from ..core.expr import AGG_NAMES
from ..core.value import NULL
from . import ast as A
from .tokenizer import LexError, Token, tokenize


class ParseError(Exception):
    pass


PIPE_STARTERS = {"GO", "YIELD", "GROUP", "ORDER", "LIMIT", "SAMPLE", "FETCH",
                 "LOOKUP", "DELETE"}


def parse(text: str) -> A.Sentence:
    return Parser(text).parse_program()


def parse_expression(text: str) -> Expr:
    """Parse ONE expression (the wire format for pushed-down storage
    filters — predicates ship as canonical nGQL text, never code)."""
    p = Parser(text)
    e = p.parse_expr()
    if not p.at("EOF"):
        t = p.peek()
        raise ParseError(f"trailing input after expression at pos {t.pos}")
    return e


class Parser:
    def __init__(self, text: str):
        self.text = text
        try:
            self.toks = tokenize(text)
        except LexError as e:
            raise ParseError(str(e)) from None
        self.i = 0
        # >0 while parsing inside a bracketed expression context —
        # gates the bit-or operator (see p_bitor)
        self.bracket = 0

    # ---- token helpers ----
    def peek(self, off=0) -> Token:
        return self.toks[min(self.i + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at(self, kind: str, value=None) -> bool:
        t = self.peek()
        if t.kind != kind:
            return False
        return value is None or t.value == value

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in kws

    def accept(self, kind: str, value=None) -> Optional[Token]:
        if self.at(kind, value):
            return self.next()
        return None

    def accept_kw(self, *kws) -> Optional[Token]:
        if self.at_kw(*kws):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if not self.at(kind, value):
            raise ParseError(f"expected {value or kind}, got {t.kind}"
                             f"({t.value!r}) at pos {t.pos}")
        return self.next()

    def expect_kw(self, *kws) -> Token:
        if not self.at_kw(*kws):
            t = self.peek()
            raise ParseError(f"expected {'/'.join(kws)}, got {t.value!r} at pos {t.pos}")
        return self.next()

    def ident(self, allow_keywords=True) -> str:
        t = self.peek()
        if t.kind == "IDENT":
            return self.next().value
        if allow_keywords and t.kind == "KEYWORD":
            t = self.next()
            return t.raw or t.value.lower()
        raise ParseError(f"expected identifier, got {t.kind}({t.value!r}) at pos {t.pos}")

    # ---- program / composition ----
    def parse_program(self) -> A.Sentence:
        stmts = []
        while not self.at("EOF"):
            if self.accept(";"):
                continue
            stmts.append(self.parse_statement())
            if not self.at("EOF"):
                self.expect(";")
        if not stmts:
            raise ParseError("empty statement")
        return stmts[0] if len(stmts) == 1 else A.SeqSentence(stmts)

    def parse_statement(self) -> A.Sentence:
        if self.at_kw("EXPLAIN", "PROFILE"):
            kw = self.next().value
            fmt = "row"
            if self.accept_kw("FORMAT"):
                self.expect("=")
                fmt = self.expect("STRING").value
            inner = self.parse_statement()
            return A.ExplainSentence(inner, profile=(kw == "PROFILE"), fmt=fmt)
        if self.at("VAR") and self.peek(1).kind == "=":
            var = self.next().value
            self.next()
            return A.AssignSentence(var, self.parse_set_op())
        return self.parse_set_op()

    def parse_set_op(self) -> A.Sentence:
        left = self.parse_pipeline()
        while self.at_kw("UNION", "INTERSECT", "MINUS"):
            op = self.next().value
            if op == "UNION":
                if self.accept_kw("ALL"):
                    op = "UNION ALL"
                elif self.accept_kw("DISTINCT"):
                    pass
            right = self.parse_pipeline()
            left = A.SetOpSentence(op, left, right)
        return left

    def parse_pipeline(self) -> A.Sentence:
        left = self.parse_basic()
        while self.accept("|"):
            right = self.parse_basic()
            left = A.PipedSentence(left, right)
        return left

    # ---- statement dispatch ----
    def parse_basic(self) -> A.Sentence:
        t = self.peek()
        if t.kind == "(":
            # parenthesized compound statement: set-op operands and
            # pipe sources may be grouped, `(A UNION B) | C`
            self.next()
            inner = self.parse_set_op()
            self.expect(")")
            return inner
        if t.kind != "KEYWORD":
            raise ParseError(f"unexpected {t.kind}({t.value!r}) at pos {t.pos}")
        kw = t.value
        fn = {
            "GO": self.p_go, "USE": self.p_use, "CREATE": self.p_create,
            "DROP": self.p_drop, "ALTER": self.p_alter, "SHOW": self.p_show,
            "DESCRIBE": self.p_describe, "DESC": self.p_describe,
            "INSERT": self.p_insert, "DELETE": self.p_delete,
            "UPDATE": self.p_update, "UPSERT": self.p_update,
            "FETCH": self.p_fetch, "LOOKUP": self.p_lookup,
            "MATCH": self.p_match, "OPTIONAL": self.p_match,
            "FIND": self.p_find_path, "GET": self.p_get,
            "YIELD": self.p_yield_stmt, "GROUP": self.p_group_by,
            "ORDER": self.p_order_by, "LIMIT": self.p_limit,
            "SAMPLE": self.p_sample, "REBUILD": self.p_rebuild,
            "SUBMIT": self.p_submit, "KILL": self.p_kill,
            "UNWIND": self.p_match, "GRANT": self.p_grant, "ADD": self.p_add,
            "REVOKE": self.p_revoke, "CHANGE": self.p_change_password,
            "REMOVE": self.p_remove, "CLEAR": self.p_clear,
            "STOP": self.p_stop_job, "RECOVER": self.p_recover_job,
            "RESTORE": self.p_restore_backup,
            "SIGN": self.p_sign, "MERGE": self.p_merge_zone,
            "RENAME": self.p_rename_zone, "DIVIDE": self.p_divide_zone,
            "BALANCE": self.p_balance,
            "DOWNLOAD": self.p_download, "INGEST": self.p_ingest,
            "RETURN": self.p_match, "WITH": self.p_match,
            "CALL": self.p_call_algo,
        }.get(kw)
        if fn is None:
            raise ParseError(f"unsupported statement `{kw}' at pos {t.pos}")
        return fn()

    def p_host_literal(self) -> str:
        """A host endpoint in either spelling: `"h":9779` (the reference
        grammar's STRING ':' port) or `"h:9779"` (one string) —
        normalized to "host:port"."""
        h = self.expect("STRING").value
        if self.accept(":"):
            h = f"{h}:{self.expect('INT').value}"
        return h

    def zone_name(self) -> str:
        """Zone names are quoted strings in the reference grammar but
        bare identifiers are accepted too (our TCK's original spelling)."""
        if self.at("STRING"):
            return self.next().value
        return self.ident()

    def p_add(self) -> A.Sentence:
        """ADD HOSTS "h":port [, ...] [INTO [NEW] ZONE zname] — host
        registration + optional placement zone (no zone → "default");
        ADD LISTENER ELASTICSEARCH "h:p" [, ...] — full-text sink."""
        self.expect_kw("ADD")
        if self.accept_kw("LISTENER"):
            ltype = self.expect_kw("ELASTICSEARCH").value
            eps = [self.expect("STRING").value]
            while self.accept(","):
                eps.append(self.expect("STRING").value)
            return A.AddListenerSentence(ltype, eps)
        self.expect_kw("HOSTS")
        hosts = [self.p_host_literal()]
        while self.accept(","):
            hosts.append(self.p_host_literal())
        zone = "default"
        if self.accept_kw("INTO"):
            self.accept_kw("NEW")
            self.expect_kw("ZONE")
            zone = self.zone_name()
        return A.AddHostsSentence(hosts, zone)

    def p_remove(self) -> A.RemoveListenerSentence:
        self.expect_kw("REMOVE")
        self.expect_kw("LISTENER")
        return A.RemoveListenerSentence(self.expect_kw("ELASTICSEARCH").value)

    def p_get(self) -> A.Sentence:
        """GET SUBGRAPH ... | GET CONFIGS [name]."""
        if self.peek(1).kind == "KEYWORD" and self.peek(1).value == "CONFIGS":
            self.expect_kw("GET")
            self.expect_kw("CONFIGS")
            name = None
            if self.peek().kind in ("IDENT", "KEYWORD") \
                    and not self.at(";"):
                name = self.ident()
                if self.accept(":"):    # module prefix (one process)
                    name = self.ident()
            return A.GetConfigsSentence(name)
        return self.p_subgraph()

    def p_clear(self) -> A.ClearSpaceSentence:
        """CLEAR SPACE [IF EXISTS] name — wipe data, keep schema."""
        self.expect_kw("CLEAR")
        self.expect_kw("SPACE")
        return A.ClearSpaceSentence(if_exists=self.p_if_exists(),
                                    name=self.ident())

    def p_stop_job(self) -> A.StopJobSentence:
        self.expect_kw("STOP")
        self.expect_kw("JOB")
        return A.StopJobSentence(self.expect("INT").value)

    def p_restore_backup(self) -> A.RestoreBackupSentence:
        """RESTORE BACKUP <name> — swap in a CREATE BACKUP checkpoint
        (the statement surface of the reference's br restore)."""
        self.expect_kw("RESTORE")
        self.expect_kw("BACKUP")
        return A.RestoreBackupSentence(self.ident())

    def p_recover_job(self) -> A.RecoverJobSentence:
        self.expect_kw("RECOVER")
        self.expect_kw("JOB")
        jid = None
        if self.at("INT"):
            jid = self.next().value
        return A.RecoverJobSentence(jid)

    def p_sign(self) -> A.Sentence:
        """SIGN IN TEXT SERVICE (host[, user, pw])[, ...] / SIGN OUT
        TEXT SERVICE — external full-text endpoint registration."""
        self.expect_kw("SIGN")
        if self.accept_kw("OUT"):
            self.expect_kw("TEXT")
            self.expect_kw("SERVICE")
            return A.SignOutTextServiceSentence()
        self.expect_kw("IN")
        self.expect_kw("TEXT")
        self.expect_kw("SERVICE")
        eps, user, pw = [], None, None
        while self.accept("("):
            eps.append(self.expect("STRING").value)
            if self.accept(","):
                user = self.expect("STRING").value
                self.expect(",")
                pw = self.expect("STRING").value
            self.expect(")")
            if not self.accept(","):
                break
        if not eps:
            raise ParseError("SIGN IN TEXT SERVICE needs (host) endpoints")
        return A.SignInTextServiceSentence(eps, user, pw)

    def p_merge_zone(self) -> A.MergeZoneSentence:
        self.expect_kw("MERGE")
        self.expect_kw("ZONE")
        zones = [self.zone_name()]
        while self.accept(","):
            zones.append(self.zone_name())
        self.expect_kw("INTO")
        return A.MergeZoneSentence(zones, self.zone_name())

    def p_rename_zone(self) -> A.RenameZoneSentence:
        self.expect_kw("RENAME")
        self.expect_kw("ZONE")
        old = self.zone_name()
        self.expect_kw("TO")
        return A.RenameZoneSentence(old, self.zone_name())

    def p_divide_zone(self) -> A.DivideZoneSentence:
        """DIVIDE ZONE z INTO z1 ("h":p [, ...]) z2 (...) [...] — split a
        placement zone's hosts into new zones; the host lists must
        partition the source zone exactly (meta validates)."""
        self.expect_kw("DIVIDE")
        self.expect_kw("ZONE")
        zone = self.zone_name()
        self.expect_kw("INTO")
        parts = []
        while True:
            name = self.zone_name()
            self.expect("(")
            hosts = [self.p_host_literal()]
            while self.accept(","):
                hosts.append(self.p_host_literal())
            self.expect(")")
            parts.append((name, hosts))
            self.accept(",")
            if self.at(";") or self.at("EOF"):
                break
            # zone_name() also accepts keywords-as-identifiers (e.g.
            # `default`) — continue on any of the three token kinds
            if not (self.at("STRING")
                    or self.peek().kind in ("IDENT", "KEYWORD")):
                break
        if len(parts) < 2:
            raise ParseError("DIVIDE ZONE needs at least two target zones")
        return A.DivideZoneSentence(zone, parts)

    def p_download(self) -> A.DownloadSentence:
        self.expect_kw("DOWNLOAD")
        self.expect_kw("HDFS")
        return A.DownloadSentence(self.expect("STRING").value)

    def p_ingest(self) -> A.IngestSentence:
        self.expect_kw("INGEST")
        return A.IngestSentence()

    def p_balance(self) -> A.SubmitJobSentence:
        """BALANCE DATA [REMOVE "host" [, ...]] / BALANCE LEADER — the
        2.x spelling; canonicalizes to the SUBMIT JOB form the job
        manager executes."""
        self.expect_kw("BALANCE")
        which = self.expect_kw("DATA", "LEADER").value.lower()
        job = f"balance {which}"
        if which == "data" and self.accept_kw("REMOVE"):
            hosts = [self.expect("STRING").value]
            while self.accept(","):
                hosts.append(self.expect("STRING").value)
            job += " remove " + ",".join(hosts)
        return A.SubmitJobSentence(job)

    # ---- user management (reference: GRANT/REVOKE ROLE, CHANGE PASSWORD) --
    def p_grant(self) -> A.GrantRoleSentence:
        self.expect_kw("GRANT")
        self.accept_kw("ROLE")
        role = self.ident()
        self.expect_kw("ON")
        space = self.ident()
        self.expect_kw("TO")
        return A.GrantRoleSentence(role, space, self.ident())

    def p_revoke(self) -> A.RevokeRoleSentence:
        self.expect_kw("REVOKE")
        self.accept_kw("ROLE")
        role = self.ident()
        self.expect_kw("ON")
        space = self.ident()
        self.expect_kw("FROM")
        return A.RevokeRoleSentence(role, space, self.ident())

    def p_change_password(self) -> A.ChangePasswordSentence:
        self.expect_kw("CHANGE")
        self.expect_kw("PASSWORD")
        name = self.ident()
        self.expect_kw("FROM")
        old = self.expect("STRING").value
        self.expect_kw("TO")
        return A.ChangePasswordSentence(name, old, self.expect("STRING").value)

    # ---- GO ----
    def p_go(self) -> A.GoSentence:
        self.expect_kw("GO")
        steps = A.StepClause(1, 1)
        if self.at("INT"):
            m = self.next().value
            if self.accept_kw("TO"):
                n = self.expect("INT").value
                steps = A.StepClause(m, n)
            else:
                steps = A.StepClause(m, m)
            self.expect_kw("STEPS", "STEP")
        from_ = self.p_from()
        over = self.p_over()
        where = self.p_opt_where()
        yld = self.p_opt_yield()
        trunc = None
        if self.at_kw("SAMPLE"):
            self.next()
            trunc = A.TruncateClause(self.p_int_list(), is_sample=True)
        elif self.at_kw("LIMIT"):
            self.next()
            trunc = A.TruncateClause(self.p_int_list(), is_sample=False)
        return A.GoSentence(steps, from_, over, where, yld, trunc)

    def p_from(self) -> A.FromClause:
        self.expect_kw("FROM")
        return self.p_vid_list()

    def p_vid_list(self) -> A.FromClause:
        if self.at("$-") or self.at("VAR"):
            ref = self.parse_expr()
            return A.FromClause(ref=ref)
        vids = [self.parse_expr()]
        while self.accept(","):
            vids.append(self.parse_expr())
        return A.FromClause(vids=vids)

    def p_over(self) -> A.OverClause:
        self.expect_kw("OVER")
        edges: List[str] = []
        if self.accept("*"):
            pass
        else:
            edges.append(self.ident())
            while self.accept(","):
                edges.append(self.ident())
        direction = "out"
        if self.accept_kw("REVERSELY"):
            direction = "in"
        elif self.accept_kw("BIDIRECT"):
            direction = "both"
        return A.OverClause(edges, direction)

    def p_opt_where(self) -> Optional[A.WhereClause]:
        if self.accept_kw("WHERE"):
            return A.WhereClause(self.parse_expr())
        return None

    def p_opt_yield(self) -> Optional[A.YieldClause]:
        if self.at_kw("YIELD"):
            return self.p_yield()
        return None

    def p_yield(self) -> A.YieldClause:
        self.expect_kw("YIELD")
        distinct = bool(self.accept_kw("DISTINCT"))
        cols = [self.p_yield_col()]
        while self.accept(","):
            cols.append(self.p_yield_col())
        return A.YieldClause(cols, distinct)

    def p_yield_col(self) -> A.YieldColumn:
        e = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        return A.YieldColumn(e, alias)

    def p_int_list(self) -> List[int]:
        """Per-step counts — the reference spells them bracketed
        (`LIMIT [10, 100]`); the bare form stays accepted."""
        bracketed = self.accept("[") is not None
        out = [self.expect("INT").value]
        while self.accept(","):
            out.append(self.expect("INT").value)
        if bracketed:
            self.expect("]")
        return out

    # ---- YIELD / pipe segments ----
    def p_yield_stmt(self) -> A.YieldSentence:
        yld = self.p_yield()
        where = self.p_opt_where()
        return A.YieldSentence(yld, where)

    def p_group_by(self) -> A.GroupBySentence:
        self.expect_kw("GROUP")
        self.expect_kw("BY")
        keys = [self.parse_expr()]
        while self.accept(","):
            keys.append(self.parse_expr())
        yld = self.p_yield()
        return A.GroupBySentence(keys, yld)

    def p_order_by(self) -> A.OrderBySentence:
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        factors = [self.p_order_factor()]
        while self.accept(","):
            factors.append(self.p_order_factor())
        return A.OrderBySentence(factors)

    def p_order_factor(self) -> A.OrderFactor:
        e = self.parse_expr()
        asc = True
        if self.accept_kw("ASC", "ASCENDING"):
            asc = True
        elif self.accept_kw("DESC", "DESCENDING"):
            asc = False
        return A.OrderFactor(e, asc)

    def p_limit(self) -> A.LimitSentence:
        self.expect_kw("LIMIT")
        a = self.expect("INT").value
        if self.accept(","):
            b = self.expect("INT").value
            return A.LimitSentence(a, b)
        if self.accept_kw("OFFSET"):
            off = self.expect("INT").value
            return A.LimitSentence(off, a)
        return A.LimitSentence(0, a)

    def p_sample(self) -> A.SampleSentence:
        self.expect_kw("SAMPLE")
        return A.SampleSentence(self.expect("INT").value)

    # ---- USE / DDL ----
    def p_use(self) -> A.UseSentence:
        self.expect_kw("USE")
        return A.UseSentence(self.ident())

    def p_create(self) -> A.Sentence:
        self.expect_kw("CREATE")
        if self.accept_kw("FULLTEXT"):
            # CREATE FULLTEXT {TAG|EDGE} INDEX name ON schema(field)
            is_edge = self.expect_kw("TAG", "EDGE").value == "EDGE"
            self.expect_kw("INDEX")
            ine = self.p_if_not_exists()
            iname = self.ident()
            self.expect_kw("ON")
            sname = self.ident()
            self.expect("(")
            field = self.ident()
            self.expect(")")
            return A.CreateFulltextIndexSentence(is_edge, iname, sname,
                                                 field, ine)
        if self.accept_kw("SPACE"):
            ine = self.p_if_not_exists()
            name = self.ident()
            if self.accept_kw("AS"):
                return A.CreateSpaceAsSentence(name, self.ident(), ine)
            kw = {"partition_num": 8, "replica_factor": 1,
                  "vid_type": "FIXED_STRING(32)"}
            if self.accept("("):
                while not self.accept(")"):
                    opt = self.ident().lower()
                    self.expect("=")
                    if opt == "vid_type":
                        kw["vid_type"] = self.p_type_name()
                    elif opt in ("partition_num", "replica_factor"):
                        kw[opt] = self.expect("INT").value
                    else:
                        raise ParseError(f"unknown space option `{opt}'")
                    self.accept(",")
            cmt = self.p_opt_comment()
            return A.CreateSpaceSentence(name, ine, kw["partition_num"],
                                         kw["replica_factor"], kw["vid_type"], cmt)
        if self.at_kw("TAG", "EDGE"):
            is_edge = self.next().value == "EDGE"
            if self.accept_kw("INDEX"):
                ine = self.p_if_not_exists()
                iname = self.ident()
                self.expect_kw("ON")
                sname = self.ident()
                self.expect("(")
                fields = []
                field_lens = []
                while not self.accept(")"):
                    fields.append(self.ident())
                    ln = 0
                    if self.accept("("):
                        # string columns index a fixed prefix in the
                        # reference: CREATE TAG INDEX i ON t(name(10))
                        ln = self.expect("INT").value
                        if ln <= 0:
                            raise ParseError(
                                "index prefix length must be positive")
                        self.expect(")")
                    field_lens.append(ln)
                    self.accept(",")
                return A.CreateIndexSentence(is_edge, iname, sname, fields,
                                             ine, field_lens)
            ine = self.p_if_not_exists()
            name = self.ident()
            props: List[A.PropDefAst] = []
            if self.accept("("):
                while not self.accept(")"):
                    props.append(self.p_prop_def())
                    self.accept(",")
            ttl_d, ttl_c = 0, ""
            while self.at_kw("TTL_DURATION", "TTL_COL"):
                w = self.next().value
                self.expect("=")
                if w == "TTL_DURATION":
                    ttl_d = self.expect("INT").value
                else:
                    ttl_c = self.expect("STRING").value
                self.accept(",")
            cmt = self.p_opt_comment()
            return A.CreateSchemaSentence(is_edge, name, props, ine, ttl_d, ttl_c, cmt)
        if self.accept_kw("SNAPSHOT"):
            return A.CreateSnapshotSentence()
        if self.accept_kw("BACKUP"):
            name = self.ident() if self.accept_kw("AS") else None
            return A.CreateBackupSentence(name)
        if self.accept_kw("USER"):
            ine = self.p_if_not_exists()
            name = self.ident()
            self.expect_kw("WITH")
            self.expect_kw("PASSWORD")
            pw = self.expect("STRING").value
            return A.CreateUserSentence(name, pw, ine)
        raise ParseError("expected SPACE/TAG/EDGE/SNAPSHOT/USER after CREATE")

    def p_if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def p_if_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def p_opt_comment(self) -> str:
        if self.accept_kw("COMMENT"):
            self.expect("=")
            return self.expect("STRING").value
        return ""

    def p_type_name(self) -> str:
        t = self.peek()
        if t.kind == "KEYWORD" and t.value == "FIXED_STRING":
            self.next()
            self.expect("(")
            n = self.expect("INT").value
            self.expect(")")
            return f"FIXED_STRING({n})"
        if t.kind == "KEYWORD" and t.value == "GEOGRAPHY":
            self.next()
            # GEOGRAPHY(POINT|LINESTRING|POLYGON): the shape constraint
            # is accepted reference-compatibly (stored as geography)
            if self.accept("("):
                self.ident()
                self.expect(")")
            return "GEOGRAPHY"
        if t.kind in ("KEYWORD", "IDENT"):
            return self.next().value
        raise ParseError(f"expected type name at pos {t.pos}")

    def p_prop_def(self) -> A.PropDefAst:
        name = self.ident()
        tname = self.p_type_name()
        fixed = 0
        if tname.upper().startswith("FIXED_STRING("):
            fixed = int(tname[13:-1])
            tname = "FIXED_STRING"
        nullable = True
        default: Optional[Expr] = None
        while True:
            if self.at_kw("NOT") and self.peek(1).value == "NULL":
                self.next(); self.next()
                nullable = False
            elif self.at_kw("NULL"):
                self.next()
                nullable = True
            elif self.accept_kw("DEFAULT"):
                default = self.parse_expr()
            elif self.at_kw("COMMENT"):
                self.next()
                self.expect("=")
                self.expect("STRING")
            else:
                break
        return A.PropDefAst(name, tname, fixed, nullable, default)

    def p_drop(self) -> A.Sentence:
        self.expect_kw("DROP")
        if self.accept_kw("FULLTEXT"):
            self.expect_kw("INDEX")
            ife = self.p_if_exists()
            return A.DropFulltextIndexSentence(self.ident(), ife)
        if self.accept_kw("SPACE"):
            ife = self.p_if_exists()
            return A.DropSpaceSentence(self.ident(), ife)
        if self.at_kw("TAG", "EDGE"):
            is_edge = self.next().value == "EDGE"
            if self.accept_kw("INDEX"):
                ife = self.p_if_exists()
                return A.DropIndexSentence(is_edge, self.ident(), ife)
            ife = self.p_if_exists()
            return A.DropSchemaSentence(is_edge, self.ident(), ife)
        if self.accept_kw("SNAPSHOT"):
            return A.DropSnapshotSentence(self.ident())
        if self.accept_kw("BACKUP"):
            return A.DropBackupSentence(self.ident())
        if self.accept_kw("USER"):
            ife = self.p_if_exists()
            return A.DropUserSentence(self.ident(), ife)
        if self.accept_kw("ZONE"):
            return A.DropZoneSentence(self.zone_name())
        if self.accept_kw("HOSTS"):
            hosts = [self.p_host_literal()]
            while self.accept(","):
                hosts.append(self.p_host_literal())
            return A.DropHostsSentence(hosts)
        raise ParseError(
            "expected SPACE/TAG/EDGE/SNAPSHOT/USER/ZONE/HOSTS after DROP")

    def p_alter(self) -> A.Sentence:
        self.expect_kw("ALTER")
        if self.accept_kw("USER"):
            name = self.ident()
            self.expect_kw("WITH")
            self.expect_kw("PASSWORD")
            return A.AlterUserSentence(name, self.expect("STRING").value)
        if self.accept_kw("SPACE"):
            name = self.ident()
            self.expect_kw("ADD")
            self.expect_kw("ZONE")
            return A.AlterSpaceSentence(name, "add_zone", self.ident())
        is_edge = self.expect_kw("TAG", "EDGE").value == "EDGE"
        name = self.ident()
        out = A.AlterSchemaSentence(is_edge, name)
        while True:
            if self.accept_kw("ADD"):
                self.expect("(")
                while not self.accept(")"):
                    out.adds.append(self.p_prop_def())
                    self.accept(",")
            elif self.accept_kw("DROP"):
                self.expect("(")
                while not self.accept(")"):
                    out.drops.append(self.ident())
                    self.accept(",")
            elif self.accept_kw("CHANGE"):
                self.expect("(")
                while not self.accept(")"):
                    out.changes.append(self.p_prop_def())
                    self.accept(",")
            elif self.at_kw("TTL_DURATION", "TTL_COL"):
                w = self.next().value
                self.expect("=")
                if w == "TTL_DURATION":
                    out.ttl_duration = self.expect("INT").value
                else:
                    out.ttl_col = self.expect("STRING").value
            else:
                break
            if not self.accept(","):
                break
        return out

    def p_show(self) -> A.Sentence:
        self.expect_kw("SHOW")
        t = self.peek()
        if t.kind == "KEYWORD":
            kw = t.value
            if kw == "HOSTS":
                self.next()
                role = self.accept_kw("GRAPH", "STORAGE", "META")
                return A.ShowSentence(
                    "hosts", role.value.lower() if role else None)
            if kw in ("LOCAL", "ALL") \
                    and self.peek(1).kind == "KEYWORD" \
                    and self.peek(1).value in ("SESSIONS", "QUERIES",
                                               "STATEMENTS", "TENANTS"):
                # SHOW LOCAL SESSIONS/QUERIES/STATEMENTS: this graphd
                # only; SHOW ALL ...: cluster-wide (the default)
                scope = self.next().value.lower()
                which = self.next().value.lower()
                return A.ShowSentence(which,
                                      scope if scope == "local" else None)
            if kw in ("SPACES", "PARTS", "STATS", "JOBS", "SESSIONS",
                      "SNAPSHOTS", "BACKUPS", "QUERIES", "CONFIGS",
                      "TRACES", "STALLS", "REPAIRS", "STATEMENTS",
                      "HOTSPOTS", "TENANTS"):
                self.next()
                if kw == "JOBS":
                    return A.ShowJobsSentence()
                return A.ShowSentence(kw.lower())
            if kw == "FLIGHT":
                # SHOW FLIGHT RECORDER: the always-on ring of
                # sampled/slow/failed statement profiles
                self.next()
                self.expect_kw("RECORDER")
                return A.ShowSentence("flight_recorder")
            if kw == "SLO":
                self.next()
                return A.ShowSentence("slo")
            if kw == "TEXT":
                self.next()
                self.expect_kw("SEARCH")
                self.expect_kw("CLIENTS")
                return A.ShowSentence("text_search_clients")
            if kw == "META":
                self.next()
                self.expect_kw("LEADER")
                return A.ShowSentence("meta_leader")
            if kw in ("TAGS", "EDGES", "USERS", "ZONES"):
                self.next()
                return A.ShowSentence(kw.lower())
            if kw == "FULLTEXT":
                self.next()
                self.expect_kw("INDEXES")
                return A.ShowSentence("fulltext_indexes")
            if kw in ("CHARSET", "COLLATION"):
                self.next()
                return A.ShowSentence(kw.lower())
            if kw == "LISTENER":
                self.next()
                return A.ShowSentence("listener")
            if kw == "ROLES":
                self.next()
                self.expect_kw("IN")
                return A.ShowSentence("roles", self.ident())
            if kw in ("TAG", "EDGE"):
                self.next()
                if self.accept_kw("INDEXES"):
                    which = "tag_indexes" if kw == "TAG" else "edge_indexes"
                    if self.accept_kw("STATUS"):
                        return A.ShowSentence(which + "_status")
                    return A.ShowSentence(which)
                if self.accept_kw("INDEX"):
                    self.expect_kw("STATUS")
                    return A.ShowSentence(
                        ("tag_indexes" if kw == "TAG" else "edge_indexes")
                        + "_status")
                raise ParseError("expected INDEXES after SHOW TAG/EDGE")
            if kw == "CREATE":
                self.next()
                which = self.expect_kw("TAG", "EDGE", "SPACE").value
                return A.ShowSentence("create", (which.lower(), self.ident()))
            if kw == "JOB":
                self.next()
                return A.ShowJobsSentence(self.expect("INT").value)
        raise ParseError(f"unsupported SHOW target at pos {t.pos}")

    def p_describe(self) -> A.Sentence:
        self.expect_kw("DESCRIBE", "DESC")
        if self.accept_kw("USER"):
            return A.DescribeUserSentence(self.ident())
        if self.accept_kw("ZONE"):
            return A.DescZoneSentence(self.ident())
        kind = self.expect_kw("SPACE", "TAG", "EDGE", "INDEX").value.lower()
        if kind in ("tag", "edge") and self.accept_kw("INDEX"):
            kind = "index"       # reference spelling: DESC TAG/EDGE INDEX i
        return A.DescribeSentence(kind, self.ident())

    def p_rebuild(self) -> A.Sentence:
        self.expect_kw("REBUILD")
        if self.accept_kw("FULLTEXT"):
            self.expect_kw("INDEX")
            name = None
            if self.peek().kind in ("IDENT", "KEYWORD"):
                name = self.ident()
            return A.RebuildFulltextIndexSentence(name)
        is_edge = self.expect_kw("TAG", "EDGE").value == "EDGE"
        self.expect_kw("INDEX")
        return A.RebuildIndexSentence(is_edge, self.ident())

    def p_submit(self) -> A.SubmitJobSentence:
        self.expect_kw("SUBMIT")
        self.expect_kw("JOB")
        parts = [self.ident().lower()]
        while self.peek().kind in ("KEYWORD", "IDENT", "INT"):
            if self.at("INT"):
                parts.append(str(self.next().value))
            else:
                parts.append(self.ident().lower())
        return A.SubmitJobSentence(" ".join(parts))

    def p_kill(self) -> A.Sentence:
        self.expect_kw("KILL")
        if self.accept_kw("SESSION", "SESSIONS"):
            return A.KillSessionSentence(self.expect("INT").value)
        self.expect_kw("QUERY")
        out = A.KillQuerySentence()
        self.expect("(")
        while not self.accept(")"):
            which = self.ident().lower()
            self.expect("=")
            v = self.expect("INT").value
            if which == "session":
                out.session_id = v
            else:
                out.plan_id = v
            self.accept(",")
        return out

    # ---- DML ----
    def p_insert(self) -> A.Sentence:
        self.expect_kw("INSERT")
        if self.accept_kw("VERTEX"):
            ine = self.p_if_not_exists()
            groups = []
            while True:
                tag = self.ident()
                groups.append((tag, self.p_name_list_paren()))
                if not self.accept(","):
                    break
            self.expect_kw("VALUES")
            rows = []
            while True:
                vid = self.parse_expr()
                self.expect(":")
                self.expect("(")
                vals = []
                while not self.accept(")"):
                    vals.append(self.parse_expr())
                    self.accept(",")
                rows.append(A.VertexRowAst(vid, vals))
                if not self.accept(","):
                    break
            return A.InsertVerticesSentence(groups, rows, ine)
        self.expect_kw("EDGE")
        ine = self.p_if_not_exists()
        etype = self.ident()
        names = self.p_name_list_paren()
        self.expect_kw("VALUES")
        rows = []
        while True:
            src = self.parse_expr()
            self.expect("->")
            dst = self.parse_expr()
            rank = 0
            if self.accept("@"):
                rank = self.expect("INT").value
            self.expect(":")
            self.expect("(")
            vals = []
            while not self.accept(")"):
                vals.append(self.parse_expr())
                self.accept(",")
            rows.append(A.EdgeRowAst(src, dst, rank, vals))
            if not self.accept(","):
                break
        return A.InsertEdgesSentence(etype, names, rows, ine)

    def p_name_list_paren(self) -> List[str]:
        self.expect("(")
        names = []
        while not self.accept(")"):
            names.append(self.ident())
            self.accept(",")
        return names

    def p_delete(self) -> A.Sentence:
        self.expect_kw("DELETE")
        if self.accept_kw("VERTEX"):
            vids = self.p_vid_list()
            we = False
            if self.accept_kw("WITH"):
                self.expect_kw("EDGE")
                we = True
            return A.DeleteVerticesSentence(vids, we)
        if self.accept_kw("TAG"):
            tags = []
            if not self.accept("*"):
                tags.append(self.ident())
                while self.accept(","):
                    tags.append(self.ident())
            self.expect_kw("FROM")
            return A.DeleteTagsSentence(tags, self.p_vid_list())
        self.expect_kw("EDGE")
        etype = self.ident()
        if self.at("$-") or self.at("VAR"):
            src = self.parse_expr()
            self.expect("->")
            dst = self.parse_expr()
            rank = None
            if self.accept("@"):
                rank = self.parse_expr()
            return A.DeleteEdgesSentence(etype, [], ref=(src, dst, rank))
        keys = []
        while True:
            src = self.parse_expr()
            self.expect("->")
            dst = self.parse_expr()
            rank = 0
            if self.accept("@"):
                rank = self.expect("INT").value
            keys.append(A.EdgeKeyAst(src, dst, rank))
            if not self.accept(","):
                break
        return A.DeleteEdgesSentence(etype, keys)

    def p_update(self) -> A.Sentence:
        kw = self.expect_kw("UPDATE", "UPSERT").value
        insertable = kw == "UPSERT"
        if not insertable and self.accept_kw("CONFIGS"):
            # UPDATE CONFIGS [module:]name = value [, name = value ...]
            # (gflags live mutation; multi-key batches apply atomically
            # — all keys validate or nothing changes)
            updates = []
            while True:
                name = self.ident()
                if self.accept(":"):
                    name = self.ident()  # module prefix ignored (one proc)
                self.expect("=")
                updates.append((name, self.parse_expr()))
                if not self.accept(","):
                    break
            return A.UpdateConfigsSentence(updates)
        is_edge = self.expect_kw("VERTEX", "EDGE").value == "EDGE"
        self.expect_kw("ON")
        schema = self.ident()
        out = A.UpdateSentence(is_edge, schema, insertable=insertable)
        if is_edge:
            src = self.parse_expr()
            self.expect("->")
            dst = self.parse_expr()
            rank = 0
            if self.accept("@"):
                rank = self.expect("INT").value
            out.edge_key = A.EdgeKeyAst(src, dst, rank)
        else:
            out.vid = self.parse_expr()
        self.expect_kw("SET")
        while True:
            name = self.ident()
            self.expect("=")
            out.sets.append((name, self.parse_expr()))
            if not self.accept(","):
                break
        if self.accept_kw("WHEN"):
            out.when = self.parse_expr()
        out.yield_ = self.p_opt_yield()
        return out

    # ---- FETCH / LOOKUP ----
    def p_fetch(self) -> A.Sentence:
        self.expect_kw("FETCH")
        self.expect_kw("PROP")
        self.expect_kw("ON")
        if self.accept("*"):
            vids = self.p_vid_list()
            return A.FetchVerticesSentence([], vids, self.p_opt_yield())
        names = [self.ident()]
        while self.accept(","):
            names.append(self.ident())
        # edge fetch: src -> dst follows
        save = self.i
        first = self.parse_expr()
        if self.at("->"):
            self.next()
            if len(names) != 1:
                raise ParseError("FETCH PROP ON edge takes one edge type")
            dst = self.parse_expr()
            rank = 0
            if self.accept("@"):
                rank = self.expect("INT").value
            keys = [A.EdgeKeyAst(first, dst, rank)]
            while self.accept(","):
                s = self.parse_expr()
                self.expect("->")
                d = self.parse_expr()
                r = 0
                if self.accept("@"):
                    r = self.expect("INT").value
                keys.append(A.EdgeKeyAst(s, d, r))
            return A.FetchEdgesSentence(names[0], keys, None, self.p_opt_yield())
        # vertex fetch
        self.i = save
        vids = self.p_vid_list()
        return A.FetchVerticesSentence(names, vids, self.p_opt_yield())

    def p_lookup(self) -> A.LookupSentence:
        self.expect_kw("LOOKUP")
        self.expect_kw("ON")
        name = self.ident()
        where = self.p_opt_where()
        return A.LookupSentence(name, where, self.p_opt_yield())

    # ---- CALL algo.* (the graph-analytics plane) -------------
    def p_call_algo(self) -> A.CallAlgoSentence:
        """CALL algo.<func>(name=value, ...) [YIELD col [AS a], ...].

        Parameters are NAMED (never positional) and their values are
        constant expressions — `CALL algo.sssp(src=42, weight="w")`.
        The yield columns are the algorithm's output column names."""
        self.expect_kw("CALL")
        module = self.ident()
        self.expect(".")
        func = self.ident()
        self.expect("(")
        params: Dict[str, Any] = {}
        if not self.at(")"):
            while True:
                t = self.peek()
                name = self.ident()
                if name in params:
                    raise ParseError(
                        f"duplicate parameter `{name}' at pos {t.pos}")
                self.expect("=")
                params[name] = self.parse_expr()
                if not self.accept(","):
                    break
        self.expect(")")
        return A.CallAlgoSentence(module, func, params,
                                  self.p_opt_yield())

    # ---- FIND PATH / SUBGRAPH ----
    def p_find_path(self) -> A.FindPathSentence:
        self.expect_kw("FIND")
        kind = self.expect_kw("SHORTEST", "ALL", "NOLOOP").value.lower()
        self.expect_kw("PATH")
        with_prop = False
        if self.accept_kw("WITH"):
            self.expect_kw("PROP")
            with_prop = True
        from_ = self.p_from()
        self.expect_kw("TO")
        to = self.p_vid_list()
        over = self.p_over()
        where = self.p_opt_where()
        upto = 5
        if self.accept_kw("UPTO"):
            upto = self.expect("INT").value
            self.expect_kw("STEPS", "STEP")
        yld = self.p_opt_yield()
        return A.FindPathSentence(kind, from_, to, over, where, upto, with_prop, yld)

    def p_subgraph(self) -> A.SubgraphSentence:
        self.expect_kw("GET")
        self.expect_kw("SUBGRAPH")
        with_prop = False
        if self.accept_kw("WITH"):
            self.expect_kw("PROP")
            with_prop = True
        steps = 1
        if self.at("INT"):
            steps = self.next().value
            self.expect_kw("STEPS", "STEP")
        from_ = self.p_from()
        out = A.SubgraphSentence(steps, from_, with_prop=with_prop)
        while self.at_kw("IN", "OUT", "BOTH"):
            d = self.next().value
            names = []
            if self.accept("*"):
                out.all_edges = True
            else:
                names.append(self.ident())
                while self.accept(","):
                    names.append(self.ident())
            if d == "IN":
                out.in_edges = names
            elif d == "OUT":
                out.out_edges = names
            else:
                out.both_edges = names
        out.where = self.p_opt_where()
        out.yield_ = self.p_opt_yield()
        return out

    # ---- MATCH ----
    def p_match(self) -> A.MatchSentence:
        clauses: List[Any] = []
        while True:
            if self.at_kw("OPTIONAL"):
                self.next()
                self.expect_kw("MATCH")
                clauses.append(self.p_match_clause(optional=True))
            elif self.at_kw("MATCH"):
                self.next()
                clauses.append(self.p_match_clause(optional=False))
            elif self.at_kw("UNWIND"):
                self.next()
                e = self.parse_expr()
                self.expect_kw("AS")
                clauses.append(A.UnwindClauseAst(e, self.ident()))
            elif self.at_kw("WITH"):
                self.next()
                clauses.append(self.p_with_clause())
            else:
                break
        if self.accept_kw("RETURN"):
            ret = self.p_return_clause()
            return A.MatchSentence(clauses, ret)
        raise ParseError("query must end with RETURN")

    def p_match_clause(self, optional: bool) -> A.MatchClauseAst:
        pats = [self.p_path_pattern()]
        while self.accept(","):
            pats.append(self.p_path_pattern())
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()
        return A.MatchClauseAst(pats, where, optional)

    def p_path_pattern(self) -> A.PathPattern:
        alias = None
        if self.peek().kind in ("IDENT", "KEYWORD") \
                and self.peek(1).kind == "=":
            alias = self.ident()
            self.next()
        pat = A.PathPattern(alias=alias)
        pat.nodes.append(self.p_node_pattern())
        while self.at("-") or self.at("<-") or self.at("<"):
            pat.edges.append(self.p_edge_pattern())
            pat.nodes.append(self.p_node_pattern())
        return pat

    def p_node_pattern(self) -> A.NodePattern:
        self.expect("(")
        np = A.NodePattern()
        if self.at("IDENT") or (self.at("KEYWORD") and self.peek(1).kind in (":", ")", "{")):
            if not self.at(")"):
                np.alias = self.ident()
        while self.accept(":"):
            label = self.ident()
            lprops = None
            if self.at("{"):
                lprops = self.p_prop_map()
            np.labels.append((label, lprops))
        if self.at("{"):
            np.props = self.p_prop_map()
        self.expect(")")
        return np

    def p_prop_map(self) -> Dict[str, Expr]:
        self.expect("{")
        out: Dict[str, Expr] = {}
        while not self.accept("}"):
            k = self.ident()
            self.expect(":")
            out[k] = self.parse_expr()
            self.accept(",")
        return out

    def p_edge_pattern(self) -> A.EdgePattern:
        ep = A.EdgePattern()
        back = False
        if self.accept("<-"):
            back = True
        else:
            self.expect("-")
        if self.accept("["):
            if self.peek().kind in ("IDENT", "KEYWORD") \
                    and self.peek(1).kind in (":", "]", "*", "{"):
                ep.alias = self.ident()
            while self.accept(":"):
                ep.types.append(self.ident())
                while self.accept("|"):
                    self.accept(":")     # both `|t` and `|:t` spellings
                    ep.types.append(self.ident())
            if self.accept("*"):
                ep.min_hop, ep.max_hop = 1, -1
                if self.at("INT"):
                    ep.min_hop = self.next().value
                    ep.max_hop = ep.min_hop
                    if self.accept(".."):
                        ep.max_hop = self.expect("INT").value if self.at("INT") else -1
                elif self.accept(".."):
                    ep.max_hop = self.expect("INT").value if self.at("INT") else -1
            if self.at("{"):
                ep.props = self.p_prop_map()
            self.expect("]")
        if self.accept("->"):
            ep.direction = "both" if back else "out"
            if back:
                raise ParseError("<-...-> pattern not supported")
        elif self.accept("-"):
            ep.direction = "in" if back else "both"
        else:
            raise ParseError(f"bad edge pattern at pos {self.peek().pos}")
        return ep

    def p_with_clause(self) -> A.WithClauseAst:
        distinct = bool(self.accept_kw("DISTINCT"))
        cols: Optional[List[A.YieldColumn]] = None
        if not self.accept("*"):
            cols = [self.p_yield_col()]
            while self.accept(","):
                cols.append(self.p_yield_col())
        wc = A.WithClauseAst(cols, distinct)
        wc.order_by, wc.skip, wc.limit = self.p_order_skip_limit()
        if self.accept_kw("WHERE"):
            wc.where = self.parse_expr()
        return wc

    def p_return_clause(self) -> A.ReturnClauseAst:
        distinct = bool(self.accept_kw("DISTINCT"))
        cols: Optional[List[A.YieldColumn]] = None
        if self.accept("*"):
            cols = None
        else:
            cols = [self.p_yield_col()]
            while self.accept(","):
                cols.append(self.p_yield_col())
        rc = A.ReturnClauseAst(cols, distinct)
        rc.order_by, rc.skip, rc.limit = self.p_order_skip_limit()
        return rc

    def p_order_skip_limit(self):
        order: List[A.OrderFactor] = []
        skip, limit = 0, -1
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order.append(self.p_order_factor())
            while self.accept(","):
                order.append(self.p_order_factor())
        if self.accept_kw("SKIP"):
            skip = self.expect("INT").value
        if self.accept_kw("LIMIT"):
            limit = self.expect("INT").value
        return order, skip, limit

    # ======================================================================
    # Expressions (Pratt)
    # ======================================================================

    def parse_expr_br(self) -> Expr:
        """parse_expr inside a bracketed context (enables bit-or)."""
        self.bracket += 1
        try:
            return self.parse_expr()
        finally:
            self.bracket -= 1

    def parse_expr_nopipe(self) -> Expr:
        """parse_expr with the bit-or gate OFF — comprehension and
        reduce collections are followed by a STRUCTURAL `|` that the
        operator must not consume even inside parens."""
        saved, self.bracket = self.bracket, 0
        try:
            return self.parse_expr()
        finally:
            self.bracket = saved

    def parse_expr(self) -> Expr:
        return self.p_or()

    def p_or(self) -> Expr:
        left = self.p_and()
        while self.at_kw("OR", "XOR"):
            op = self.next().value
            left = Binary(op, left, self.p_and())
        return left

    def p_and(self) -> Expr:
        left = self.p_not()
        while self.at_kw("AND"):
            self.next()
            left = Binary("AND", left, self.p_not())
        return left

    def p_not(self) -> Expr:
        if self.accept_kw("NOT"):
            return Unary("NOT", self.p_not())
        if self.accept("!"):
            return Unary("NOT", self.p_not())
        return self.p_relational()

    def p_relational(self) -> Expr:
        left = self.p_bitor()
        while True:
            t = self.peek()
            if t.kind in ("==", "!=", "<=", ">=", "=~") or t.kind in ("<", ">"):
                op = self.next().kind
                left = Binary(op, left, self.p_bitor())
            elif self.at_kw("IN"):
                self.next()
                left = Binary("IN", left, self.p_bitor())
            elif self.at_kw("CONTAINS"):
                self.next()
                left = Binary("CONTAINS", left, self.p_bitor())
            elif self.at_kw("STARTS"):
                self.next()
                self.expect_kw("WITH")
                left = Binary("STARTS WITH", left, self.p_bitor())
            elif self.at_kw("ENDS"):
                self.next()
                self.expect_kw("WITH")
                left = Binary("ENDS WITH", left, self.p_bitor())
            elif self.at_kw("NOT"):
                nxt = self.peek(1)
                if nxt.kind == "KEYWORD" and nxt.value in ("IN", "CONTAINS", "STARTS", "ENDS"):
                    self.next()
                    w = self.next().value
                    if w in ("STARTS", "ENDS"):
                        self.expect_kw("WITH")
                        left = Binary(f"NOT {w} WITH", left, self.p_bitor())
                    else:
                        left = Binary(f"NOT {w}", left, self.p_bitor())
                else:
                    break
            elif self.at_kw("IS"):
                self.next()
                neg = bool(self.accept_kw("NOT"))
                which = self.expect_kw("NULL", "EMPTY").value
                op = ("IS_NOT_" if neg else "IS_") + which
                left = Unary(op, left)
            else:
                break
        return left

    def p_bitor(self) -> Expr:
        """Bitwise OR — reference/MySQL precedence (below comparisons,
        above &).  `|` doubles as the statement pipe and the pattern
        type separator, so the operator form only binds inside a
        bracketed context (parens, call args, subscripts, map values) —
        the reference disambiguates the same way in practice."""
        left = self.p_bitand()
        while self.bracket > 0 and self.at("|"):
            self.next()
            left = Binary("|", left, self.p_bitand())
        return left

    def p_bitand(self) -> Expr:
        left = self.p_additive()
        while self.at("&"):
            self.next()
            left = Binary("&", left, self.p_additive())
        return left

    def p_additive(self) -> Expr:
        left = self.p_multiplicative()
        while self.at("+") or self.at("-"):
            op = self.next().kind
            left = Binary(op, left, self.p_multiplicative())
        return left

    def p_multiplicative(self) -> Expr:
        left = self.p_xor()
        while self.at("*") or self.at("/") or self.at("%"):
            op = self.next().kind
            left = Binary(op, left, self.p_xor())
        return left

    def p_xor(self) -> Expr:
        # ^ binds tighter than * (reference/MySQL precedence)
        left = self.p_unary()
        while self.at("^"):
            self.next()
            left = Binary("^", left, self.p_unary())
        return left

    def p_unary(self) -> Expr:
        if self.at("-"):
            self.next()
            return Unary("-", self.p_unary())
        if self.at("+"):
            self.next()
            return Unary("+", self.p_unary())
        return self.p_postfix()

    def p_postfix(self) -> Expr:
        e = self.p_primary()
        while True:
            if self.at("["):
                self.next()
                if self.accept(".."):
                    hi = None if self.at("]") else self.parse_expr_br()
                    self.expect("]")
                    e = Slice(e, None, hi)
                    continue
                idx = self.parse_expr_br()
                if self.accept(".."):
                    hi = None if self.at("]") else self.parse_expr_br()
                    self.expect("]")
                    e = Slice(e, idx, hi)
                else:
                    self.expect("]")
                    e = Subscript(e, idx)
            elif self.at(".") and self.peek(1).kind in ("IDENT", "KEYWORD"):
                self.next()
                e = AttributeExpr(e, self.ident())
            else:
                break
        return e

    def p_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "INT" or t.kind == "FLOAT":
            self.next()
            return Literal(t.value)
        if t.kind == "STRING":
            self.next()
            return Literal(t.value)
        if t.kind == "KEYWORD":
            if t.value == "TRUE":
                self.next()
                return Literal(True)
            if t.value == "FALSE":
                self.next()
                return Literal(False)
            if t.value == "NULL":
                self.next()
                return Literal(NULL)
            if t.value == "CASE":
                return self.p_case()
            if t.value in ("VERTEX", "EDGE") and self.peek(1).kind != "(":
                self.next()
                return VertexExpr("vertex") if t.value == "VERTEX" else EdgeExpr()
            # keyword used as function name or bare identifier — keep the
            # source spelling (a tag named `User`, prop named `role`)
            if self.peek(1).kind == "(":
                return self.p_call(self.next().value.lower())
            self.next()
            return LabelExpr(t.raw or t.value.lower())
        if t.kind == "$-":
            self.next()
            self.expect(".")
            return InputProp(self.ident())
        if t.kind == "$^":
            self.next()
            if self.accept("."):
                tag = self.ident()
                self.expect(".")
                return SrcProp(tag, self.ident())
            return VertexExpr("$^")
        if t.kind == "$$":
            self.next()
            if self.accept("."):
                tag = self.ident()
                self.expect(".")
                return DstProp(tag, self.ident())
            return VertexExpr("$$")
        if t.kind == "VAR":
            self.next()
            if self.at(".") and self.peek(1).kind in ("IDENT", "KEYWORD"):
                self.next()
                return VarProp(t.value, self.ident())
            return VarExpr(t.value)
        if t.kind == "IDENT":
            name = self.next().value
            if self.at("("):
                return self.p_call(name)
            return LabelExpr(name)
        if t.kind == "(":
            # `(a)-[:knows]->(b)` in expression position is a boolean
            # pattern predicate (NebulaGraph: MatchValidator's
            # PatternExpression).
            # Speculative: a parenthesized arithmetic operand like
            # `(a) - [1,2][0]` fails the pattern parse at its first
            # non-pattern token and falls back to the expression read.
            pe = self.try_pattern_pred()
            if pe is not None:
                return pe
            self.next()
            e = self.parse_expr_br()
            self.expect(")")
            return e
        if t.kind == "[":
            return self.p_list_or_comprehension()
        if t.kind == "{":
            self.next()
            items: List[Tuple[str, Expr]] = []
            while not self.accept("}"):
                k = self.ident() if not self.at("STRING") else self.next().value
                self.expect(":")
                items.append((k, self.parse_expr_br()))
                self.accept(",")
            return MapExpr(items)
        if t.kind == "*":
            # COUNT(*) handled in p_call; bare * invalid here
            raise ParseError(f"unexpected `*' at pos {t.pos}")
        raise ParseError(f"unexpected {t.kind}({t.value!r}) at pos {t.pos}")

    def try_pattern_pred(self) -> Optional[Expr]:
        """Attempt `(node)(edge node)+` at the cursor; backtrack and
        return None if it is not a pattern.  A bare `(a)` stays a
        parenthesized expression — a pattern predicate needs >=1 edge."""
        save = self.i
        try:
            pat = A.PathPattern(alias=None)
            pat.nodes.append(self.p_node_pattern())
            if not (self.at("-") or self.at("<-") or self.at("<")):
                raise ParseError("not a pattern")
            while self.at("-") or self.at("<-") or self.at("<"):
                pat.edges.append(self.p_edge_pattern())
                pat.nodes.append(self.p_node_pattern())
        except ParseError:
            self.i = save
            return None
        return PatternPredExpr(pat, A.pattern_text(pat))

    def p_call(self, name: str) -> Expr:
        lname = name.lower()
        self.expect("(")
        if lname in AGG_NAMES:
            if self.accept("*"):
                self.expect(")")
                return AggExpr(lname, None)
            distinct = bool(self.accept_kw("DISTINCT"))
            if self.at(")") and lname == "count":
                self.next()
                return AggExpr("count", None)
            arg = self.parse_expr()
            self.expect(")")
            return AggExpr(lname, arg, distinct)
        if lname in ("all", "any", "single", "none"):
            var = self.ident()
            self.expect_kw("IN")
            coll = self.parse_expr()
            self.expect_kw("WHERE")
            pred = self.parse_expr()
            self.expect(")")
            return PredicateExpr(lname, var, coll, pred)
        if lname == "reduce":
            acc = self.ident()
            self.expect("=")
            init = self.parse_expr()
            self.expect(",")
            var = self.ident()
            self.expect_kw("IN")
            coll = self.parse_expr_nopipe()
            self.expect("|")
            mapping = self.parse_expr()
            self.expect(")")
            return Reduce(acc, init, var, coll, mapping)
        if lname == "exists":
            arg = self.parse_expr()
            self.expect(")")
            if isinstance(arg, PatternPredExpr):
                return arg               # exists((a)-->(b)) ≡ (a)-->(b)
            return FunctionCall("_exists", [arg])
        args: List[Expr] = []
        while not self.accept(")"):
            args.append(self.parse_expr_br())
            self.accept(",")
        return FunctionCall(lname, args)

    def p_case(self) -> Expr:
        self.expect_kw("CASE")
        condition = None
        if not self.at_kw("WHEN"):
            condition = self.parse_expr()
        whens: List[Tuple[Expr, Expr]] = []
        while self.accept_kw("WHEN"):
            w = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((w, self.parse_expr()))
        default = None
        if self.accept_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        return Case(whens, default, condition)

    def p_list_or_comprehension(self) -> Expr:
        self.expect("[")
        if self.accept("]"):
            return ListExpr([])
        # lookahead: IDENT IN → comprehension (the variable may be an
        # unreserved keyword like `user`)
        if (self.peek().kind in ("IDENT", "KEYWORD")
                and self.peek().value not in ("TRUE", "FALSE", "NULL", "CASE")
                and self.peek(1).kind == "KEYWORD"
                and self.peek(1).value == "IN"):
            var = self.ident()
            self.next()  # IN
            coll = self.parse_expr_nopipe()
            where = None
            mapping = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr_nopipe()
            if self.accept("|"):
                mapping = self.parse_expr()
            self.expect("]")
            return ListComprehension(var, coll, where, mapping)
        items = [self.parse_expr()]
        while self.accept(","):
            items.append(self.parse_expr())
        self.expect("]")
        return ListExpr(items)
