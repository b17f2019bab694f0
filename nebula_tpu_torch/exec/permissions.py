"""The port's copy of `nebula_tpu/exec/permissions.py`, whole.

PermissionManager: role-gated statement admission.

The reference checks every sentence against the session's role before
validation (PermissionManager::canReadSpace/canWriteSchema/...;
reference: src/graph/service/PermissionManager.cpp).  Same lattice here:

    GOD > ADMIN > DBA > USER > GUEST

GOD is global (the root account); the others are per-space grants.
Checks run only when the `enable_authorize` flag is on, so open
deployments (the default, matching the reference's shipped config)
pay nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..graphstore.schema import ROLE_RANK
from ..query import ast as A

# (level, scope): scope "global" ignores the space; "space" checks the
# session's (or statement's) target space; "self_or_god" is CHANGE
# PASSWORD's own-account carve-out.
_GLOBAL_GOD = (
    A.CreateSpaceSentence, A.CreateSpaceAsSentence, A.DropSpaceSentence, A.CreateUserSentence,
    A.DropUserSentence, A.AlterUserSentence, A.CreateSnapshotSentence,
    A.DropSnapshotSentence, A.CreateBackupSentence, A.DropBackupSentence,
    A.RestoreBackupSentence, A.UpdateConfigsSentence,
    A.AddHostsSentence, A.DropZoneSentence,
    A.DropHostsSentence, A.MergeZoneSentence, A.RenameZoneSentence,
    A.DivideZoneSentence,
    A.ClearSpaceSentence, A.KillSessionSentence, A.StopJobSentence,
    A.RecoverJobSentence, A.SignInTextServiceSentence,
    A.SignOutTextServiceSentence, A.DescribeUserSentence,
    A.AlterSpaceSentence, A.DownloadSentence, A.IngestSentence)
_SPACE_ADMIN = (A.GrantRoleSentence, A.RevokeRoleSentence)
_SPACE_DBA = (
    A.CreateSchemaSentence, A.AlterSchemaSentence, A.DropSchemaSentence,
    A.CreateIndexSentence, A.DropIndexSentence, A.RebuildIndexSentence,
    A.CreateFulltextIndexSentence, A.DropFulltextIndexSentence,
    A.RebuildFulltextIndexSentence, A.AddListenerSentence,
    A.RemoveListenerSentence, A.SubmitJobSentence)
_SPACE_WRITE = (
    A.InsertVerticesSentence, A.InsertEdgesSentence,
    A.DeleteVerticesSentence, A.DeleteEdgesSentence, A.DeleteTagsSentence,
    A.UpdateSentence)


def required(stmt: A.Sentence) -> Tuple[str, str]:
    """-> (min_role, scope) for one sentence."""
    if isinstance(stmt, _GLOBAL_GOD):
        return "GOD", "global"
    if isinstance(stmt, A.KillQuerySentence):
        # killing queries crosses sessions; only GOD may (ownership
        # carve-outs would need the target session's user at admission
        # time, which the reference also resolves GOD-first)
        return "GOD", "global"
    if isinstance(stmt, A.ShowSentence) and stmt.kind == "users":
        return "GOD", "global"
    if isinstance(stmt, A.ShowSentence) and stmt.kind == "roles":
        return "ADMIN", "stmt_space"       # target space is stmt.extra
    if isinstance(stmt, A.ChangePasswordSentence):
        return "GUEST", "self_or_god"
    if isinstance(stmt, _SPACE_ADMIN):
        return "ADMIN", "stmt_space"
    if isinstance(stmt, _SPACE_DBA):
        return "DBA", "space"
    if isinstance(stmt, _SPACE_WRITE):
        return "USER", "space"
    # reads, USE, SHOW, YIELD, EXPLAIN-wrapped handled by caller
    return "GUEST", "space"


def check(stmt: A.Sentence, user: str, catalog,
          current_space: Optional[str]) -> Optional[str]:
    """None if allowed, else a denial message.  Recurses through the
    composition sentences so every leaf is vetted."""
    if isinstance(stmt, A.SeqSentence):
        for sub in stmt.stmts:
            msg = check(sub, user, catalog, current_space)
            if msg:
                return msg
        return None
    if isinstance(stmt, (A.PipedSentence, A.SetOpSentence)):
        return (check(stmt.left, user, catalog, current_space)
                or check(stmt.right, user, catalog, current_space))
    if isinstance(stmt, A.ExplainSentence):
        return check(stmt.stmt, user, catalog, current_space)
    if isinstance(stmt, A.AssignSentence):
        return check(stmt.stmt, user, catalog, current_space)

    role = catalog.role_of(user, None)          # GOD short-circuit
    if role == "GOD":
        return None

    level, scope = required(stmt)
    if scope == "global":
        return f"`{user}' needs the GOD role for this statement"
    if scope == "self_or_god":
        if stmt.name == user:
            return None
        return f"only GOD may change another account's password"

    space = current_space
    if scope == "stmt_space":
        space = stmt.extra if isinstance(stmt, A.ShowSentence) else stmt.space
    if isinstance(stmt, A.UseSentence):
        space = stmt.space
    if space is None:
        # space-scoped statement with no space chosen: let the engine
        # produce its usual "no space selected" semantic error
        return None
    have = catalog.role_of(user, space)
    if have is None:
        return (f"`{user}' has no role on space `{space}' "
                f"(statement needs {level})")
    if ROLE_RANK[have] < ROLE_RANK[level]:
        return (f"`{user}' holds {have} on `{space}' but the statement "
                f"needs {level}")
    return None
