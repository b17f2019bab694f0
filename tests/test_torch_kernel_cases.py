"""`mark` and `pagerank_step` on their edge cases, in their plain
versions, against the reference's device functions run in JAX on the CPU;
and the wrappers' host-side sizing of the two CUDA kernels.

`mark_plain` ↔ hop._mark (nebula_tpu/tpu/hop.py:168), lane by lane, with
the bitmap's prior contents as its accumulator; `pagerank_step_plain` ↔
the reference's jitted `pagerank_step` (nebula_tpu/algo/kernels.py:49),
on bench/kernel_cases.py's small set: no ids, no id kept, ids out of
range, one id repeated, counts and lanes off a 16-byte boundary, an odd
row stride, a bitmap holding ones, part counts that are not a power of
two, a bitmap too wide to stage; no edges, one vertex, one vertex holding
every edge, edgeless rows across a block's edge, segments ending on a
block's edge, every vertex dangling, vmask holes.  chip_smoke.py holds
the CUDA kernels against the plain versions on the same cases at card
sizes.  Tolerances: mark exact (boolean scatter); a PageRank step within
1e-12 (the port sums each segment directly, the reference differences
one cumsum), its moved count equal wherever rounding cannot move a
vertex across tol.

`predicate_mask_plain` ↔ the reference's `compile_predicate`
(nebula_tpu/tpu/exprjit.py:201) over the columns gathered at eidx (its
delta half past emax), as tests/test_torch_predicate.py's `_ref_mask`
holds it, on the cases of `predicate_cases`: widths 1, 3, 4, 5 and past
a tile, total 0 and total = EB, masks with holes, delta halves, lanes,
every opcode family, 64 instructions, 8 registers, 128 constants, an
always-false program.  `merge_delta_plain` ↔ hop._merge_delta
(nebula_tpu/tpu/hop.py:118) per part, as tests/test_torch_delta.py holds
it, on `merge_delta_cases`: Tcap 0, Dcap 0, MAXI rows, tombstones on a
tile's edges and past its staged slice, eidx in no order, lanes, a shard
slot, a strided frontier.  Both exact.

`wcc_step_plain` and `sssp_step_plain` (unweighted and weighted), and
the wrappers' CPU branch with each route forced, ↔ the reference's jitted
`wcc_step` / `sssp_step` (nebula_tpu/algo/kernels.py:79/95) on
`relax_cases`, fed destination-sorted edges as the reference declares
them: no edges, one vertex, n off a 32-bit word, every source off or on,
one destination holding every edge, runs of one destination ending on a
lane's, a warp's and a block's edge, sentinels in the mask, weights 0.0
and 0.5.  Exact, bit for bit.  Then the host-side sizing of the two
routes (`relax_stage_bytes`, `relax_route`) and the launch count a route.

`bfs_probe_plain` (reading the frontier from its bitmap, and from its
words) and the wrapper's CPU branch with each route forced ↔ the
reference's membership and `_mark` expression
(nebula_tpu/algo/frontier.py:136-141); `bfs_level_plain` and the
wrapper's CPU branch ↔ the reference's level update and the switch's
two counts (nebula_tpu/tpu/bfs.py:153-159, 170-172), its frontier words
↔ hop._pack_bits (nebula_tpu/tpu/hop.py:179), uint32 viewed as int32;
on `bfs_cases`: P = 1 and 8, vmax off a 32-bit word, strided views, EB
off 4, totals 0 and EB, every neighbour on the frontier and none, ids
out of range, keep all False and None, hub rows; a level with no fresh
vertex, phantom slots, counts as a row of a larger buffer.  Exact.  Then
the probe's route sizing (`probe_stage_bytes`, `probe_route`).

The mesh's exchange kernels on `exchange_cases`, one slot and slot
groups: `pack_bits_plain` ↔ hop._pack_bits (nebula_tpu/tpu/hop.py:179)
on every (P, vmax) matrix, `unpack_or_plain` ↔ hop._unpack_or (:195) on
every (slot, lane)'s received rows, the bytes around the written view
untouched; `owned_hub_bits_plain` ↔ the owned-bits expression of
hop._extend_fbm_sharded_lanes (:292) summed over the group's slots, and
`fill_hub_columns_plain` ↔ its `> 0` and concatenation; the wrappers'
CPU branch the same; vmax off a 32-bit word, row strides and bases off
16 bytes, the transports' strided views, groups whose first part is not
0.  Exact.  Then the group forms' input checks off the CPU.

`expand`'s owner route (the wrapper's CPU branch, `expand_plain` with
hub_owner / hub_local) ↔ hop._expand_block over hop._extend_fbm_local
(nebula_tpu/tpu/hop.py:58, :303) lane by lane, on `expand_owner_cases`:
hubs owned by the first, a middle and the last part, an inactive hub,
tail columns zero or junk, 1, 2 and 8 lanes, H = 1, 73 and 300.  Exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.algo import kernels as ref_kernels
from nebula_tpu.core import expr as RE
from nebula_tpu.core.value import NULL as REF_NULL
from nebula_tpu.graphstore.csr import StringPool as RefPool
from nebula_tpu.graphstore.schema import PropType as RefPropType
from nebula_tpu.tpu import exprjit as ref_jit
from nebula_tpu.tpu import hop as ref_hop

from nebula_tpu_torch.algo import kernels as AK
from nebula_tpu_torch.bench.kernel_cases import (
    PREDICATE_BUILDERS, PREDICATE_NAMES, PREDICATE_TYPES, bfs_cases,
    copy_view, exchange_cases, expand_owner_cases, fresh_bfs_args,
    fresh_merge_args, mark_cases, merge_delta_cases, pagerank_cases,
    predicate_cases, predicate_program, relax_cases)
from nebula_tpu_torch.gpu import exprjit as X
from nebula_tpu_torch.gpu import kernels as K

MARK = mark_cases("cpu")
PAGERANK = pagerank_cases("cpu")
PREDICATE = predicate_cases("cpu")
MERGE = merge_delta_cases("cpu")
RELAX = relax_cases("cpu")
BFS = bfs_cases("cpu")
EXCHANGE = exchange_cases("cpu")
OWNERS = expand_owner_cases("cpu")
STEP_TOL = 1e-12


@pytest.mark.parametrize("case", MARK, ids=[c[0] for c in MARK])
def test_mark_edge_case_matches_reference(case):
    _, (ids, P, vmax), kw = case
    keep, out = kw.get("keep"), copy_view(kw["out"])
    before = out._base.clone()
    got = K.mark(ids, P, vmax, keep=keep, out=out)
    assert got is out
    lanes = out.dim() == 3
    d = ids.reshape(out.shape[0] if lanes else 1, -1).numpy()
    k = np.ones(d.shape, bool) if keep is None else \
        keep.reshape(d.shape).numpy()
    prior = kw["out"].numpy().reshape((-1, P, vmax))
    for q in range(d.shape[0]):
        # the port drops ids < 0, which the reference's scatter would
        # wrap: its callers keep only valid slots
        want = ref_hop._mark(jnp.asarray(d[q]),
                             jnp.asarray(k[q] & (d[q] >= 0)), P, vmax,
                             acc=jnp.asarray(prior[q]))
        np.testing.assert_array_equal(
            out.numpy().reshape((-1, P, vmax))[q], np.asarray(want))
    # nothing outside the view is written (a split layout's hub columns)
    mask = torch.ones_like(before)
    mask.as_strided(out.shape, out.stride(), out.storage_offset()).fill_(0)
    assert torch.equal(out._base[mask], before[mask])


@pytest.mark.parametrize("case", PAGERANK, ids=[c[0] for c in PAGERANK])
def test_pagerank_edge_case_matches_reference(case):
    _, args, _ = case
    rank, esrc, starts, out_inv, dmask, vmask, nv, damping, tol = args
    new, delta, active = AK.pagerank_step(*args)
    r = rank.numpy()
    if esrc.numel() == 0:
        # the reference's jitted step cannot gather from an empty cumsum
        base = (1.0 - damping + damping * r[dmask.numpy()].sum()) / nv
        want = [np.where(vmask.numpy(), base, 0.0)]
        want += [np.abs(want[0] - r).sum()]
    else:
        ref = ref_kernels.pagerank_step(r.size, damping, tol)(
            *(jnp.asarray(a.numpy()) for a in args[:6]), nv)
        want = [np.asarray(ref[0]), float(ref[1])]
    np.testing.assert_allclose(new.numpy(), want[0], rtol=0, atol=STEP_TOL)
    assert abs(float(delta) - want[1]) <= STEP_TOL
    moved = np.abs(want[0] - r)
    near = np.abs(moved - tol) <= STEP_TOL
    assert int(active) == int((np.abs(new.numpy() - r) > tol).sum())
    assert abs(int(active) - int((moved > tol).sum())) <= int(near.sum())


@pytest.mark.parametrize("P, vmax, nbytes", [
    (8, 125_000, 125_024), (1, 1, 16), (3, 33, 32), (8, 232_448, 232_448),
    (8, 232_449, 232_480), (7, 3001, 2640)])
def test_mark_stage_bytes(P, vmax, nbytes):
    """P rows of ceil(vmax / 32) words, rounded up to 16 bytes."""
    assert K.mark_stage_bytes(P, vmax) == nbytes


@pytest.mark.parametrize("per_lane, P, vmax, path", [
    (12_449_964, 8, 125_000, "staged"),          # GO hop 2
    (1_559_801, 8, 125_000, "staged"),           # a mesh slot's hop 2
    (16, 8, 125_000, "direct"),                  # the seed ids (K6)
    (K.MARK_STAGE_MIN_IDS - 1, 8, 125_000, "direct"),
    (K.MARK_STAGE_MIN_IDS, 8, 125_000, "staged"),
    (10_000_000, 8, 232_448, "staged"),          # the widest staged bitmap
    (10_000_000, 8, 232_449, "direct"),          # too wide to stage
    (10_000_000, 1, 1_859_584, "staged"),
    (10_000_000, 1, 1_859_585, "direct")])
def test_mark_path(per_lane, P, vmax, path):
    assert K.mark_path(per_lane, P, vmax) == path


def test_mark_path_argument_checked():
    ids = torch.tensor([1, 2], dtype=torch.int32)
    for path in K.MARK_PATHS:
        assert K.mark(ids, 8, 4, path=path).sum() == 2
    with pytest.raises(ValueError, match="path"):
        K.mark(ids, 8, 4, path="scatter")


@pytest.mark.parametrize("n, E, blocks", [
    (0, 0, (0, 0)), (1, 0, (1, 1)), (1, 2559, (1, 1)), (1, 2560, (2, 1)),
    (1024, 0, (1, 1)), (1025, 0, (1, 2)),
    (1_000_000, 29_955_347, (12_092, 977))])
def test_pagerank_blocks(n, E, blocks):
    """The merged list of n row ends and E edges in PAGERANK_BLOCK items a
    sums block; n vertices in PAGERANK_VBLOCK an apply block."""
    assert AK.pagerank_blocks(n, E) == blocks
    f, i = AK.pagerank_scratch(n, E, "cpu")
    nb, nvb = blocks
    assert f.shape == (2 * nb + nvb + 2,) and f.dtype == torch.float64
    assert i.shape == (nb + nvb + 2,) and i.dtype == torch.int64


def test_copy_view_keeps_layout():
    buf = torch.zeros((3, 8, 107), dtype=torch.bool)
    v = buf[..., :100]
    c = copy_view(v)
    assert c.stride() == v.stride() and c.shape == v.shape
    c[1, 2, 3] = True
    assert not buf.any() and c._base.sum() == 1


# ---------------------------------------------------------------------------
# predicate_mask (K4)
# ---------------------------------------------------------------------------


def _ref_keep(key, prog, src, dst, rank, eidx, valid, cols, dcols=None):
    """The reference's mask of PREDICATE_BUILDERS[key] over the columns
    gathered at each slot's eidx (row q reads part q % P; the delta half
    at eidx - emax), ANDed with the valid prefix or mask."""
    P, EB = src.shape[-2], src.shape[-1]
    R = int(np.prod(src.shape[:-1]))
    pool = RefPool()
    for s in PREDICATE_NAMES:
        pool.encode(s)
    ref_fn, _ = ref_jit.compile_predicate(
        PREDICATE_BUILDERS[key](RE, REF_NULL),
        {n: RefPropType[t] for n, t in PREDICATE_TYPES.items()}, pool,
        vid_to_dense=lambda v: v if isinstance(v, int) and 0 <= v < 20
        else -1)
    e = eidx.reshape(R, EB).numpy().astype(np.int64)
    p = (np.arange(R) % P)[:, None]
    c = {"_rank": jnp.asarray(rank.reshape(R, EB).numpy()),
         "_src": jnp.asarray(src.reshape(R, EB).numpy()),
         "_dst": jnp.asarray(dst.reshape(R, EB).numpy())}
    for i, name in enumerate(prog.columns):
        col = cols[i].numpy()
        emax = col.shape[1]
        g = col[p, np.clip(e, 0, emax - 1)]
        if dcols is not None:
            d = dcols[i].numpy()
            g = np.where(e >= emax, d[p, np.clip(e - emax, 0,
                                                  d.shape[1] - 1)], g)
        c[name] = jnp.asarray(g)
    if valid.dtype == torch.bool:
        v = valid.reshape(R, EB).numpy()
    else:
        v = np.arange(EB)[None, :] < valid.reshape(R, 1).numpy()
    return (v & np.broadcast_to(np.asarray(ref_fn(c)), v.shape)).reshape(
        src.shape)


@pytest.mark.parametrize("case", PREDICATE, ids=[c[0] for c in PREDICATE])
def test_predicate_edge_case_matches_reference(case):
    name, args, kw = case
    key = name.split(" :: ")[0]
    got = K.predicate_mask(*args, **kw)
    assert got.dtype == torch.bool and got.shape == args[1].shape
    want = _ref_keep(key, *args, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's other route is the same plain version on the CPU
    np.testing.assert_array_equal(
        K.predicate_mask(*args, **kw, path="interpreter").numpy(), want)
    if "always false" in key:
        assert not want.any()


def test_predicate_cases_reach_every_opcode_and_limit():
    progs = {c[0].split(" :: ")[0]: c[1][0] for c in PREDICATE}
    used = {insn[0] for p in progs.values() for insn in p.code}
    assert used == set(range(X.OP_IN + 1))
    assert max(len(p.code) for p in progs.values()) == X.MAX_INSNS
    assert max(p.n_regs for p in progs.values()) == X.MAX_REGS
    assert max(len(p.consts) for p in progs.values()) == X.MAX_CONSTS
    assert any(p.always_false for p in progs.values())


@pytest.mark.parametrize("key, path", [
    ("w > 50", "compare"), ("f < 0.5", "compare"),
    ("tag == ann", "compare"), ("w <= 3", "compare"),
    ("f >= 0.25", "compare"), ("b", "interpreter"),
    ("w IN [128 constants]", "interpreter"),
    ("w + 1: not a bool, always false", "interpreter"),
    ("w >= f * 100 OR f + 0.25 <= 0.75", "interpreter")])
def test_predicate_path(key, path):
    """Only `LOAD col; CONST; CMP` of an int or float column goes to the
    compiled-in comparisons."""
    assert K.predicate_path(predicate_program(key)) == path


def test_predicate_path_argument_checked():
    name, args, kw = PREDICATE[0]
    assert K.predicate_path(args[0]) == "compare"
    for path in K.PREDICATE_PATHS:
        assert torch.equal(K.predicate_mask(*args, path=path),
                           K.predicate_mask(*args))
    with pytest.raises(ValueError, match="path"):
        K.predicate_mask(*args, path="jit")
    other = predicate_program("b")
    with pytest.raises(ValueError, match="one-comparison"):
        K.predicate_mask(other, *args[1:], path="compare")


# ---------------------------------------------------------------------------
# merge_delta (K9)
# ---------------------------------------------------------------------------


def _ref_merge_rows(args, parts, pid):
    """hop._merge_delta per part (vmapped over the P rows of each lane),
    with the reference's base-width slots; returns (src, dst, rk, eidx,
    ve, total) of shape (R, EB + Dcap), (R,)."""
    (src, dst, rk, eidx, total, fbm, d_src, d_dst, d_rank, d_valid, d_tomb,
     emax) = args
    P, W = src.shape[-2], src.shape[-1]
    Dcap = d_src.shape[1]
    EB = W - Dcap
    L = src.numel() // max(P * W, 1) if W else 1
    fn = jax.jit(jax.vmap(
        lambda dl, f, a, b, c, e, v, t, q: ref_hop._merge_delta(
            dl, f, a, b, c, e, v, t, parts, q, emax)))
    dl = {"d_src": d_src.numpy(), "d_dst": d_dst.numpy(),
          "d_rank": d_rank.numpy(), "d_valid": d_valid.numpy(),
          "d_tomb": d_tomb.numpy()}
    outs = []
    for lane in range(L):
        s = [t.reshape(L, P, W)[lane, :, :EB].numpy()
             for t in (src, dst, rk, eidx)]
        tot = total.reshape(L, P)[lane].numpy()
        ve = np.arange(EB)[None, :] < tot[:, None]
        f = fbm.reshape(L, P, -1)[lane].numpy()
        outs.append([np.asarray(x) for x in fn(
            {k: jnp.asarray(v) for k, v in dl.items()}, jnp.asarray(f),
            *[jnp.asarray(a) for a in s], jnp.asarray(ve),
            jnp.asarray(tot), jnp.arange(pid, pid + P, dtype=jnp.int32))])
    return [np.concatenate([o[i] for o in outs]) for i in range(6)], EB


@pytest.mark.parametrize("case", MERGE, ids=[c[0] for c in MERGE])
def test_merge_delta_edge_case_matches_reference(case):
    name, args, kw = case
    P = args[0].shape[-2]
    parts, pid = kw.get("parts", P), kw.get("pid", 0)
    a = fresh_merge_args(args)
    valid, tot = K.merge_delta(*a, **kw)
    (r_src, r_dst, r_rk, r_eidx, r_ve, r_tot), EB = _ref_merge_rows(
        args, parts, pid)
    R = r_ve.shape[0]
    got = [t.reshape(R, -1).numpy() for t in (a[0], a[2], a[3], valid)]
    for g, w in zip(got, (r_src, r_rk, r_eidx, r_ve)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tot.reshape(R).numpy(), r_tot)
    # a tombstoned base slot's dst is -1 (the pinned difference)
    base_valid = np.arange(EB)[None, :] < args[4].reshape(R, 1).numpy()
    hit = np.zeros_like(r_ve)
    hit[:, :EB] = base_valid & ~r_ve[:, :EB]
    np.testing.assert_array_equal(a[1].reshape(R, -1).numpy(),
                                  np.where(hit, -1, r_dst))
    if "MAXI" in name or "Tcap 0" in name:
        assert not hit.any()
    if "edges" in name or "staged" in name or name.startswith("EB 4,099"):
        assert hit.any()


# ---------------------------------------------------------------------------
# wcc_step (K13) and sssp_step (K14)
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("case", RELAX, ids=[c[0] for c in RELAX])
def test_relax_edge_case_matches_reference(case):
    """The plain step, and the wrapper's CPU branch with and without a
    route forced, against the reference's jitted step, bit for bit."""
    name, kname, args = case
    n = args[0].shape[0]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    if kname == "wcc_step":
        want = ref_kernels.wcc_step(n)(*jargs)
    else:
        want = ref_kernels.sssp_step(n, len(args) == 5)(*jargs)
    fn = getattr(AK, kname)
    outs = [getattr(AK, kname + "_plain")(*args), fn(*args)]
    outs += [fn(*args, route=r) for r in AK.RELAX_ROUTES]
    for new, changed, count in outs:
        assert new.dtype == args[0].dtype and count.dtype == torch.int64
        np.testing.assert_array_equal(_bits(new.numpy()), _bits(want[0]))
        np.testing.assert_array_equal(changed.numpy(), np.asarray(want[1]))
        assert int(count) == int(want[2])
    if "masked off" in name:
        assert int(want[2]) == 0


def test_relax_cases_cover_each_kernel():
    kinds = {(k, len(a)) for _, k, a in RELAX}
    assert kinds == {("wcc_step", 4), ("sssp_step", 4), ("sssp_step", 5)}
    assert any(a[2].numel() == 0 for _, _, a in RELAX)
    assert any(a[0].shape[0] % 32 for _, _, a in RELAX)


@pytest.mark.parametrize("n, nbytes", [
    (0, 0), (1, 16), (32, 16), (128, 16), (129, 32), (1001, 128),
    (1_000_000, 125_008), (1_859_584, 232_448), (1_859_585, 232_464)])
def test_relax_stage_bytes(n, nbytes):
    """ceil(n / 32) 32-bit words, rounded up to 16 bytes."""
    assert AK.relax_stage_bytes(n) == nbytes


@pytest.mark.parametrize("n, smem, route", [
    (1_000_000, 232_448, "staged"),          # the north star's WCC, SSSP
    (300_000, 232_448, "staged"),            # bench.py's algo size
    (1_859_584, 232_448, "staged"),          # the widest staged frontier
    (1_859_585, 232_448, "global"),          # one vertex past it
    (2_000_000, 232_448, "global"),
    (0, 232_448, "staged"), (1, 16, "staged"), (1, 15, "global"),
    (1_000_000, 125_008, "staged"), (1_000_000, 125_007, "global")])
def test_relax_route(n, smem, route):
    assert AK.relax_route(n, smem) == route


def test_relax_route_default_is_a_blocks_shared_memory():
    assert AK.RELAX_SMEM_BYTES == 232_448
    assert AK.relax_route(1_859_584) == "staged"
    assert AK.relax_route(1_859_585) == "global"


def test_relax_route_argument_checked():
    _, _, args = RELAX[3]
    for fn in (AK.wcc_step, AK.sssp_step):
        a = args if fn is AK.wcc_step else (args[0].double(), *args[1:])
        for route in AK.RELAX_ROUTES:
            got = fn(*a, route=route)
            want = fn(*a)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        with pytest.raises(ValueError, match="route"):
            fn(*a, route="bits")


def test_route_launch_counts():
    """A two-route wrapper counts each launch once in its total and once
    in its route's count; a reset clears both."""
    K.reset_launch_counts()
    K._count(AK.wcc_step, "global")
    K._count(AK.sssp_step, "staged")
    K._count(AK.sssp_step, "staged")
    K._count(K.bfs_probe, "global")
    K._count(K.expand, "hub owners")
    assert K.route_launch_counts() == {
        "expand (hub owners)": 1,
        "bfs_probe (staged)": 0, "bfs_probe (global)": 1,
        "wcc_step (staged)": 0, "wcc_step (global)": 1,
        "sssp_step (staged)": 2, "sssp_step (global)": 0}
    assert K.launch_counts()["bfs_probe"] == 1
    assert K.launch_counts()["expand"] == 1
    assert K.launch_counts()["wcc_step"] == 1
    assert K.launch_counts()["sssp_step"] == 2
    K.reset_launch_counts()
    assert set(K.route_launch_counts().values()) == {0}
    assert K.launch_counts()["sssp_step"] == 0


# ---------------------------------------------------------------------------
# expand's owner route (K8 folded into K1's scan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", OWNERS, ids=[c[0] for c in OWNERS])
def test_expand_owner_case_matches_reference(case):
    """Each lane row's slots, padding included, equal the reference's
    `_expand_block` over `_extend_fbm_local` of that lane's ownership
    bitmap (tpu/hop.py:518): the hub bits from the owners' rows of the
    same lane, the tail columns never read; and equal the tail route
    over the buffer `extend_hubs_plain` fills."""
    _, args, kw = case
    indptr, nbr, rank, fbm, hub_dense, extra, _, _ = args
    own, loc = kw["hub_owner"], kw["hub_local"]
    got = K.expand(*args, **kw)
    P, nrows, H = indptr.shape[0], fbm.shape[-1], hub_dense.numel()
    vloc = nrows - H
    W = got[0].shape[-1]
    assert W == int(got[4].max()) + extra
    lanes = fbm.reshape(-1, P, nrows).numpy()
    for lane, f in enumerate(lanes):
        efbm = ref_hop._extend_fbm_local(
            jnp.asarray(f[:, :vloc]), jnp.asarray(own.numpy()),
            jnp.asarray(loc.numpy()), P)
        for p in range(P):
            ref = [np.asarray(x) for x in ref_hop._expand_block(
                jnp.asarray(indptr[p].numpy()), jnp.asarray(nbr[p].numpy()),
                jnp.asarray(rank[p].numpy()), efbm[p], W, P, jnp.int32(p),
                vloc, jnp.asarray(hub_dense.numpy()))]
            q = lane * P + p
            assert int(got[4].reshape(-1)[q]) == int(ref[5]) and not ref[6]
            for name, g, w in zip(("src", "dst", "rank", "eidx"), got, ref):
                np.testing.assert_array_equal(
                    g.reshape(-1, W)[q].numpy(), w, err_msg=f"{q} {name}")
    filled = K.extend_hubs_plain(fbm.clone(), own, loc, vloc)
    tail = K.expand(indptr, nbr, rank, filled, hub_dense, extra)
    assert all(torch.equal(a, b) for a, b in zip(got, tail))


def test_expand_owner_cases_read_past_the_tail():
    """Every junk-tail case expands differently through the tail columns:
    a scan that read them would be caught."""
    for name, args, kw in OWNERS:
        if "junk" not in name:
            continue
        a = K.expand(*args, **kw)
        b = K.expand(*args)
        assert not all(torch.equal(x, y) for x, y in zip(a, b)), name


# ---------------------------------------------------------------------------
# bfs_probe and bfs_level (K11)
# ---------------------------------------------------------------------------


def _untouched_outside(view, before):
    """Nothing of `view`'s buffer outside the view was written."""
    mask = torch.ones_like(before)
    mask.as_strided(view.shape, view.stride(), view.storage_offset()) \
        .fill_(0)
    return torch.equal(view._base[mask], before[mask])


def _ref_probe(args):
    """frontier.py:136-141 on the reference's (P, vmax) frontier, ORed
    into the prior candidates.  The port drops ids out of range, which
    the reference's gather clamps and its scatter wraps (ids < 0): its
    callers keep only valid slots, so the reference is given those."""
    src, nbr, keep, total, fbm, out = (
        None if a is None else a.numpy() for a in args)
    P, EB = src.shape
    vmax = fbm.shape[1]
    k = np.arange(EB)[None, :] < total[:, None]
    if keep is not None:
        k &= keep
    k &= (nbr >= 0) & (nbr < P * vmax) & (src >= 0)
    nb = jnp.asarray(nbr)
    member = jnp.asarray(fbm)[nb % P, nb // P] & jnp.asarray(k)
    blk = jax.vmap(lambda s, m: ref_hop._mark(s, m, P, vmax))(
        jnp.asarray(src), member)
    return out | np.asarray(blk.any(axis=0))


def _ref_level(args):
    """tpu/bfs.py:153-159 and 170-172, and hop._pack_bits of the new
    frontier as int32: (dist, new, unvis, words, counts)."""
    cand, dist, lv = args[0].numpy(), args[1].numpy(), args[2]
    jd = jnp.asarray(dist)
    new = jnp.asarray(cand) & (jd < 0)
    nd = jnp.where(new, lv, jd)
    unvis = nd < 0
    words = np.asarray(ref_hop._pack_bits(new)).view(np.int32)
    return (np.asarray(nd), np.asarray(new), np.asarray(unvis), words,
            [int(new.sum()), int(unvis.sum())])


@pytest.mark.parametrize("case", BFS, ids=[c[0] for c in BFS])
def test_bfs_edge_case_matches_reference(case):
    """The plain probe (frontier from fbm, and from fbits) and the
    wrapper's CPU branch with each route, and the plain level update and
    the wrapper's CPU branch, against the reference, bit for bit; no
    write outside a view."""
    name, kname, args, kw = case
    if kname == "bfs_probe":
        fbm = args[4].numpy()
        np.testing.assert_array_equal(
            kw["fbits"].numpy(),
            np.asarray(ref_hop._pack_bits(jnp.asarray(fbm))).view(np.int32))
        want = _ref_probe(args)
        calls = [lambda a, k: K.bfs_probe_plain(*a),
                 lambda a, k: K.bfs_probe_plain(*a, **k),
                 lambda a, k: K.bfs_probe(*a, **k)]
        calls += [lambda a, k, r=r: K.bfs_probe(*a, **k, route=r)
                  for r in K.PROBE_ROUTES]
        for call in calls:
            a, k = fresh_bfs_args(kname, args, kw)
            before = a[5]._base.clone()
            assert call(a, k) is a[5]
            np.testing.assert_array_equal(a[5].numpy(), want)
            assert _untouched_outside(a[5], before)
        if "none on" in name or "all False" in name or "total 0" in name:
            assert np.array_equal(want, args[5].numpy())
        elif "P 1" in name or "hub rows" in name or "EB 4,099" in name:
            assert (want & ~args[5].numpy()).any()
        return
    nd, new, unvis, words, counts = _ref_level(args)
    for fn in (K.bfs_level_plain, K.bfs_level):
        a, k = fresh_bfs_args(kname, args, kw)
        befores = [t._base.clone() for t in (a[0], a[3], a[4])]
        got = fn(*a, **k)
        assert got.dtype == torch.int64 and got.tolist() == counts
        np.testing.assert_array_equal(a[1].numpy(), nd)
        np.testing.assert_array_equal(a[3].numpy(), new)
        np.testing.assert_array_equal(a[4].numpy(), unvis)
        assert not a[0].any()                   # cand cleared
        for t, b in zip((a[0], a[3], a[4]), befores):
            assert _untouched_outside(t, b)
        if "fbits_out" in k:
            np.testing.assert_array_equal(k["fbits_out"].numpy(), words)
        if "counts" in k:
            assert got is k["counts"]
            rest = got._base.clone()
            rest[args[2]] = 0
            assert not rest.any()
    if "no fresh" in name:
        assert counts[0] == 0
    else:
        assert counts[0] > 0


def test_bfs_cases_cover_each_kernel():
    kinds = {k for _, k, _, _ in BFS}
    assert kinds == {"bfs_probe", "bfs_level"}
    probes = [a for _, k, a, _ in BFS if k == "bfs_probe"]
    assert {a[0].shape[0] for a in probes} >= {1, 8}
    assert any(a[0].shape[1] % 4 for a in probes)
    assert any(a[4].shape[1] % 32 for a in probes)
    assert any(a[4].stride(0) != a[4].shape[1] for a in probes)
    assert any(a[2] is None for a in probes)


@pytest.mark.parametrize("P, vmax, nbytes", [
    (8, 125_000, 125_024), (1, 1, 16), (3, 33, 32), (8, 232_448, 232_448),
    (8, 232_449, 232_480), (1, 1_859_584, 232_448),
    (1, 1_859_585, 232_464), (7, 3001, 2640)])
def test_probe_stage_bytes(P, vmax, nbytes):
    """P rows of ceil(vmax / 32) words, rounded up to 16 bytes."""
    assert K.probe_stage_bytes(P, vmax) == nbytes


@pytest.mark.parametrize("P, vmax, smem, route", [
    (8, 125_000, 232_448, "staged"),         # the north star's BFS
    (8, 232_448, 232_448, "staged"),         # the widest staged frontier
    (8, 232_449, 232_448, "global"),         # one column past it
    (8, 250_000, 232_448, "global"),         # 2M vertices in 8 parts
    (1, 1_859_584, 232_448, "staged"),
    (1, 1_859_585, 232_448, "global"),
    (1, 1, 16, "staged"), (1, 1, 15, "global"),
    (8, 125_000, 125_024, "staged"), (8, 125_000, 125_023, "global")])
def test_probe_route(P, vmax, smem, route):
    assert K.probe_route(P, vmax, smem) == route


def test_probe_route_default_is_a_blocks_shared_memory():
    assert K.probe_route(8, 232_448) == "staged"
    assert K.probe_route(8, 232_449) == "global"


def test_probe_route_argument_checked():
    _, _, args, kw = BFS[0]
    a, k = fresh_bfs_args("bfs_probe", args, kw)
    with pytest.raises(ValueError, match="route"):
        K.bfs_probe(*a, **k, route="bits")


def test_bfs_wrappers_check_the_new_arguments_off_the_cpu():
    """On a device tensor the probe reads only the words, so it raises
    without them (or with the wrong width, or a forced staged route that
    does not fit); the level's counts must be a (2,) int64 row."""
    m = dict(device="meta")
    ints = torch.empty((8, 4), dtype=torch.int32, **m)
    total = torch.empty((8,), dtype=torch.int32, **m)
    bits = torch.empty((8, 40), dtype=torch.bool, **m)
    with pytest.raises(ValueError, match="fbits"):
        K.bfs_probe(ints, ints, None, total, bits, bits)
    with pytest.raises(ValueError, match="fbits"):
        K.bfs_probe(ints, ints, None, total, bits, bits,
                    torch.empty((8, 1), dtype=torch.int32, **m))
    wide = torch.empty((8, 232_449), dtype=torch.bool, **m)
    with pytest.raises(ValueError, match="shared memory"):
        K.bfs_probe(ints, ints, None, total, wide, wide,
                    torch.empty((8, 7265), dtype=torch.int32, **m),
                    route="staged")
    dist = torch.empty((8, 40), dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="counts"):
        K.bfs_level(bits, dist, 1, bits, bits,
                    counts=torch.empty((3,), dtype=torch.int64, **m))
    with pytest.raises(ValueError, match="fbits_out"):
        K.bfs_level(bits, dist, 1, bits, bits,
                    fbits_out=torch.empty((8, 1), dtype=torch.int32, **m))


# ---------------------------------------------------------------------------
# the mesh's exchange kernels (K15, K16), one slot and slot groups
# ---------------------------------------------------------------------------


def _exchange_call(kname, args, plain):
    """Run one exchange case through the plain version (or the wrapper's
    CPU branch) on fresh copies of what it writes; returns (result, the
    args it ran on)."""
    a = list(args)
    if kname == "unpack_or":
        a[2] = copy_view(a[2])
    elif kname == "fill_hub_columns":
        a[0] = a[0].clone()
    fn = getattr(K, kname + "_plain") if plain else getattr(K, kname)
    return fn(*a), a


@pytest.mark.parametrize("case", EXCHANGE, ids=[c[0] for c in EXCHANGE])
def test_exchange_edge_case_matches_reference(case):
    name, kname, args = case
    got, a = _exchange_call(kname, args, plain=True)
    again, _ = _exchange_call(kname, args, plain=False)
    assert torch.equal(got, again)
    if kname == "pack_bits":
        m = args[0].numpy()
        P, vmax = m.shape[-2:]
        for i, mat in enumerate(m.reshape(-1, P, vmax)):
            want = np.asarray(ref_hop._pack_bits(jnp.asarray(mat)))
            np.testing.assert_array_equal(
                got.reshape(-1, P, want.shape[-1])[i].numpy()
                .view(np.uint32), want, err_msg=f"{name}, matrix {i}")
    elif kname == "unpack_or":
        recv, vmax, out = args
        assert got is a[2]
        r = recv.reshape((-1,) + tuple(recv.shape[-2:])).numpy()
        for i, rows in enumerate(r):
            want = np.asarray(ref_hop._unpack_or(
                jnp.asarray(rows.view(np.uint32)), vmax))
            np.testing.assert_array_equal(
                got.reshape(-1, vmax)[i].numpy(), want,
                err_msg=f"{name}, row {i}")
        # nothing around the view is written
        keep = torch.ones_like(out._base)
        keep.as_strided(out.shape, out.stride(),
                        out.storage_offset()).fill_(False)
        assert torch.equal(a[2]._base[keep], out._base[keep])
    elif kname == "owned_hub_bits":
        fbm, p0, owner, local = args
        f = fbm.numpy().reshape((-1,) + tuple(fbm.shape[-3:]))
        want = np.zeros((f.shape[1], owner.numel()), np.int32)
        for s in range(f.shape[0]):
            # the reference's owned bits of the slot of part p0 + s
            mine = np.asarray(owner) == p0 + s
            want += np.asarray(jnp.where(
                jnp.asarray(mine)[None, :],
                jnp.asarray(f[s, :, 0])[:, np.asarray(local)],
                False)).astype(np.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    else:
        fbm, summed = args
        H = summed.shape[1]
        want = fbm.numpy().copy()
        want[..., 0, want.shape[-1] - H:] = summed.numpy() > 0
        assert got is a[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_exchange_group_wrappers_check_their_inputs_off_the_cpu(
        monkeypatch):
    """The group forms reach the kernel library for a device tensor (here
    none: KernelError, no launch counted) and raise ValueError first on
    what the kernels do not take: mark rows not uniformly strided, words
    with a strided word axis, an out of the wrong shape, a non-contiguous
    group buffer, summed bits of the wrong shape."""
    m = dict(device="meta")
    marks = torch.empty((2, 1, 4, 64), dtype=torch.bool, **m)[..., :40]
    recv = torch.empty((2, 1, 4, 2), dtype=torch.int32, **m)
    out = torch.empty((2, 1, 1, 45), dtype=torch.bool, **m)[:, :, 0, :40]
    fbm = torch.empty((2, 1, 1, 45), dtype=torch.bool, **m)
    hubs = torch.empty((5,), dtype=torch.int32, **m)
    summed = torch.empty((1, 5), dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="uniformly strided"):
        K.pack_bits(torch.empty((2, 1, 4, 64), dtype=torch.bool,
                                **m)[:, :, :3, :40])
    with pytest.raises(ValueError, match="unit-stride"):
        K.unpack_or(torch.empty((2, 1, 4, 4), dtype=torch.int32,
                                **m)[..., ::2], 40, out)
    with pytest.raises(ValueError, match="out must be"):
        K.unpack_or(recv, 40, out[:1])
    with pytest.raises(ValueError, match="contiguous"):
        K.owned_hub_bits(torch.empty((2, 1, 1, 90), dtype=torch.bool,
                                     **m)[..., ::2], 0, hubs, hubs)
    with pytest.raises(ValueError, match="summed"):
        K.fill_hub_columns(fbm, torch.empty((2, 5), dtype=torch.int32,
                                            **m))

    def no_lib():
        raise K.KernelError("no kernel library")

    monkeypatch.setattr(K, "_lib", no_lib)
    K.reset_launch_counts()
    for call in (lambda: K.pack_bits(marks),
                 lambda: K.unpack_or(recv, 40, out),
                 lambda: K.owned_hub_bits(fbm, 2, hubs, hubs),
                 lambda: K.fill_hub_columns(fbm, summed)):
        with pytest.raises(K.KernelError):
            call()
    assert all(v == 0 for v in K.launch_counts().values())
