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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.algo import kernels as ref_kernels
from nebula_tpu.tpu import hop as ref_hop

from nebula_tpu_torch.algo import kernels as AK
from nebula_tpu_torch.bench.kernel_cases import (copy_view, mark_cases,
                                                 pagerank_cases)
from nebula_tpu_torch.gpu import kernels as K

MARK = mark_cases("cpu")
PAGERANK = pagerank_cases("cpu")
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
