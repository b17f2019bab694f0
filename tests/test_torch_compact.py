"""The scan kernels' plain versions on their edge cases, against the
reference's device functions run in JAX on the CPU.

`expand_plain` ↔ hop._expand_block (nebula_tpu/tpu/hop.py:58) and
`compact_capture_plain` ↔ hop._compact_cap (:238) plus the yield-column
gather (:543-550), on bench/kernel_cases.py's small set: the shapes where
the CUDA kernels' single-pass scan and edge-balanced fill can go wrong
(empty rows, widths around a scan tile and off 16-byte alignment, a kept
slot only at the end of each tile, hub rows longer than a fill block,
runs of zero-degree rows, lanes, delta halves, shard slots).
chip_smoke.py holds each CUDA kernel against its plain version on the
same cases at card sizes.  Tolerance: exact — integer indexing and
8-byte copies.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from nebula_tpu.tpu import hop as ref_hop

from nebula_tpu_torch.bench.kernel_cases import compact_cases, expand_cases
from nebula_tpu_torch.gpu import kernels as K

COMPACT = compact_cases("cpu")
EXPAND = expand_cases("cpu")


def _rows(t):
    return t.reshape(int(np.prod(t.shape[:-1])), t.shape[-1]).numpy()


@pytest.mark.parametrize("case", COMPACT, ids=[c[0] for c in COMPACT])
def test_compact_capture_edge_case_matches_reference(case):
    _, (src, dst, rk, eidx, keep, cols), kw = case
    extent, dcols = kw.get("extent"), kw.get("dcols")
    cs, cd, cr, ce, props, kc = K.compact_capture(src, dst, rk, eidx, keep,
                                                  cols, **kw)
    lead, EB = tuple(keep.shape[:-1]), keep.shape[-1]
    P = lead[-1]
    assert kc.shape == lead and cs.shape == lead + (EB,)
    k_rows = _rows(keep)
    if extent is not None:
        k_rows = k_rows & (np.arange(EB) < extent.reshape(-1, 1).numpy())
    ins = [_rows(t) for t in (src, dst, rk, eidx)]
    outs = [_rows(t) for t in (cs, cd, cr, ce)]
    for q in range(k_rows.shape[0]):
        want = [np.asarray(x) for x in ref_hop._compact_cap(
            *(jnp.asarray(a[q]) for a in ins), jnp.asarray(k_rows[q]), EB)]
        k = int(want[4])
        assert int(kc.reshape(-1)[q]) == k
        for name, got, w in zip(("src", "dst", "rank", "eidx"), outs, want):
            # the whole row, padding included, is the reference's
            np.testing.assert_array_equal(got[q], w, err_msg=name)
        p = q % P
        for i, c in enumerate(cols):
            full = c[p].numpy()
            if dcols is not None:        # hop.py:547's concatenation
                full = np.concatenate([full, dcols[i][p].numpy()])
            got = _rows(props[i])[q]
            np.testing.assert_array_equal(
                got[:k].view(np.int64), full[want[3][:k]].view(np.int64))
            # past kcount the port's contract pads the words with 0
            assert not got[k:].view(np.int64).any()


@pytest.mark.parametrize("case", EXPAND, ids=[c[0] for c in EXPAND])
def test_expand_edge_case_matches_reference(case):
    _, args, _ = case
    indptr, nbr, rank, fbm, hub_dense, extra, parts, pid = args
    src, dst, rk, eidx, total = K.expand(*args)
    P, nrows = indptr.shape[0], fbm.shape[-1]
    parts = P if parts is None else parts
    W = src.shape[-1]
    assert W == (int(total.max()) if total.numel() else 0) + extra
    H = 0 if hub_dense is None else hub_dense.numel()
    f_rows = _rows(fbm)
    outs = [_rows(t) for t in (src, dst, rk, eidx)]
    for q in range(f_rows.shape[0]):
        p = q % P
        ref = ref_hop._expand_block(
            jnp.asarray(indptr[p].numpy()), jnp.asarray(nbr[p].numpy()),
            jnp.asarray(rank[p].numpy()), jnp.asarray(f_rows[q]), W, parts,
            jnp.int32(pid + p), nrows - H,
            None if hub_dense is None else jnp.asarray(hub_dense.numpy()))
        ref = [np.asarray(x) for x in ref]
        assert int(total.reshape(-1)[q]) == int(ref[5]) and not ref[6]
        for name, got, w in zip(("src", "dst", "rank", "eidx"), outs, ref):
            np.testing.assert_array_equal(got[q], w, err_msg=name)


@pytest.mark.parametrize("rows, n, words", [
    (8, 0, 9), (8, 1, 9), (8, K.SCAN_TILE, 9), (8, K.SCAN_TILE + 1, 17),
    (64, 3_747_444, 64 * 915 + 1), (1, 125_000, 32)])
def test_scan_status_words(rows, n, words):
    """One status word a tile of each row (an empty row still takes one,
    so that its tile 0 writes the row's total), then the ticket."""
    assert K.scan_status_words(rows, n) == words
