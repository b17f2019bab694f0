"""The port's kernels, in their plain versions, against the reference's
device functions run in JAX on the CPU.

expand ↔ hop._expand_block, mark ↔ hop._mark plus the OR over source
parts (and TpuRuntime._seed_builder for seeds), compact_capture ↔
hop._compact_cap plus the yield-column gather.  The CUDA kernels run on
the card only; chip_smoke.py holds each against its plain version there.
Inputs come from a numpy seed; P = 8, vmax <= 256.  Tolerance: exact —
all of it is integer indexing and 8-byte copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop

from nebula_tpu_torch.algo import kernels as AK
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import exprjit as X
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.graphstore.csr import StringPool
from nebula_tpu_torch.graphstore.schema import PropType

P = 8


def _csr(seed, vmax=200, hub_rows=2):
    """A random padded CSR block with a few supernode rows."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, (P, vmax))
    deg[rng.integers(0, P, hub_rows), rng.integers(0, vmax, hub_rows)] = 150
    indptr = np.zeros((P, vmax + 1), np.int32)
    np.cumsum(deg, axis=1, out=indptr[:, 1:])
    emax = int(indptr[:, -1].max())
    nbr = np.full((P, emax), -1, np.int32)
    rank = np.zeros((P, emax), np.int32)
    for p in range(P):
        n = int(indptr[p, -1])
        nbr[p, :n] = rng.integers(0, P * vmax, n)
        rank[p, :n] = rng.integers(0, 3, n)
    fbm = rng.random((P, vmax)) < 0.3
    return indptr, nbr, rank, fbm


def _ref_expand(indptr, nbr, rank, fbm, EB):
    outs = [ref_hop._expand_block(jnp.asarray(indptr[p]),
                                  jnp.asarray(nbr[p]),
                                  jnp.asarray(rank[p]),
                                  jnp.asarray(fbm[p]), EB, P,
                                  jnp.int32(p))
            for p in range(P)]
    names = ("src", "dst", "rank", "eidx", "valid", "total", "ovf")
    return {n: np.stack([np.asarray(o[i]) for o in outs])
            for i, n in enumerate(names)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_matches_reference(seed):
    indptr, nbr, rank, fbm = _csr(seed)
    src, dst, rk, eidx, total = K.expand(_t(indptr), _t(nbr), _t(rank),
                                         _t(fbm))
    EB = src.shape[1]
    ref = _ref_expand(indptr, nbr, rank, fbm, EB)
    np.testing.assert_array_equal(total.numpy(), ref["total"])
    assert EB == int(ref["total"].max())    # sized exactly: no overflow
    assert not ref["ovf"].any()
    for name, got in (("src", src), ("dst", dst), ("rank", rk),
                      ("eidx", eidx)):
        assert got.dtype == torch.int32, name
        # the whole row, padding included, is the reference's
        np.testing.assert_array_equal(got.numpy(), ref[name], err_msg=name)


def test_expand_empty_frontier():
    indptr, nbr, rank, fbm = _csr(3)
    src, dst, rk, eidx, total = K.expand(_t(indptr), _t(nbr), _t(rank),
                                         torch.zeros(fbm.shape, dtype=bool))
    assert src.shape == (P, 0) and total.tolist() == [0] * P


@pytest.mark.parametrize("seed", [0, 1])
def test_mark_matches_reference(seed):
    indptr, nbr, rank, fbm = _csr(seed)
    vmax = fbm.shape[1]
    src, dst, rk, eidx, total = K.expand(_t(indptr), _t(nbr), _t(rank),
                                         _t(fbm))
    EB = src.shape[1]
    ref = _ref_expand(indptr, nbr, rank, fbm, EB)
    rng = np.random.default_rng(seed + 10)
    keep = ref["valid"] & (rng.random(ref["valid"].shape) < 0.5)
    # reference: per-part scatter-max, then OR over the source parts
    want = np.zeros((P, vmax), bool)
    for p in range(P):
        want |= np.asarray(ref_hop._mark(jnp.asarray(ref["dst"][p]),
                                         jnp.asarray(keep[p]), P, vmax))
    got = K.mark(dst, P, vmax, keep=_t(keep))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # keep=None keeps every valid slot (padding carries dst = -1)
    want_all = np.zeros((P, vmax), bool)
    for p in range(P):
        want_all |= np.asarray(ref_hop._mark(
            jnp.asarray(ref["dst"][p]), jnp.asarray(ref["valid"][p]),
            P, vmax))
    np.testing.assert_array_equal(K.mark(dst, P, vmax).numpy(), want_all)


def test_mark_accumulates_into_out():
    """Marks of several blocks OR into one next-frontier tensor."""
    vmax = 16
    out = torch.zeros((P, vmax), dtype=torch.bool)
    K.mark(torch.tensor([3, 9], dtype=torch.int32), P, vmax, out=out)
    K.mark(torch.tensor([9, 20], dtype=torch.int32), P, vmax, out=out)
    assert sorted(out.view(-1).nonzero().view(-1).tolist()) == \
        sorted((d % P) * vmax + d // P for d in (3, 9, 20))


def test_mark_duplicate_false_never_clears():
    """The duplicate-index trap: a False at an index a True also hits
    must not clear the bit, in either order."""
    vmax = 4
    ids = torch.tensor([5, 5, 5], dtype=torch.int32)
    for keep in ([True, False, False], [False, False, True]):
        got = K.mark(ids, P, vmax, keep=torch.tensor(keep))
        assert got[5 % P, 5 // P] and got.sum() == 1


def test_mark_drops_out_of_range_ids():
    vmax = 4
    got = K.mark(torch.tensor([-1, -7, P * vmax, P * vmax + 3, 2],
                              dtype=torch.int32), P, vmax)
    assert got.sum() == 1 and got[2, 0]


@pytest.mark.parametrize("seeds", [[5, 9, 9, 1599, 0], [3], []])
def test_seed_bitmap_matches_reference(seeds):
    vmax = 200
    rt = TpuRuntime(make_mesh(1))
    _, fn = rt._seed_builder(jax.devices("cpu")[0], P, vmax, lanes=False)
    pad = np.full(8, -1, np.int64)
    pad[:len(seeds)] = seeds
    want = np.asarray(fn(pad))
    got = K.mark(torch.tensor(seeds, dtype=torch.int32), P, vmax)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_capture_matches_reference(seed):
    indptr, nbr, rank, fbm = _csr(seed)
    src, dst, rk, eidx, total = K.expand(_t(indptr), _t(nbr), _t(rank),
                                         _t(fbm))
    EB = src.shape[1]
    rng = np.random.default_rng(seed + 20)
    valid = np.arange(EB)[None, :] < total.numpy()[:, None]
    keep = valid & (rng.random((P, EB)) < 0.6)
    emax = nbr.shape[1]
    w = rng.integers(-5, 100, (P, emax))
    f = rng.random((P, emax))
    f[rng.random((P, emax)) < 0.1] = np.nan        # float NULL sentinel
    cs, cd, cr, ce, props, kc = K.compact_capture(
        src, dst, rk, eidx, _t(keep), [_t(w), _t(f)])
    for p in range(P):
        rs, rd, rr, re, rkc = (np.asarray(x) for x in ref_hop._compact_cap(
            jnp.asarray(src[p].numpy()), jnp.asarray(dst[p].numpy()),
            jnp.asarray(rk[p].numpy()), jnp.asarray(eidx[p].numpy()),
            jnp.asarray(keep[p]), EB))
        k = int(rkc)
        assert int(kc[p]) == k
        for name, got, want in (("src", cs, rs), ("dst", cd, rd),
                                ("rank", cr, rr), ("eidx", ce, re)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got[p, :k].numpy(), want[:k],
                                          err_msg=name)
        # yield gather (hop.py:550): col[p][compacted eidx], bit for bit
        np.testing.assert_array_equal(props[0][p, :k].numpy(), w[p][re[:k]])
        np.testing.assert_array_equal(props[1][p, :k].numpy().view(np.int64),
                                      f[p][re[:k]].view(np.int64))
    assert props[0].dtype == torch.int64 and props[1].dtype == torch.float64


def test_compact_capture_padding():
    src = torch.arange(6, dtype=torch.int32).view(1, 6)
    keep = torch.tensor([[False, True, False, True, True, False]])
    col = torch.arange(10, 20, dtype=torch.int64).view(1, 10)
    cs, cd, cr, ce, (pc,), kc = K.compact_capture(src, src, src, src, keep,
                                                  [col])
    assert kc.tolist() == [3]
    assert cs.tolist() == [[1, 3, 4, -1, -1, -1]]
    assert cr.tolist() == [[1, 3, 4, 0, 0, 0]]
    assert pc.tolist() == [[11, 13, 14, 0, 0, 0]]


def test_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A non-CPU tensor goes to the kernel or raises: with no kernel
    library the wrappers raise, the plain versions are not called and
    no launch is counted."""
    def no_lib():
        raise K.KernelError("no kernel library")

    def plain_called(*a, **k):
        raise AssertionError("plain version used for a device tensor")

    monkeypatch.setattr(K, "_lib", no_lib)
    for name in ("expand_plain", "mark_plain", "compact_capture_plain",
                 "predicate_mask_plain",
                 "bfs_probe_plain", "bfs_level_plain", "merge_delta_plain",
                 "pack_bits_plain", "unpack_or_plain",
                 "owned_hub_bits_plain", "fill_hub_columns_plain"):
        monkeypatch.setattr(K, name, plain_called)
    for name in ("pagerank_step_plain", "wcc_step_plain",
                 "sssp_step_plain"):
        monkeypatch.setattr(AK, name, plain_called)
    K.reset_launch_counts()
    m = dict(device="meta")
    with pytest.raises(K.KernelError):
        K.expand(torch.empty((P, 5), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 4), dtype=torch.bool, **m))
    with pytest.raises(K.KernelError):
        K.mark(torch.empty((3,), dtype=torch.int32, **m), P, 4)
    ints = [torch.empty((P, 4), dtype=torch.int32, **m) for _ in range(4)]
    with pytest.raises(K.KernelError):
        K.compact_capture(*ints, torch.empty((P, 4), dtype=torch.bool, **m))
    hubs = torch.empty((2,), dtype=torch.int32, **m)
    with pytest.raises(K.KernelError):
        K.expand(torch.empty((P, 7), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 6), dtype=torch.bool, **m), hubs,
                 hub_owner=hubs, hub_local=hubs)
    prog, _ = X.compile_predicate(
        PE.Binary(">", PE.EdgeProp("e", "w"), PE.Literal(1)),
        {"w": PropType.INT64}, StringPool())
    with pytest.raises(K.KernelError):
        K.predicate_mask(prog, *ints, torch.empty((P,), dtype=torch.int32,
                                                  **m),
                         [torch.empty((P, 3), dtype=torch.int64, **m)])
    n, E = 6, 9
    f64 = torch.empty((n,), dtype=torch.float64, **m)
    vbool = torch.empty((n,), dtype=torch.bool, **m)
    e32 = torch.empty((E,), dtype=torch.int32, **m)
    with pytest.raises(K.KernelError):
        AK.pagerank_step(f64, e32, torch.empty((n + 1,), dtype=torch.int64,
                                               **m),
                         torch.empty((E,), dtype=torch.float64, **m),
                         vbool, vbool, 6.0, 0.85, 0.0)
    with pytest.raises(K.KernelError):
        AK.wcc_step(torch.empty((n,), dtype=torch.int64, **m), vbool, e32,
                    e32)
    with pytest.raises(K.KernelError):
        AK.sssp_step(f64, vbool, e32, e32,
                     torch.empty((E,), dtype=torch.float64, **m))
    bits = torch.empty((P, 6), dtype=torch.bool, **m)[:, :4]
    with pytest.raises(K.KernelError):
        K.bfs_probe(*ints[:2], torch.empty((P, 4), dtype=torch.bool, **m),
                    torch.empty((P,), dtype=torch.int32, **m), bits, bits,
                    torch.empty((P, 1), dtype=torch.int32, **m))
    with pytest.raises(K.KernelError):
        K.bfs_level(bits, torch.empty((P, 4), dtype=torch.int32, **m), 1,
                    bits, bits)
    d32 = torch.empty((P, 2), dtype=torch.int32, **m)
    with pytest.raises(K.KernelError):
        K.merge_delta(*ints, torch.empty((P,), dtype=torch.int32, **m),
                      bits, d32, d32, d32,
                      torch.empty((P, 2), dtype=torch.bool, **m), d32, 3)
    marks = torch.empty((1, P, 40), dtype=torch.bool, **m)
    with pytest.raises(K.KernelError):
        K.pack_bits(marks)
    with pytest.raises(K.KernelError):
        K.unpack_or(torch.empty((1, P, 2), dtype=torch.int32, **m), 40,
                    marks[:, 0])
    slot = torch.empty((1, 1, 42), dtype=torch.bool, **m)
    with pytest.raises(K.KernelError):
        K.owned_hub_bits(slot, 0, hubs, hubs)
    with pytest.raises(K.KernelError):
        K.fill_hub_columns(slot, torch.empty((1, 2), dtype=torch.int32, **m))
    assert K.route_launch_counts()["expand (hub owners)"] == 0
    assert K.launch_counts() == {"expand": 0, "mark": 0,
                                 "predicate_mask": 0, "compact_capture": 0,
                                 "bfs_probe": 0, "bfs_level": 0,
                                 "merge_delta": 0, "pack_bits": 0,
                                 "unpack_or": 0, "owned_hub_bits": 0,
                                 "fill_hub_columns": 0,
                                 "pagerank_step": 0, "wcc_step": 0,
                                 "sssp_step": 0}


def test_wrapper_rejects_bad_inputs_before_launch():
    m = dict(device="meta")
    with pytest.raises(ValueError, match="int32"):
        K.mark(torch.empty((3,), dtype=torch.int64, **m), P, 4)
    with pytest.raises(ValueError, match="shape"):
        K.expand(torch.empty((P, 9), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 3), dtype=torch.int32, **m),
                 torch.empty((P, 4), dtype=torch.bool, **m))
    ints = torch.empty((P, 4), dtype=torch.int32, **m)
    total = torch.empty((P,), dtype=torch.int32, **m)
    bits = torch.empty((P, 6), dtype=torch.bool, **m)
    with pytest.raises(ValueError, match="contiguous rows"):
        K.bfs_probe(ints, ints, None, total, bits[:, ::2][:, :3],
                    bits[:, :3])
    with pytest.raises(ValueError, match="bool bitmap"):
        K.bfs_level(bits[:, :4], ints, 1, ints, bits[:, :4])
