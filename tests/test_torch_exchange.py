"""The mesh's exchange over slot groups (K15, K16) against the reference's,
on the CPU.

A slot group is a run of consecutive shard slots that share a device
(`Mesh.groups`); the exchange's buffers are one allocation a group and
each of its kernels covers a whole group.  Three groupings of a 4-slot
mesh reach every case: `devices=[cpu]` (one group of four), `[cpu] * 4`
(four groups of one) and `[cpu, cpu]` (two groups of two).  Held here:

  (a) pack_bits over each group, the transport, unpack_or into every
      slot: each slot's next frontier equal to the reference's
      `_exchange_marks_lanes` run under `shard_map` on the 4-device
      virtual CPU mesh of tests/conftest.py, the hub columns untouched,
      the transport's count the reference's payload, and no copy inside
      a lone group;
  (b) owned_hub_bits over each group, the transport's sum,
      fill_hub_columns: every slot's row equal to the reference's
      `_extend_fbm_local`;
  (d) a spy on gpu/hop.py's four kernel wrappers: a 3-step split GO and
      a 5-level BFS call each once a group a step, each call covering
      the group's slots.

(c), GO and the BFS under the three groupings against the reference's
mesh and the one-group run, is in tests/test_torch_sharded.py, beside
its reference runtimes.  Inputs come from numpy with a seed.  Tolerance:
exact — the exchange moves bits.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec

from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.tpu.device import shard_map as ref_shard_map

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import GpuRuntime
from nebula_tpu_torch.gpu import hop as H
from nebula_tpu_torch.gpu.device import make_mesh

CPU = torch.device("cpu")
P = 4
GROUPINGS = {"one_group": [CPU], "four_groups": [CPU] * 4,
             "two_groups": [CPU, CPU]}
GROUP_SIZES = {"one_group": [4], "four_groups": [1] * 4,
               "two_groups": [2, 2]}
VMAXES = [31, 32, 33, 1000]


def _mesh(grouping):
    m = make_mesh(P, devices=GROUPINGS[grouping])
    assert [len(g) for g in m.groups] == GROUP_SIZES[grouping]
    return m


@functools.lru_cache(maxsize=None)
def _ref_exchange(lanes: int, vmax: int):
    """(marks (P src, L, P dst, vmax) bool, the reference's next frontier
    of each slot (P, L, vmax)) for one seed."""
    rng = np.random.default_rng(lanes * 10_000 + vmax)
    marks = rng.random((P, lanes, P, vmax)) < 0.3
    marks[0, 0, P - 1, vmax - 1] = True          # the last column's bit
    mesh = JaxMesh(np.array(jax.devices()[:P]), ("part",))
    spec = PartitionSpec("part")
    fn = ref_shard_map(
        lambda m: ref_hop._exchange_marks_lanes(m[0], P, vmax)[None],
        mesh=mesh, in_specs=spec, out_specs=spec)
    want = np.asarray(jax.jit(fn)(jnp.asarray(marks)))
    assert want.shape == (P, lanes, vmax)
    return marks, want


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("vmax", VMAXES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_group_exchange_matches_reference(lanes, vmax, grouping):
    marks, want = _ref_exchange(lanes, vmax)
    mesh = _mesh(grouping)
    hubs = 5
    # each group's mark matrices and next frontiers: one allocation each
    bufs = [torch.zeros((len(g), lanes, 1, vmax + hubs), dtype=torch.bool)
            for g in mesh.groups]
    group_marks = H.new_group_marks(bufs, P, vmax)
    for g, m in zip(mesh.groups, group_marks):
        assert m.shape == (len(g), lanes, P, vmax)
        m.copy_(torch.from_numpy(marks[g.start:g.stop]))
    H.exchange_marks_lanes(mesh, group_marks,
                           [b[:, :, 0, :vmax] for b in bufs])
    for g, b in zip(mesh.groups, bufs):
        for s, slot in enumerate(g):
            np.testing.assert_array_equal(b[s, :, 0, :vmax].numpy(),
                                          want[slot], err_msg=f"slot {slot}")
        assert not b[..., vmax:].any()
    assert mesh.transport.sent_bytes == \
        H.a2a_payload_bytes(P, vmax, lanes) == \
        ref_hop.a2a_payload_bytes(P, vmax, lanes)
    # a lone group's words reach unpack_or as a view of what it packed
    packed = [H.pack_bits(m) for m in group_marks]
    recv = mesh.transport.all_to_all(mesh, packed)
    assert len(recv) == len(mesh.groups)
    for g, r in zip(mesh.groups, recv):
        assert r.shape == (len(g), lanes, P, -(-vmax // 32))
    if len(mesh.groups) == 1:
        assert recv[0].data_ptr() == packed[0].data_ptr()
        assert recv[0].untyped_storage().data_ptr() == \
            packed[0].untyped_storage().data_ptr()


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("vmax", VMAXES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_group_hub_pair_matches_reference(lanes, vmax, grouping):
    rng = np.random.default_rng(lanes * 100 + vmax)
    hubs = 7
    dense = rng.choice(P * vmax, hubs, replace=False).astype(np.int32)
    owner, local = dense % P, dense // P
    fbm = rng.random((lanes, P, vmax)) < 0.3
    fbm[0, owner[0], local[0]] = True
    mesh = _mesh(grouping)
    to = torch.from_numpy
    shards = [SimpleNamespace(part=p, hub_owner=to(owner),
                              hub_local=to(local)) for p in range(P)]
    bufs = [torch.zeros((len(g), lanes, 1, vmax + hubs), dtype=torch.bool)
            for g in mesh.groups]
    for g, b in zip(mesh.groups, bufs):
        b[:, :, 0, :vmax] = to(fbm[:, g.start:g.stop]).transpose(0, 1)
    H.extend_fbm_sharded_lanes(mesh, shards, bufs)
    for lane in range(lanes):
        want = np.asarray(ref_hop._extend_fbm_local(
            jnp.asarray(fbm[lane]), jnp.asarray(owner), jnp.asarray(local),
            P))
        for g, b in zip(mesh.groups, bufs):
            for s, slot in enumerate(g):
                np.testing.assert_array_equal(
                    b[s, lane, 0].numpy(), want[slot],
                    err_msg=f"lane {lane} slot {slot}")


def test_slot_buffers_are_group_views():
    """new_slot_frontiers gives each slot a view of its group's one
    allocation, and slot_groups gives the allocation back without a copy;
    buffers that are not such views are refused."""
    snap = D.snapshot_from_arrays(D.make_social_arrays(200, 4), parts=P)
    for grouping in sorted(GROUPINGS):
        rt = GpuRuntime(mesh=_mesh(grouping))
        dev = rt.pin_prebuilt(snap)
        slots = H.new_slot_frontiers(dev, lanes=2)
        groups = H.slot_groups(rt.mesh, slots)
        for g, gt in zip(rt.mesh.groups, groups):
            assert gt.shape == (len(g), 2, 1, dev.vmax)
            for s, i in enumerate(g):
                assert slots[i].shape == (2, 1, dev.vmax)
                assert gt[s].data_ptr() == slots[i].data_ptr()
    with pytest.raises(ValueError, match="views of one group buffer"):
        H.slot_groups(_mesh("one_group"),
                      [torch.zeros((1, 1, 8), dtype=torch.bool)
                       for _ in range(P)])


# ---------------------------------------------------------------------------
# (d) a spy on the exchange's kernel wrappers: once a group a step
# ---------------------------------------------------------------------------

_SPIED = ("pack_bits", "unpack_or", "owned_hub_bits", "fill_hub_columns")


@pytest.fixture(scope="module")
def split_snap():
    arrs = D.make_social_arrays(600, 6)
    return arrs, D.snapshot_from_arrays(arrs, parts=P)


def _spy(monkeypatch):
    """Wrap gpu/hop.py's four exchange wrappers; returns {name: [the
    slot count of each call]}."""
    calls = {n: [] for n in _SPIED}
    for name in _SPIED:
        fn = getattr(H, name)

        def spied(*a, _fn=fn, _name=name, **kw):
            t = a[0]
            calls[_name].append(t.shape[0] if t.dim() == 4 else 1)
            return _fn(*a, **kw)
        monkeypatch.setattr(H, name, spied)
    return calls


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_exchange_runs_once_a_group_a_step(monkeypatch, split_snap,
                                           grouping):
    arrs, snap = split_snap
    rt = GpuRuntime(mesh=_mesh(grouping), degree_split_threshold=24)
    dev = rt.pin_prebuilt(snap)
    assert dev.num_hubs > 0
    store = D.SnapshotStore(snap)
    seeds = sorted(set(np.unique(arrs["src"][:64])[:16].tolist())
                   | {int(dev.host.hub_dense[0])})
    sizes = GROUP_SIZES[grouping]
    calls = _spy(monkeypatch)
    rows, st = rt.traverse(
        store, "snb", seeds, ["KNOWS"], "out", 3,
        edge_filter=PE.Binary(">", PE.EdgeProp("KNOWS", "w"),
                              PE.Literal(50)),
        yields=[(PE.FunctionCall("dst", [PE.EdgeExpr()]), "d")])
    assert len(rows) > 0 and st.shards == P
    # two exchanges (hops 1 and 2) and three hub extensions, each one call
    # a group covering its slots
    assert calls == {"pack_bits": sizes * 2, "unpack_or": sizes * 2,
                     "owned_hub_bits": sizes * 3,
                     "fill_hub_columns": sizes * 3}
    calls = _spy(monkeypatch)
    dist, st = rt.bfs(store, "snb", seeds[:1], ["KNOWS"], "out", 5)
    assert (dist >= 0).sum() > 1
    assert calls == {n: sizes * 5 for n in _SPIED}
