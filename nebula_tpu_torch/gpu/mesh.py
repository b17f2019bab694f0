"""The sharded mesh: P shard slots and the transports between them.

Port of the reference's mesh (`nebula_tpu/tpu/device.py:81 make_mesh`,
`:148/:153 mesh_lanes/mesh_parts`, `:34 init_multihost`) for the form it
takes on CUDA cards.  The reference runs one SPMD program over a device
list (`shard_map` over a `("part",)` mesh); its collectives are the
per-hop `all_to_all` of the bit-packed frontier (`hop.py:214`) and the
`psum` of the hub bits (`hop.py:292`).  Here a mesh is P **shard
slots**, each holding one partition's rows on its own device (several
slots may share one: on one H100 all eight north-star parts sit on
`cuda:0`), and the host loops of `gpu/hop.py` and `gpu/bfs.py` run each
slot's kernels and call the transport where the reference's program
calls its collective.

**Slot groups.**  The runs of consecutive local slots that share a home
(`Mesh.groups`) are the exchange's unit: each buffer the exchange reads
or writes is one allocation a group with a leading slot axis (slot s of
the group at index s), and K15's and K16's kernels cover a whole group
in one launch.  On one card all slots are one group; `make_mesh(n,
devices=[cpu] * n)` gives n groups of one; a process-group rank's slots
are one group.  The transports take and return one tensor a group.
Two transports, one interface:

  InProcess     every slot lives in this process; the all_to_all hands
                each destination group a (S, Ll, P, W) tensor of the
                words bound for its slots — with one group, a permuted
                view of the group's own words (no copy); with several,
                assembled by one copy from each group; the sum passes a
                single group's partial through, or adds the groups';
  ProcessGroup  `torch.distributed` (NCCL for CUDA tensors, gloo for
                CPU ones): each rank holds a contiguous run of P / world
                slots, one group; the all_to_all is one
                `all_to_all_single` over the group (its own chunk
                included), whose received tensor goes on as a view; the
                sum one `all_reduce`.

**Lane rows.**  A two-axis mesh (`device.make_mesh2`, the reference's
`("lane", "part")` grid, tpu/device.py:107) holds `lanes` rows of the P
part slots: slot (l, p) is lane row l's copy of part p.  `Mesh.rows`
gives each row as a one-axis mesh over the same transport; the hop loop
runs a batch's lanes in contiguous chunks, one a row, each row with its
own exchange.  A one-axis mesh is its own only row.

**Gathering across ranks.**  On a process group each rank runs the
same runtime calls (SPMD) and holds only its own parts' results; two
more collectives give every rank all P parts: `all_gather` (the ranks'
per-part tensors, concatenated in part order) and `max_ints` (a
max-reduce of a few host integers, such as each hop's widest slot).
On `InProcess` both are the identity.

Neither gives way to the other on failure: a transport error raises,
and a collective that times out is the caller's error.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import torch


class Mesh:
    """`lanes` rows of P shard slots, of which this process holds, in
    every row, slots `first` .. `first + k - 1`: `devices` lists them
    row-major, row l's slot `first + i` on `devices[l * k + i]`.
    `homes` likewise names the device each slot lives on, for the
    per-device memory budget: the index of its entry in the device list
    the mesh was laid over (default: one device a slot).  The fields
    `devices`, `homes` and `groups` describe row 0 (for a one-axis mesh,
    every slot); `rows` holds each row as a one-axis mesh over the same
    transport.  `groups`: the runs of consecutive local slots of a row
    with one home and device, as ranges of local slot indices.
    `launch_lock` is held by every run that exchanges over the mesh, so
    two runs never interleave their collectives."""

    def __init__(self, size: int, devices: Sequence[torch.device],
                 transport, first: int = 0,
                 homes: Optional[Sequence[int]] = None, lanes: int = 1):
        devices = tuple(torch.device(d) for d in devices)
        homes = tuple(range(len(devices)) if homes is None else homes)
        self.size = int(size)
        self.lanes = int(lanes)
        self.transport = transport
        self.first = int(first)
        self.launch_lock = threading.Lock()
        if self.lanes < 1 or len(devices) % self.lanes \
                or len(homes) != len(devices):
            raise ValueError(f"{len(devices)} slots ({len(homes)} homes) "
                             f"do not make {self.lanes} lane rows")
        k = len(devices) // self.lanes
        self.devices: Tuple[torch.device, ...] = devices[:k]
        self.homes: Tuple[int, ...] = homes[:k]
        if self.size < 1 or not self.devices \
                or self.first + k > self.size:
            raise ValueError(f"{k} slots from slot {self.first} do not "
                             f"fit a mesh of {self.size}")
        starts = [i for i in range(k)
                  if i == 0 or (self.homes[i], self.devices[i])
                  != (self.homes[i - 1], self.devices[i - 1])]
        self.groups: Tuple[range, ...] = tuple(
            range(a, b) for a, b in zip(starts, starts[1:] + [k]))
        self.rows: Tuple["Mesh", ...] = (self,) if self.lanes == 1 else \
            tuple(Mesh(self.size, devices[r * k:(r + 1) * k], transport,
                       self.first, homes[r * k:(r + 1) * k])
                  for r in range(self.lanes))

    @property
    def parts(self) -> List[int]:
        """The global slot (= part) ids this process holds."""
        return list(range(self.first, self.first + len(self.devices)))

    @property
    def in_process(self) -> bool:
        return isinstance(self.transport, InProcess)

    def __repr__(self) -> str:
        return (f"Mesh(lanes={self.lanes}, size={self.size}, "
                f"first={self.first}, devices="
                f"{[str(d) for r in self.rows for d in r.devices]}, "
                f"transport={type(self.transport).__name__})")


class InProcess:
    """The transport of a mesh whose slots all live in this process.
    `sent_bytes` counts the words its exchanges shipped: every slot's
    (Ll, P, W)."""

    def __init__(self):
        self.sent_bytes = 0

    def all_to_all(self, mesh: Mesh, send: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """send[g]: group g's (S_g, Ll, P, W) words, [s, :, d] slot s's
        row for slot d.  Returns recv, recv[g][j, :, s] = the words slot s
        sent to group g's slot j: with one group, its words permuted (a
        view); with several, one copy from each group into each."""
        self.sent_bytes += sum(x.numel() * x.element_size() for x in send)
        if len(send) == 1:
            return [send[0].permute(2, 1, 0, 3)]
        recv = []
        for gd, mine in zip(mesh.groups, send):
            r = torch.empty((len(gd),) + tuple(mine.shape[1:]),
                            dtype=mine.dtype, device=mine.device)
            for gs, x in zip(mesh.groups, send):
                r[:, :, gs.start:gs.stop].copy_(
                    x[:, :, gd.start:gd.stop].permute(2, 1, 0, 3))
            recv.append(r)
        return recv

    @staticmethod
    def all_reduce_sum(mesh: Mesh, vals: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The sum over the groups of vals[g] ((Ll, H) int32), on each
        group's device; a single group's partial passes through."""
        if len(vals) == 1:
            return [vals[0]]
        total = vals[0].clone()
        for v in vals[1:]:
            total += v.to(total.device)
        return [total.to(mesh.devices[g.start]) for g in mesh.groups]

    @staticmethod
    def all_gather(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's parts of `t` along `dim`: this process holds
        them all already."""
        return t

    @staticmethod
    def max_ints(mesh: Mesh, vals: Sequence[int]) -> List[int]:
        """The max of each of `vals` over the processes: these."""
        return [int(v) for v in vals]


def _one_group(mesh: Mesh, vals: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(vals) != 1 or len(mesh.groups) != 1:
        raise ValueError(f"a process-group mesh holds one slot group a "
                         f"rank; got {len(vals)} tensors for "
                         f"{len(mesh.groups)} groups")
    return vals[0]


class ProcessGroup:
    """The transport of a mesh spread over the ranks of a
    `torch.distributed` process group, P / world slots a rank, one
    group.  `sent_bytes` counts the words this rank's exchanges
    shipped."""

    def __init__(self, group=None):
        self.group = group
        self.sent_bytes = 0

    def all_to_all(self, mesh: Mesh, send: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        import torch.distributed as dist
        world = dist.get_world_size(self.group)
        g = _one_group(mesh, send)
        k, L, P, W = g.shape
        # x[r, i, :, j]: local slot i's row for slot r * k + j
        x = g.reshape(k, L, world, k, W).permute(2, 0, 1, 3, 4).contiguous()
        self.sent_bytes += x.numel() * x.element_size()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=self.group)
        # y[r, i, :, j]: rank r's slot r * k + i to local slot j; as
        # (j, L, r * k + i, W) a view, the (r, i) axes merging
        return [y.permute(3, 2, 0, 1, 4).reshape(k, L, P, W)]

    def all_reduce_sum(self, mesh: Mesh, vals: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        import torch.distributed as dist
        total = _one_group(mesh, vals)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return [total]

    def all_gather(self, mesh: Mesh, t: torch.Tensor,
                   dim: int) -> torch.Tensor:
        """Every rank's `t` (the same shape on each: this rank's parts
        along `dim`) concatenated along `dim` in rank order, which is part
        order; one `all_gather`.  A bool tensor travels as bytes."""
        import torch.distributed as dist
        x = t.contiguous()
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = [torch.empty_like(wire)
               for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(out, wire, group=self.group)
        got = torch.cat(out, dim)
        return got.view(torch.bool) if x.dtype == torch.bool else got

    def max_ints(self, mesh: Mesh, vals: Sequence[int]) -> List[int]:
        """The max over the ranks of each of `vals`, a few host ints;
        one `all_reduce` of an int64 tensor on the mesh's device."""
        import torch.distributed as dist
        if not len(vals):
            return []
        t = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                         device=mesh.devices[0])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return [int(v) for v in t.tolist()]


def process_group_mesh(n: int, device, group=None) -> Mesh:
    """An n-slot mesh over an initialised process group: rank r holds
    slots r * n / world .. (r + 1) * n / world - 1, all on `device`."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n % world:
        raise ValueError(f"{n} slots do not split over {world} ranks")
    k = n // world
    return Mesh(n, [device] * k, ProcessGroup(group), first=rank * k,
                homes=[rank] * k)


def init_multihost(backend: str = None) -> bool:
    """Join a process group when the coordination environment is set
    (the reference's `init_multihost`, tpu/device.py:34): NEBULA_COORDINATOR
    (host:port of rank 0) with NEBULA_NUM_PROCESSES and NEBULA_PROCESS_ID.
    No-op (False) when NEBULA_COORDINATOR is unset; True once joined,
    idempotent.  A half-set environment is a ValueError."""
    import torch.distributed as dist
    coord = os.environ.get("NEBULA_COORDINATOR")
    if not coord:
        return False
    missing = [k for k in ("NEBULA_NUM_PROCESSES", "NEBULA_PROCESS_ID")
               if k not in os.environ]
    if missing:
        raise ValueError(f"NEBULA_COORDINATOR is set but {missing} are not "
                         f"— multi-host init needs all three")
    if dist.is_initialized():
        return True
    try:
        world = int(os.environ["NEBULA_NUM_PROCESSES"])
        rank = int(os.environ["NEBULA_PROCESS_ID"])
    except ValueError as ex:
        raise ValueError(f"NEBULA_NUM_PROCESSES / NEBULA_PROCESS_ID must "
                         f"be integers: {ex}") from None
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)
    return True
