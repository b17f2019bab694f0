#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one NVIDIA GPU and prove its paths.

The paths are GO N STEPS, `CALL algo.*`, the device BFS of FIND
SHORTEST PATH, GO and the BFS again on a snapshot with writes pending in
its delta plane, concurrent GO statements batched into one run of the
lane-widened kernels, MATCH's every-hop expansion, and GO, the BFS and
MATCH again over a mesh of eight shard slots, GO and MATCH over DATE,
DATETIME, TIME and GEOGRAPHY edge props, and GO and the BFS on a
snapshot the runtime built from the port's own store, through its
writes, rebuilds and compaction, nGQL GO statements and writes through
the port's QueryEngine on that store, LDBC IC5 and IC9 fused into
one MATCH pipeline node through that engine, and nGQL sent over RPC to
a LocalCluster whose graphd pins the storageds' export, each through
the hand-written CUDA kernels.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                 # the north-star size
    python3 chip_smoke.py --persons 20000 # a quick check
    python3 chip_smoke.py --split 0       # skip the degree-split path
    python3 chip_smoke.py --seed 3        # another write batch (phase 7)
    python3 chip_smoke.py --ic-persons 2000  # a smaller phase 15 slice

Phases, in order; any failure exits non-zero before the result line:
  1. the card's name and power limit (nvidia-smi) and torch's name for it;
  2. build the kernels from nebula_tpu_torch/csrc (nvcc, sm_90a), and
     log ptxas's registers, stack frame and spills of every instance of
     predicate_kernel, merge_delta_kernel, relax.cu's relax_kernel,
     prologue_kernel and finish_kernel, and bfs.cu's bfs_probe_kernel
     and bfs_level_kernel;
  3. the north-star GO (datagen.north_star): make_social_arrays(persons,
     30, seed=7) → snapshot_from_arrays(parts=8), then GO 3 STEPS from 16
     seeds YIELD dst(edge) AS d, KNOWS.w AS w, unfiltered and WHERE
     KNOWS.w > 50, each checked against the host oracle
     host_csr_traverse on the unsplit snapshot (rows as multisets,
     traversed edges by count), on two paths:
       a. unsplit: GpuRuntime().pin_prebuilt;
       b. split, as bench.py runs it: GpuRuntime(degree_split_threshold=
          --split, 2048 by default).pin_prebuilt of the same arrays; its
          per-hop hop_edges must equal the unsplit run's.
     Launch counters are zeroed just before each path and read just
     after; every kernel of the path must have launched, and on the
     split path every expand through its "hub owners" route (each hub's
     bit read from its owner's row: K8 folded into the scan) and no
     hub-column pass;
  4. each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it: expand at each hop of both layouts
     (split: the owner route on the buffer as the main path leaves it,
     its tail columns zero, against expand_plain over the buffer that
     extend_hubs_plain fills), mark at hop 2 (into the split frontier
     buffer's strided view too) and for the seeds, the fused scan at
     split hop 3 beside the parent's pair (the hub bits by their
     library gather, then the tail-reading scan), predicate_mask for
     w > 50 and
     eleven predicates over int, float-with-NaN, bool and string-code
     columns with nulls at the filtered split hop 3, compact_capture
     there with the w column and with four columns; exact equality,
     kernel / plain / one-library-call times from CUDA events, and each
     kernel's bound (bytes at 3.35 TB/s or int32 operations at
     33.5 TOP/s, whichever is larger); the seed bitmap (K6, mark with
     its zero fill) is timed apart; mark's two kernels (staged and
     direct, gpu/kernels.py:mark_path) are each held bit for bit and
     timed at hop 2 beside the wrapper's choice (and at [8d], [9d],
     [10f]); so are predicate_mask's two routes for w > 50 (the
     one-comparison instance and the interpreter,
     gpu/kernels.py:predicate_path), beside the torch formulation of
     w > 50 in three calls (a yardstick); then ([4e]) expand and
     compact_capture against their plain versions, bit for bit, on
     bench/kernel_cases.py's edge cases of their single-pass scan and
     edge-balanced fill (empty rows and
     outputs, widths around a scan tile and off 16-byte alignment, a hub
     row longer than a fill block, lanes, delta halves, shard slots, rows
     of hundreds of tiles; expand's owner route with hubs owned by the
     first, a middle and the last part, an inactive hub, junk tail
     columns, 1, 2 and 8 lanes, H = 1, 73 and 300), mark bit for bit through each kernel that
     fits and through the wrapper's choice (no ids, none kept, ids out of
     range, one id repeated, counts and lanes off 16-byte alignment, an
     odd row stride, ones already set, P = 1, 3, 7, a bitmap too wide to
     stage), and pagerank_step within 1e-12 with two runs bit-identical
     (no edges, one vertex, one vertex holding every edge, edgeless rows
     across a block's edge, segments ending on one, every vertex
     dangling, vmask holes, 30M Zipf edges), predicate_mask bit for bit
     through every route its program has and the wrapper's choice
     (widths 1, 3, 4, 5 and past a tile, total 0 and total = EB, a valid
     mask with holes, delta halves, lanes, every opcode family, 64
     instructions, 8 registers, 128 constants, an always-false
     program), and merge_delta bit for bit in every output (Tcap 0,
     Dcap 0, MAXI rows, tombstones on a tile's first and last eidx and
     past its staged slice, eidx in no order, lanes, shard slots, a
     strided frontier, widths not a multiple of 4), and wcc_step and
     sssp_step (unweighted and weighted) bit for bit through each route
     that fits and the wrapper's choice (no edges, one vertex, n off a
     32-bit word, every source off or on, one destination holding
     3,000,000 edges, runs of one destination ending on a lane's, a
     warp's and a block's edge, sentinels in the mask, weights 0.0 and
     0.5, n at the staged route's capacity and one past it, 30M Zipf
     edges, and those edges again in a random order), and bfs_probe
     through each route that fits and the wrapper's choice, and
     bfs_level in every output, bit for bit (P = 1 and 8, vmax off a
     32-bit word, strided views, EB off 4, totals 0 and EB, every
     neighbour on the frontier and none, ids out of range, keep all
     False and None, hub rows, the BFS's widest level, the widest
     frontier that stages and one column past it; a level with no fresh
     vertex, phantom slots, counts as a row of a larger buffer), and the
     mesh's exchange kernels bit for bit, one slot and slot groups (vmax
     off a 32-bit word, mark rows and bases off 16 bytes, the
     transports' strided views of the received words, destination rows
     of odd stride, groups whose first part is not 0, the north star's
     hop-2 shapes);
  5. the algo plane (`CALL algo.*`, algo/engine.run_algorithm on
     GpuRuntime()):
       a. on the north-star snapshot of phase 3 (30M KNOWS edges, 60M
          for WCC's both directions, 1M slots): PageRank (max_iter=20,
          tol=0), WCC, SSSP (src=0, weight="w"), launch counters zeroed
          first; each step kernel's launches must equal the iterations
          run.  The same iterations driven through the plain steps on
          the card must give the same state (WCC, SSSP exactly; PageRank
          max |Δrank| <= 1e-8) and two kernel PageRank runs bit-identical
          ranks; PageRank's cold run's host parts are timed apart;
       b. tools/algo_bench.run_suite at bench.py's algo degree
          (min(--persons, 50000) persons, degree 30, 8 parts): rows equal
          to the numpy oracles (PageRank within 1e-8);
       c. each step kernel against its plain version on the inputs of
          the first and a middle iteration of (a) (exact; PageRank
          within 1e-12, the kernel's moved count exact over its own
          ranks and equal to the plain version's vertex by vertex
          wherever rounding cannot flip `> tol`), timed with its plain version
          and one library call (index_add_, scatter_reduce_ amin); beside
          pagerank_step, its gather floor: one rank.index_select over
          esrc at the same shape, a yardstick the port never calls; and
          for wcc_step and sssp_step (one row each, named by the route
          the wrapper chose, algo/kernels.py:relax_route): both routes
          forced at the middle iteration (`relax paths`), the step at
          every iteration's inputs of (a), each held against its plain
          version, timed and summed beside the summed bounds (`whole
          run`), and WCC's gather floor (label.index_select over esrc);
       d. WCC and SSSP past the staged route's capacity: a social graph
          of GLOBAL_PERSONS (2,000,000) persons of degree 4 in 8 parts,
          through run_algorithm, counters zeroed first: every step on
          the global route, launches equal to iterations, state equal
          to the plain steps' bit for bit; each kernel's global row
          timed at the middle iteration;
  6. the device BFS of FIND SHORTEST PATH, as bench.py config 5 runs it:
     GpuRuntime.bfs(store, "ns", [seeds[0]], ["KNOWS"], "out", 5) on the
     north-star snapshot, one cold and three warm runs per path, launch
     counters zeroed just before each path and read just after:
       a. unsplit and split at --split: dist equal to host_bfs, hop_edges
          equal to a numpy count of each level's slots under the
          reference's switch (the frontier's out-degrees top-down, the
          unvisited vertices' in-degrees bottom-up; so equal between the
          layouts), at least one level bottom-up; expand, mark,
          bfs_probe, bfs_level launched (split: every expand through the
          owner route), every probe on its staged route, pack_bits
          never (bfs_level writes the frontier's words);
       b. WHERE KNOWS.w > 50 on the split path against a numpy level BFS
          over the edges with w > 50; predicate_mask launched too;
       c. bfs_probe and bfs_level against their plain versions on the
          inputs of every level of (a) and (b) on the main path (exact;
          the probe's words equal to pack_bits of its frontier), timed at
          the widest bottom-up level with their plain versions and one
          library formulation (the gather plus index_put_; the three
          torch ops plus two sums), and their byte bounds; both probe
          routes forced there (`probe paths`); the probe's gather floor
          (the frontier's bytes at every slot's neighbour, one
          index_select: what the parent kernel's gathers cost); both
          kernels at every level's inputs of the split and the filtered
          run, summed (`K11 kernels whole run`); expand at the widest
          level's shapes the same way (`expand (bfs)`);
       d. the BFS past the probe's staged capacity: (5d)'s graph pinned
          alone, config 5's BFS from vertex 0: dist equal to host_bfs,
          hop_edges to the numpy count, every probe on the global route;
          the global row timed at its widest bottom-up level, its whole
          run, paths and gather floor as in (c);
  7. the delta plane: GpuRuntime(delta_max_edges=8192).pin_prebuilt of
     the unsplit north-star snapshot (an empty plane armed), a
     SnapshotStore over its arrays watching writes, and a write batch made
     from --seed with numpy: an LDBC SNB Interactive-style mix of 24,000
     KNOWS inserts between persons (1,000 of them from the 16 seeds),
     8,000 deletes and 8,000 overwrites of w on base edges, in a random
     order.  Launch counters are zeroed just before each run and read
     just after:
       a. one pin folds the 40,000 writes into the plane without a
          re-pin: apply seconds, bytes put, hbm_bytes before and after;
       b. GO 3 STEPS from the 16 seeds, unfiltered and WHERE KNOWS.w > 50,
          before the writes and after (p50 of DELTA_REPEATS runs after a
          warm-up, each state): rows equal, in order, to a fresh
          GpuRuntime() pin of snapshot_from_arrays(store.mutated_arrays())
          (the full rebuild) and, as multisets, to host_csr_traverse on
          it; hop_edges equal to the reference's count (each hop's
          frontier's base out-degrees, deletes included, plus its delta
          rows);
          expand, merge_delta, mark, predicate_mask and compact_capture
          launched;
       c. config 5's BFS from vertex 0, every level top-down (the plane
          turns bottom-up off): dist equal to host_bfs on the rebuilt
          snapshot, hop_edges to the same count, bfs_probe never
          launched;
       d. at hop 3's shapes: expand with the delta tail, merge_delta,
          and predicate_mask and compact_capture reading the delta column
          halves, each against its plain version (exact); merge_delta
          timed behind a spin kernel with its plain version and a
          library formulation (searchsorted + gather + cat), and its
          byte bound;
  8. multi-lane batched GO (bench.py `config batching`): concurrent
     GpuRuntime.traverse calls from threads with the batch former on
     (batch_max_lanes = the statement count, batch_wait_us = 300000, two
     dummy live statements as company so that forming is deterministic);
     each statement first runs solo (batching off), launch counters
     zeroed just before the first solo run and read just after it, then
     all run at once, counters zeroed just before and read just after:
       a. 16 statements GO 1 STEP FROM one north-star seed each YIELD
          dst(edge) on the split snapshot;
       b. the main path: 8 statements GO 3 STEPS FROM 2 seeds each WHERE
          KNOWS.w > 50 YIELD dst(edge), KNOWS.w on the split snapshot,
          with max_memory_allocated above the pin;
       c. 4 statements GO 3 STEPS FROM 4 seeds each WHERE KNOWS.w > 50 on
          phase 7's delta-armed snapshot, its writes pending;
     each must form ONE batch of all its statements (one device run),
     launch the kernels exactly as often as one solo run (merge_delta
     among them in c), and give every statement its solo run's rows in
     order and its hop_edges; printed: dispatches per statement, the
     batch's device_s against the sum of the solo device_s, wall time
     per statement batched against sequential solo;
       d. each lane-widened kernel against its plain version at (b)'s
          lane shapes (merge_delta at (c)'s), exact, timed with CUDA
          events, with its byte bound (each shared CSR, column and delta
          array counted once); and the one library formulation of
          expand (with the hub gather), compact_capture and merge_delta;
          the owner route at every hop against expand_plain over the
          filled lane stack;
  9. MATCH's every-hop expansion (GpuRuntime.traverse_hops: the WHERE
     mask and the compaction at every hop, the next frontier marking
     only the kept dsts), launch counters zeroed just before each run
     and read just after:
       a. bench.py config 4b: make_social_arrays(150,000 (or --persons
          when smaller), 6, seed=11, src_hot_frac=0) with each (src, dst)
          key's last draw kept (datagen.unique_keys, as a store's
          overwrite keeps it), 8 parts, MATCH *1..4 from the first 1,792
          persons with out-degree >= 3: the frames' trail count
          (count_trails, the executor's assembly) equal to
          host_trail_paths, each hop's frame equal to host_hop_edges as a
          multiset, compact_capture 4 launches and mark 3 plus the seeds;
          p50 of 3 warm runs of device_s, fetch_s, the frame build and
          the assembly;
       b. the north star as the main path lays it out (split at --split
          when it ran), MATCH *1..3 WHERE KNOWS.w > 50 from the 16 seeds:
          frames equal to host_hop_edges over the edges with w > 50,
          predicate_mask 3 launches, split every expand through the
          owner route; unfiltered, hop_edges equal to phase 3's GO 3
          STEPS;
       c. 8 concurrent MATCH over 9a's graph, 224 seeds each, as phase 8
          batches them: one batch, launches equal to one solo run's,
          each statement's frames equal to its solo run's in order;
       d. at 9b's shapes, predicate_mask and compact_capture at hops 1
          and 2 and mark with the predicate's keep at hop 2, each against
          its plain version (exact), timed with CUDA events beside its
          plain version and one library formulation, with its byte
          bound, and the every-hop loop's bound;
 10. the sharded mesh (GpuRuntime(mesh=make_mesh(8)): eight shard slots,
     all on the one card, each holding only its own part's rows, one slot
     group; one bit-packed exchange a hop through the in-process
     transport, each exchange kernel one launch for the group), launch
     counters zeroed just before each run and read just after:
       a. the main path's snapshot (split at --split) pinned slot by slot,
          each slot's bytes exactly its part's and the hub tables; GO 3
          STEPS from the 16 seeds, unfiltered and WHERE KNOWS.w > 50, p50
          of 3 runs of device, fetch and materialize: rows equal in order
          to phase 3's, hop_edges and frontier_sizes too, exchange_bytes
          2 * a2a_payload_bytes(8, vmax); exactly 2 pack_bits, 2
          unpack_or and (split) 3 owned_hub_bits and 3 fill_hub_columns
          launches a query;
       b. config 5's BFS on that mesh, top-down at every level: depths
          equal to host_bfs, hop_edges to each level's frontier's
          out-degrees, exchange_bytes bfs_exchange_bytes(8, vmax, 5);
          exactly 5 launches of each exchange kernel a run;
       c. GO 3 STEPS through phase 7's 40,000 writes (a twin store's log)
          on an 8-slot pin of the unsplit delta-armed snapshot: rows equal
          in order to phase 7's; merge_delta (mesh), every slot's merge
          at hop 3 (parts = 8, pid = p) against its plain version and
          row p of the local merge, timed;
       d. config 4b (9a's graph and seeds, *1..4) on an 8-slot mesh: the
          trail count equal to host_trail_paths;
       e. 8 concurrent GO 3 STEPS WHERE w > 50 on (a)'s mesh, as 8b
          batches them: one batch, one solo run's launches, solo rows;
       f. the four exchange kernels over the group of eight against
          their plain versions at (a)'s hop-2 shapes (each slot's
          unpacked frontier equal to hop 3's local frontier, each slot's
          hub columns to extend_hubs_plain's), timed with their plain
          versions
          and one library formulation over the group, with their byte
          bounds; the transport's receive a view (no copy); one whole
          exchange_marks_lanes and extend_fbm_sharded_lanes timed; the (mesh)
          rows: expand (parts = 8, pid = p) and mark at hop 2,
          predicate_mask and compact_capture at hop 3, at every slot's
          shapes against their plain versions (the expansion against
          row p of the local one), timed at the widest slot;
       g. (a)'s filtered GO through the process-group transport, a
          one-rank NCCL group holding all eight slots: rows equal to
          (a)'s, the bytes sent equal to (a)'s exchange_bytes; then a
          GpuRuntime over that group's mesh: GO (rows, hop_edges and
          exchange_bytes equal to (a)'s), MATCH *1..3 WHERE w > 50
          (frames equal to the in-process mesh's), the BFS (depths equal
          to (b)'s); NCCL takes one rank a device, so two ranks are
          held on the CPU over gloo (tests/test_torch_mesh2.py);
       h. the two-axis grid: the north star's arrays at 4 parts pinned
          through GpuRuntime(mesh=make_mesh2(2, 4)) (2 x 4 slots on the
          one card, the rows sharing each part's copy: hbm_bytes equal
          to make_mesh(4)'s, the pin's allocation below 1.5 times its),
          split as the main path: GO 3 STEPS WHERE w > 50 with rows
          equal to the local runtime's on the same snapshot, hop_edges,
          exchange_bytes and launches a run equal to make_mesh(4)'s;
          [8b]'s 8 statements as
          one batch over the two rows (each lane's rows its solo run's,
          every launch twice a solo run's); config 5's BFS on row 0,
          depths equal to the local runtime's and phase 6's;
 11. temporal and geography props on the north star's recipe at
     min(--persons, 100000) persons (datagen.north_star: degree 30, the
     same seeds' rule; depth cut for the time limit, from 1,000,000 to
     250,000 and then, when phase 16 came, to 100,000): five edge columns
     derived from each edge's f by a fixed rule (temporal_words): d and
     d2 DATE (1920-2019), t DATETIME with microseconds, tm TIME, g
     GEOGRAPHY (pool codes of 1,000 point WKTs), about one value in 50
     of each NULL; launch counters zeroed just before each run and read
     just after:
       a. the snapshot carrying them pinned as the main path lays it out
          (split at --split);
       b. GO 3 STEPS from the 16 seeds WHERE KNOWS.d < KNOWS.d2 (the
          predicate program on two DATE columns; d2's rule keeps about
          1% of the final hop) YIELD d, t, tm, g: edges and hop_edges
          equal to the numpy walk's, rows equal as a multiset to the numpy
          oracle's words (datagen.host_final_hop) decoded by the
          runtime's per-value decode, each column's decode timed; GO 1
          STEP YIELD d, t, tm, g and with Edge rows, and traverse_hops
          over 2 hops, from the last 64 persons with out-edges: rows,
          Edges and frames (check_frames, and 2,000 decoded Edges a hop)
          against the out block's words; each query one warm-up and one
          timed run; predicate_mask on the d < d2 program at the
          filtered hop 3 against its plain version, timed beside the
          torch formulation (`predicate_mask (temporal)`);
       c. 1,000 inserts from the seeds carrying every column's type
          (dates before 1970, new points, NULLs) through a SnapshotStore
          with the extra columns into GpuRuntime(delta_max_edges=8192)'s
          plane on the unsplit snapshot: b's GO 3 STEPS rows equal, in
          order, to a fresh pin of the written out block (the inserts
          spliced into each row as a rebuild orders it) and that pin's
          rows to the oracle; merge_delta launched;
 12. the store path at a third of bench.py config 4b's store-backed size
     (bench.py:727-733, 150,000 persons; depth cut for the time limit
     when phase 16 came): make_social_graph(50_000, 6, parts=8,
     seed=11, space="twb") fills the port's GraphStore (about 296,000
     KNOWS edges); launch counters zeroed just before each GO path and read
     just after:
       a. GpuRuntime(delta_max_edges=2048).pin(store, "twb") exports and
          pins it (the build, export and pin seconds, hbm_bytes,
          max_memory_allocated); the pinned mirror's KNOWS out block
          holds exactly the store's edges: each part's count, and 1,000
          seeded vertices' rows against the store's get_neighbors;
       b. GO 3 STEPS from 16 pick_seeds(min_degree=3) YIELD dst(edge),
          KNOWS.w, unfiltered and WHERE KNOWS.w > 50, on that pin and
          on a pin split at 64 (H hubs logged; the owner route on every
          expand): rows equal to host_csr_traverse over the built
          snapshot, and the filtered rows to a row-at-a-time walk of the
          store's own get_neighbors(edge_filter=...); p50, device loop,
          launches a query;
       c. about 10,000 writes through the store's API, from --seed
          (LDBC SNB IU8 and DEL8: edge inserts, deletes, overwrites of
          w, 64 persons inserted into the vmax slack): the next pin
          folds them in place, merge_delta launches, and GO's rows
          (in order) and the BFS's depths equal those of a second
          runtime that pins the written store fresh;
       d. on a store of its own at 20,000 persons (each rebuild is an
          export; depth cut for the time limit): a batch past the plane
          rebuilds and re-pins (tpu_pins + 1), as does a write to the
          split pin; the rows equal a fresh pin's; then on this store a
          batch past the compaction watermark (0.25) over c's writes
          compacts on a thread, which is joined: tpu_compactions + 1,
          the plane empty, the rows and depths equal to the fresh pin's;
 13. nGQL through the port's QueryEngine on phase 12's store, with its
     unsplit runtime (the plane of 2,048) and the one split at 64, each
     statement against a host engine (tpu_runtime=None) on the same
     store; launch counters zeroed just before each statement and read
     just after:
       a. EXPLAIN of each statement below shows one TpuTraverse node and
          no ExpandAll;
       b. bench.py config 1's GO 2 STEPS YIELD dst(edge), config 2's GO
          3 STEPS WHERE KNOWS.w > 50 YIELD dst(edge), KNOWS.w, the same
          unfiltered, GO 2 STEPS REVERSELY YIELD src(edge), and config
          2's on the split runtime (whose first statement rebuilds the
          pin 12's writes left stale, in its warm-up): one warm-up and 2
          timed runs each; rows equal to the host engine's as a multiset,
          last_tpu_stats set, no fallback, plan-cache hits, launches
          equal to the bare GpuRuntime.traverse call's with the
          executor's own arguments; p50 of the engine, the host engine
          and the bare call, and the device loop;
       c. about 1,000 writes as nGQL (INSERT EDGE in statements of 100
          rows, DELETE EDGE, UPDATE EDGE ... SET w) through the device
          engine, then config 2's statement: folded into the plane
          (tpu_pins unchanged, merge_delta launched), rows equal to the
          host engine's;
       d. GO 1 STEP WHERE upper(KNOWS.city) == "ADA", a filter the rule
          refuses, plans no TpuTraverse, launches no kernel, and gives
          the host engine's rows (on a longer GO the rule would still
          fuse the hops below the last, as the reference's does);
 14. MATCH, FIND PATH, GET SUBGRAPH and CALL algo.* through the port's
     QueryEngine on phase 12's store as phase 13 left it, on its unsplit
     runtime (13c's writes pending on the plane) and the one split at
     64; each statement one warm-up (which records the runtime calls its
     executor makes) and 1 timed run (3 for config 4b), launch counters
     zeroed just before each and read just after, equal to those of the
     recorded calls made bare:
       a. EXPLAIN of config 4b's statement (MATCH (a:Person)-[e:KNOWS
          *1..4]->(b) from 1,792 pick_seeds(min_degree=3) RETURN
          count(*), bench.py:739-750) is one TpuMatchAgg node, and
          each single-clause MATCH of b plans a Traverse and no
          TpuMatchPipeline, as the reference's three rules plan it;
       b. MATCH *1..3 from phase 12's 16 seeds RETURN id(b), size(e),
          unfiltered and with the inline {city: "ada"} (the device's
          WHERE mask at every hop), and a one-hop MATCH WHERE e.w > 50
          (pushed into the Traverse, rechecked on the host): rows equal
          to the host engine's as a multiset;
       c. config 4b's count(*) through TpuMatchAgg equals
          host_trail_paths over a fresh build_snapshot of the store; p50
          beside the bare traverse_hops call's;
       d. FIND SHORTEST PATH from 4 seeds to 16 vids (8 two hops out, 8
          drawn) UPTO 6 STEPS, unfiltered and WHERE KNOWS.w > 50: one
          BFS a source; rows equal to the host engine's, in order;
       e. FIND ALL PATH ... UPTO 3 STEPS, and GET SUBGRAPH 2 STEPS from
          the 16 seeds OUT KNOWS: rows equal to the host engine's;
       f. CALL algo.pagerank(max_iter=20, tol=0), algo.wcc() and
          algo.sssp(src=<seed>, weight="w") on the unsplit runtime while
          13c's writes are pending: tpu_pins rises by 1 (the statement
          re-pins before the algorithm reads the adjacency), K12-K14
          launches equal run_algorithm's on the same snapshot, rows
          equal to a host engine's (PageRank within 1e-8);
 15. the MATCH pipeline through the engine: LDBC IC5 and IC9 as
     bench.py:786-830 runs them (root 5, min_date 17,000, max_date
     19,000) on make_snb_interactive(--ic-persons, 6,000 by default,
     parts=8) in the port's store, on an unsplit runtime with a delta
     plane of 2,048 and one split at 64, each statement against a host
     engine on the same store:
       a. each statement's EXPLAIN, through canon_plan, is the
          reference's device plan (IC_PLANS): one TpuMatchPipeline node;
       b. one warm-up, which records the segment program (its sha256
          must be the reference's, IC_PROGRAMS) and the traverse_hops
          call of each chain, then 2 timed runs with the launch counters
          zeroed just before each and read just after: rows equal to
          ic5_numpy / ic9_numpy and to the host engine's, in order;
          match_pipeline_fused + 1 a run and match_pipeline_fallback
          unmoved; launches equal to the recorded calls made bare;
          p50 of the engine, the bare calls and the host engine, the
          device loop, and PROFILE's segment rows;
       c. nGQL writes through the unsplit engine (96 new Posts by the
          root's friends with their HAS_CREATOR and CONTAINER_OF edges,
          48 HAS_MEMBER edges deleted, 4 of IC5's top forums retitled):
          folded into the plane once (tpu_repin_avoided + 1, merge_delta
          launched), the split runtime re-pins; both statements again as
          in b, rows equal to the host engine's and to a fresh pin's,
          and every device tag tensor equal to the host mirror's;
 16. the cluster plane at bench.py's concurrency size (bench.py:938-1063):
     LocalCluster(n_meta=1, n_storage=3, n_graph=1) whose graphd holds
     GpuRuntime(delta_max_edges=8192), space conc (8 parts, replica
     factor 3), each statement held to a host QueryEngine on a local
     GraphStore loaded with the same statements:
       a. 2,000 Person vertices and the 11,989 KNOWS edges of
          default_rng(29) in INSERTs of 400 rows through the client; the
          first statements pin the space from the storageds' export
          (load, export and put seconds, pinned bytes);
       b. bench.py's mix: 64 client threads, 6 statements each,
          alternating 1-hop GO and 1-hop MATCH; rows equal to the host
          engine's as multisets, expand, mark and compact_capture
          launched, one kernel-ledger record a kernel run; p50, p95,
          p99, QPS and the dispatch-gate queue-wait share;
       c. test_cluster_device_plane's five statements (two GO, MATCH
          *1..2, GET SUBGRAPH, FIND ALL PATH) and a FIND SHORTEST PATH
          from 4 seeds: PROFILE's fused nodes equal an in-process device
          engine's EXPLAIN (TpuTraverse for GO), rows equal to the host
          engine's, predicate_mask launched and mark more often than the
          runs (next frontiers);
       d. INSERT EDGE, DELETE EDGE and an INSERT VERTEX into the vmax
          slack through the client: the next statements ride the plane
          (tpu_repin_avoided rises, the snapshot and the export count
          stay, merge_delta launched), rows equal to the host engine's,
          and again after a forced re-export;
 17. the `kernels` JSON line (the split GO path's, the algo path's, the
     split BFS path's (6d's for the global probe), the delta GO path's,
     the batched path's, the MATCH path's, the mesh GO path's, phase
     11's filtered GO path's and phase 13's, 14's, 15's and 16's engine
     paths' launches), the card line, and the result line {"ok": true,
     "device": {...}} last.
Without CUDA it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT32_OPS_PER_S = 33.5e12        # half the 67 TFLOP/s float32 CUDA-core rate
FP64_OPS_PER_S = 34e12           # H100 SXM float64 outside the tensor cores
ROUTE_SOURCES = {
    "expand": ("nebula_tpu_torch/csrc/expand.cu",
               "nebula_tpu/tpu/hop.py:58"),
    "mark": ("nebula_tpu_torch/csrc/mark.cu",
             "nebula_tpu/tpu/hop.py:168"),
    # K8's hub bits, read by expand's scan from the owners' rows (its
    # "hub owners" route): no kernel of their own
    "extend_hubs (fused into expand)": ("nebula_tpu_torch/csrc/expand.cu",
                                        "nebula_tpu/tpu/hop.py:303"),
    "predicate_mask": ("nebula_tpu_torch/csrc/predicate.cu",
                       "nebula_tpu/tpu/exprjit.py:201"),
    "compact_capture": ("nebula_tpu_torch/csrc/compact_capture.cu",
                        "nebula_tpu/tpu/hop.py:238"),
    "pagerank_step": ("nebula_tpu_torch/csrc/pagerank.cu",
                      "nebula_tpu/algo/kernels.py:49"),
    # csrc/relax.cu's two routes (algo/kernels.py:relax_route), a row each
    "wcc_step (staged)": ("nebula_tpu_torch/csrc/relax.cu",
                          "nebula_tpu/algo/kernels.py:79"),
    "wcc_step (global)": ("nebula_tpu_torch/csrc/relax.cu",
                          "nebula_tpu/algo/kernels.py:79"),
    "sssp_step (staged)": ("nebula_tpu_torch/csrc/relax.cu",
                           "nebula_tpu/algo/kernels.py:95"),
    "sssp_step (global)": ("nebula_tpu_torch/csrc/relax.cu",
                           "nebula_tpu/algo/kernels.py:95"),
    # csrc/bfs.cu's two probe routes (gpu/kernels.py:probe_route), a row
    # each
    "bfs_probe (staged)": ("nebula_tpu_torch/csrc/bfs.cu",
                           "nebula_tpu/algo/frontier.py:136"),
    "bfs_probe (global)": ("nebula_tpu_torch/csrc/bfs.cu",
                           "nebula_tpu/algo/frontier.py:136"),
    "bfs_level": ("nebula_tpu_torch/csrc/bfs.cu",
                  "nebula_tpu/tpu/bfs.py:170"),
    "merge_delta": ("nebula_tpu_torch/csrc/delta.cu",
                    "nebula_tpu/tpu/hop.py:118"),
    # the sharded mesh's exchange (K15) and hub bits (K16), phase 10
    "pack_bits": ("nebula_tpu_torch/csrc/exchange.cu",
                  "nebula_tpu/tpu/hop.py:179"),
    "unpack_or": ("nebula_tpu_torch/csrc/exchange.cu",
                  "nebula_tpu/tpu/hop.py:195"),
    "owned_hub_bits": ("nebula_tpu_torch/csrc/exchange.cu",
                       "nebula_tpu/tpu/hop.py:292"),
    "fill_hub_columns": ("nebula_tpu_torch/csrc/exchange.cu",
                         "nebula_tpu/tpu/hop.py:292"),
}
# the lane-widened kernels of phase 8 replace K10, the reference's lanes
# program (a vmap of the hop program over a query-lane axis)
LANES_REPLACES = "nebula_tpu/tpu/hop.py:619"
for _k in ("expand", "mark", "predicate_mask", "compact_capture",
           "merge_delta"):
    ROUTE_SOURCES[_k + " (lanes)"] = (ROUTE_SOURCES[_k][0], LANES_REPLACES)
ROUTE_SOURCES["extend_hubs (fused into expand, lanes)"] = (
    ROUTE_SOURCES["expand"][0], LANES_REPLACES)
# MATCH's every-hop mode (phase 9) runs three kernels at shapes GO never
# gives them: the WHERE mask and the compaction at every hop, the mark
# with the mask as its keep (hop.py:_build_local_fn, capture_hops)
ROUTE_SOURCES["predicate_mask (match)"] = (
    ROUTE_SOURCES["predicate_mask"][0], "nebula_tpu/tpu/hop.py:522")
ROUTE_SOURCES["compact_capture (match)"] = (
    ROUTE_SOURCES["compact_capture"][0], "nebula_tpu/tpu/hop.py:535")
ROUTE_SOURCES["mark (match)"] = (ROUTE_SOURCES["mark"][0],
                                 "nebula_tpu/tpu/hop.py:553")
# the BFS expands the reverse blocks at its bottom-up levels
# (algo/frontier.py:bottom_up_step), its widest call timed in phase 6c
ROUTE_SOURCES["expand (bfs)"] = (ROUTE_SOURCES["expand"][0],
                                 "nebula_tpu/algo/frontier.py:110")
# the sharded mesh (phase 10) runs the hop kernels once a slot, on one
# part's row with the part offset (parts = 8, pid = p): the reference's
# sharded programs, its delta merge at :382-389
for _k in ("expand", "mark", "predicate_mask", "compact_capture"):
    ROUTE_SOURCES[_k + " (mesh)"] = (ROUTE_SOURCES[_k][0],
                                     "nebula_tpu/tpu/hop.py:653")
ROUTE_SOURCES["merge_delta (mesh)"] = (ROUTE_SOURCES["merge_delta"][0],
                                       "nebula_tpu/tpu/hop.py:382")
# the algo path: each algorithm's parameters and its step kernel
ALGO_RUNS = {"pagerank": ({"max_iter": 20, "tol": 0.0}, "pagerank_step"),
             "wcc": ({}, "wcc_step"),
             "sssp": ({"src": 0, "weight": "w"}, "sssp_step")}
RELAX_RUNS = ("wcc", "sssp")      # the algorithms of csrc/relax.cu
COLD_PARTS = ("pagerank",)        # [5a] runs whose cold host parts are timed
SUITE_PERSONS = 50_000            # [5b] algo_bench's persons, at most
# phase 5d: a social graph with more vertices than the staged route's
# shared memory holds as bits (1,859,584), so that WCC and SSSP run the
# global route: make_social_arrays(GLOBAL_PERSONS, GLOBAL_DEGREE) in 8
# parts
GLOBAL_PERSONS = 2_000_000
GLOBAL_DEGREE = 4
GLOBAL_SEED = 13
PAGERANK_RUN_TOL = 1e-8          # the reference's rank parity bar
PAGERANK_STEP_TOL = 1e-12
# kernels each path must launch
UNSPLIT_KERNELS = ("expand", "mark", "predicate_mask", "compact_capture")
HUB_ROUTE = "expand (hub owners)"   # K8 folded into expand's scan
SPLIT_KERNELS = UNSPLIT_KERNELS + (HUB_ROUTE,)
BFS_KERNELS = ("expand", "mark", "bfs_probe", "bfs_level")
BFS_STEPS = 5                    # bench.py config 5: rt.bfs(..., "out", 5)
BFS_RUNS = 4                     # one cold run, then the timed warm runs
DELTA_CAP = 8192                 # GpuRuntime(delta_max_edges=...), phase 7
DELTA_REPEATS = 1                # phase 7's timed GO runs a query and state
# phase 7's write batch: inserts (those from the seeds), deletes, and
# overwrites of w (each a tombstone plus an insert)
WRITES = {"insert": 24_000, "seed_insert": 1_000, "delete": 8_000,
          "overwrite": 8_000}
DELTA_GO_KERNELS = ("expand", "merge_delta", "mark", "predicate_mask",
                    "compact_capture")
DELTA_BFS_KERNELS = ("expand", "merge_delta", "mark", "bfs_level")
BATCH_WAIT_US = 300_000          # phase 8's and 9c's forming window
BATCH_JOIN_S = 600               # every batched thread joins within this
# phase 9a: bench.py config 4b (bench.py:726-765), MATCH *1..4 from the
# first 1,792 persons with out-degree >= 3 of a 150,000-person graph
MATCH_PERSONS = 150_000
MATCH_DEGREE = 6
MATCH_GRAPH_SEED = 11
MATCH_SEEDS = 1_792
MATCH_HOPS = 4
MESH_SLOTS = 8                   # phase 10: make_mesh(8), every slot on
#                                  the one card
MESH_RUNS = 2                    # phase 10's timed runs of a query
MESH_KERNELS = ("pack_bits", "unpack_or")
MESH_HUB_KERNELS = ("owned_hub_bits", "fill_hub_columns")
GRID_LANES, GRID_PARTS = 2, 4    # phase 10h: make_mesh2(2, 4) on one card
GRID_RUNS = 5                    # phase 10h's timed rounds of its GO
# phase 11: DATE, DATETIME, TIME and GEOGRAPHY edge columns on the north
# star's recipe at TEMPORAL_PERSONS persons, derived from each edge's f by
# a fixed rule (temporal_words)
TEMPORAL_PERSONS = 100_000
TEMPORAL_TYPES = {"d": "DATE", "d2": "DATE", "t": "DATETIME", "tm": "TIME",
                  "g": "GEOGRAPHY"}
TEMPORAL_YIELDS = ("d", "t", "tm", "g")    # the port's _MAX_YIELD_COLS
TEMPORAL_POINTS = 1_000          # distinct WKT strings of g
TEMPORAL_NULL_EVERY = 50         # about one value in 50 of each column
TEMPORAL_INSERTS = 1_000         # 11c's write batch, each from a seed
TEMPORAL_RUNS = 1                # timed runs a query, after one warm-up
TEMPORAL_SEEDS = 64              # 11b's GO 1 STEP and traverse_hops seeds
TEMPORAL_SAMPLE = 2_000          # frame entries a hop decoded in 11b
DAY_US = 86_400_000_000
ROUTE_SOURCES["predicate_mask (temporal)"] = (
    ROUTE_SOURCES["predicate_mask"][0], "nebula_tpu/tpu/exprjit.py:201")
# phase 12: the store path at a third of bench.py config 4b's store-backed
# size (bench.py:727-733: make_social_graph(150_000, 6, parts=8,
# seed=11)), cut for the script's time limit
STORE_PERSONS = 50_000
STORE_DEGREE = 6
STORE_GRAPH_SEED = 11
STORE_SPACE = "twb"
STORE_SEEDS = 16                 # pick_seeds(..., min_degree=3)
STORE_CHECKED = 1_000            # vertices whose rows 12a walks
STORE_SPLIT = 64                 # 12b's degree_split_threshold
STORE_DELTA_CAP = 2048           # 12c's delta_max_edges
# 12c's write batch through the store's API (LDBC SNB IU8 and DEL8):
# edge inserts (some from the seeds), deletes, overwrites of w, and
# persons inserted into the vmax slack, each with an edge from a seed
STORE_WRITES = {"insert": 6_000, "seed_insert": 500, "delete": 2_000,
                "overwrite": 2_000, "vertex": 64}
STORE_OVERFLOW = 2_100           # 12d: inserts from part 0's sources
STORE_REBUILD_PERSONS = 20_000   # 12d's own store for the two rebuilds
STORE_COMPACT_WM = 0.25          # 12d: the watermark the compaction crosses
STORE_COMPACT_WRITES = 100       # inserts from part 0's sources, on 12c's
#                                  writes (a fill of 0.73): folded in place
# phase 13: nGQL through the port's QueryEngine on phase 12's store
ENGINE_RUNS = 2                  # timed runs a statement, after one warm-up
ENGINE_HOST_RUNS = 2             # the host engine's timed runs
ENGINE_INSERTS = 700             # 13c: INSERT EDGE rows from the seeds
ENGINE_INSERT_BATCH = 100        # rows an INSERT statement
ENGINE_DELETES = 200             # 13c: DELETE EDGE keys, 100 a statement
ENGINE_UPDATES = 100             # 13c: UPDATE EDGE statements, one edge each
ENGINE_RANK = 5                  # 13c's inserts' rank: no edge of phase 12's
ENGINE_WATERMARK = 0.75          # GpuRuntime's default compaction watermark
ENGINE_KERNELS = ("expand", "mark", "compact_capture")
# phase 14: MATCH, FIND PATH, GET SUBGRAPH and CALL algo.* through the
# engine, on phase 12's store as phase 13 left it
MATCH_ENGINE_RUNS = 1            # timed runs a statement, after one warm-up
C4B_RUNS = 3                     # 14c's timed runs: config 4b's p50 of 3
C4B_HOPS = 4                     # config 4b's *1..4 (bench.py:744)
PATH_SRCS = 4                    # 14d's and 14e's sources: phase 12's seeds
PATH_DSTS = 16                   # their destinations: half two hops out
SHORTEST_UPTO = 6
ALL_PATH_UPTO = 3
SUBGRAPH_STEPS = 2
#: 14f's algorithms: (func, params); sssp's src is phase 12's first seed
ALGO_CALLS = (("pagerank", {"max_iter": 20, "tol": 0.0}), ("wcc", {}),
              ("sssp", {"weight": "w"}))
ALGO_KERNELS = {"pagerank": "pagerank_step", "wcc": "wcc_step",
                "sssp": "sssp_step"}
# phase 15: LDBC IC5 and IC9 through the MATCH pipeline, bench.py:786-830
IC_PERSONS = 6_000               # bench.py's NEBULA_BENCH_IC_PERSONS default
IC_PARTS = 8
IC_SPACE = "ic"
IC_ROOT, IC_MIN_DATE, IC_MAX_DATE = 5, 17_000, 19_000
IC_SPLIT = 64                    # the split runtime's threshold, as 12b's
IC_RUNS = 2                      # timed runs a statement, after one warm-up
IC_POSTS = 96                    # 15c: new Posts by the root's friends
IC_UNJOIN = 48                   # 15c: HAS_MEMBER edges deleted
IC_RETITLE = 4                   # 15c: Forum titles rewritten
IC_KERNELS = ("expand", "mark", "compact_capture")
# phase 16: the cluster plane, at bench.py's concurrency size
# (bench.py:946-990)
CONC_PERSONS = 2_000
CONC_DEGREE = 6
CONC_SEED = 29
CONC_BATCH = 400                 # rows an INSERT, as bench.py writes them
CONC_THREADS = 64
CONC_REPS = 6                    # statements a thread
CONC_JOIN_S = 600                # every client thread joins within this
CONC_SPACE = "conc"
CONC_DELTA_CAP = 8192            # the graphd's GpuRuntime(delta_max_edges=)
CONC_PLANE_SEEDS = 4             # 16c's seeds
CONC_KERNELS = ("expand", "mark", "compact_capture")     # K1, K6, K3
# the phase's Raft timing.  Every daemon of the LocalCluster shares one
# interpreter with the 64 client threads, so a heartbeat round trip
# takes up to ~0.4 s there (0.15 s at p99), and the default 150-300 ms
# election timeout breaks Raft's broadcast-time << election-timeout
# rule: split votes repeat for seconds and a statement's replica walk
# runs out.  Seconds, as an upstream deployment sets them, restore it.
CONC_RAFT_MS = {"raft_election_timeout_ms": 2_000.0,
                "raft_heartbeat_interval_ms": 200.0}
CONC_LEADER_WAIT_S = 60          # every part of the space elects within this
PLANE_KERNELS = ("expand", "mark", "compact_capture", "predicate_mask")
PHASE16_KERNELS = PLANE_KERNELS + ("merge_delta",)       # K1-K4, K6, K9
#: the reference's device plan of each statement (its EXPLAIN through
#: `canon_plan`, nebula_tpu/tpu/pipeline.py's rule) and the sha256 of its
#: segment program's canonical repr, on make_snb_interactive at any size
#: (tests/test_torch_pipeline.py holds both to the reference's engine)
IC_PLANS = {
    "IC5": ("TpuMatchPipeline#0 {space='ic', ops=[{'op': 'seed', 'vids': "
            "[5], 'alias': 'person', 'out': 0}, {'op': 'vpred', 'in': 0, "
            "'alias': 'person', 'pred': _hastag(person, \"Person\"), "
            "'out': 1}, {…+2762ch, n_chains=4, fallback=<subplan TopN#1>} "
            "-> ['forumName', 'postCount']"),
    "IC9": ("TpuMatchPipeline#0 {space='ic', ops=[{'op': 'seed', 'vids': "
            "[5], 'alias': 'root', 'out': 0}, {'op': 'vpred', 'in': 0, "
            "'alias': 'root', 'pred': _hastag(root, \"Person\"), 'out': "
            "1}, {'op': …+1447ch, n_chains=2, fallback=<subplan TopN#1>} -> "
            "['fid', 'mid', 'd']"),
}
IC_PROGRAMS = {
    "IC5": "bfddc0ac3205bd0da1b09e553fa2556952eb78bc4cd8ccd95e4dd5f062f23cf5",
    "IC9": "398d216798a4382b50f35195d05029b66aa913e8d9bddde16dc7122a2ce92608",
}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(phase: str) -> None:
    log(f"[t] {phase} starts at {time.perf_counter() - T0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, by CUDA events,
    after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_fresh(fn, reset, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls, by one pair of
    CUDA events around each call, with reset() run before each call (and
    before one warm call) outside the timed span.  A spin kernel of about
    10 ms holds the stream while the host queues every call, so that no
    host launch gap falls inside a span."""
    import torch
    reset()
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(20_000_000)
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over tensors that must be identical; also
    raises unless they are equal bit for bit."""
    import torch
    err = 0.0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if a.dtype == torch.float64:
            both_nan = a.isnan() & b.isnan()
            d = torch.where(both_nan, 0.0, (a - b).abs())
            bits_equal = torch.equal(a.view(torch.int64),
                                     b.view(torch.int64))
        else:
            d = (a.long() - b.long()).abs()
            bits_equal = torch.equal(a, b)
        if d.numel():
            err = max(err, float(d.max()))
        if not bits_equal:
            raise AssertionError(f"kernel differs from plain version "
                                 f"(max abs err {err})")
    return err


def pagerank_step_err(label, a, got, want) -> float:
    """Hold one PageRank step of the kernel (`got`) against its plain
    version (`want`) on inputs `a`; returns the max |Δ| of rank and L1
    delta.  Raises when that passes PAGERANK_STEP_TOL or the moved counts
    disagree.  The kernel's count must equal `|new - rank| > tol` over
    its own ranks exactly.  The two counts are compared vertex by vertex:
    they must agree on every vertex except one whose plain change lies
    within that vertex's |Δrank| of tol, where the two summation orders'
    rounding may fall on either side (the plain version adds with float
    atomics, in an order that varies from run to run)."""
    rank, tol = a[0], a[8]
    err = max(float((got[0] - want[0]).abs().max()),
              abs(float(got[1]) - float(want[1])))
    mk = (got[0] - rank).abs() > tol
    mp_change = (want[0] - rank).abs()
    split = (mk != (mp_change > tol)) & (
        (mp_change - tol).abs() > (got[0] - want[0]).abs())
    if (err > PAGERANK_STEP_TOL or int(got[2]) != int(mk.sum())
            or int(want[2]) != int((mp_change > tol).sum())
            or bool(split.any())):
        raise AssertionError(
            f"pagerank_step at {label}: max |Δ| {err}, moved {int(got[2])} "
            f"(own ranks {int(mk.sum())}) vs {int(want[2])}, "
            f"{int(split.sum())} vertices counted apart beyond rounding")
    return err


def bound(bytes_moved: float, ops: float, ops_per_s=INT32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counts(K) -> dict:
    """Every wrapper's launches and every route's ({"expand (hub owners)":
    n, ...}), as the counters stand."""
    return {**K.launch_counts(), **K.route_launch_counts()}


def kernel_launches(launches: dict) -> int:
    """The launches of a `counts` dict, each kernel once (its routes'
    counts, named "kernel (route)", are parts of its own)."""
    return sum(v for k, v in launches.items() if "(" not in k)


def check_hub_route(launches: dict, label: str, split: bool) -> None:
    """On a single-device path of a degree-split snapshot every expand
    reads the hub bits from their owners' rows (the "hub owners" route)
    and no hub-column pass runs (K8 has no kernel; K16's pair is the
    mesh's); an unsplit path never takes the route."""
    owners = launches[HUB_ROUTE]
    hub_passes = launches["owned_hub_bits"] + launches["fill_hub_columns"]
    if (owners != (launches["expand"] if split else 0) or hub_passes
            or (split and owners <= 0)):
        raise AssertionError(f"{label}: {owners} owner-route expands of "
                             f"{launches['expand']}, {hub_passes} "
                             f"hub-column passes")


def lib_expand_for(blk, f, hubs=None):
    """One library formulation of expand over bitmap (or lane stack) f:
    repeat_interleave of the active rows over their degrees; a lane
    stack's row q reads CSR row q mod P.  With `hubs` = (hub_owner,
    hub_local) the hub bits are first gathered from their owners' rows
    into the tail columns of a private copy of f (one gather and one
    broadcast assignment, as extend_hubs_plain does)."""
    import torch
    if hubs is not None:
        f = f.clone()
        own, loc = (t.long() for t in hubs)
        vloc = f.shape[-1] - own.numel()

    def lib_expand():
        if hubs is not None:
            f[..., vloc:] = f[..., own, loc][..., None, :]
        rows = f.reshape(-1).nonzero().view(-1)
        nrows = f.shape[-1]
        p, r = (rows // nrows) % blk.indptr.shape[0], rows % nrows
        beg = blk.indptr[p, r].long()
        deg = blk.indptr[p, r + 1].long() - beg
        slot_row = torch.repeat_interleave(torch.arange(
            rows.numel(), device=f.device), deg)
        off = torch.arange(slot_row.numel(), device=f.device) \
            - torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
        e = beg[slot_row] + off
        return blk.nbr[p[slot_row], e], blk.rank[p[slot_row], e]
    return lib_expand


def zero_tail(f, vmax: int):
    """A copy of frontier buffer (or lane stack) f with its hub columns
    cleared, as the single-device loops leave them."""
    g = f.clone()
    g[..., vmax:] = False
    return g


def run_go(rt, ns, repeats: int, label: str, K, oracle, keep_rows=None,
           space: str = "ns"):
    """Drive the GO path of `rt` (unfiltered and filtered) on `space`,
    each query checked against the oracle (host_csr_traverse on ns.snap,
    computed once a filter and kept in `oracle` for the next layout);
    returns (results, launches).  `keep_rows`, a dict, gets each
    filter's last rows and stats."""
    import numpy as np
    import torch
    from nebula_tpu_torch.bench.datagen import host_csr_traverse

    results = {}
    K.reset_launch_counts()
    for flabel, filt, w_gt in (("unfiltered", None, None),
                               (f"w>{ns.w_gt}", ns.w_filter, ns.w_gt)):
        lat, dev_lat = [], []
        for _ in range(repeats + 1):           # the first run is warm-up
            t = time.perf_counter()
            rows, st = rt.traverse(ns.store, space, ns.seeds, ["KNOWS"],
                                   "out", 3, edge_filter=filt,
                                   yields=ns.yields)
            lat.append(time.perf_counter() - t)
            dev_lat.append(st.device_s)
        if w_gt not in oracle:             # both layouts share the graph
            oracle[w_gt] = host_csr_traverse(ns.snap, ns.seeds, 3,
                                             w_gt=w_gt, materialize=True)
        total, kept, want_d, want_w = oracle[w_gt]
        if st.edges_traversed() != total or len(rows) != kept:
            raise AssertionError(f"{label} {flabel}: edges "
                                 f"{st.edges_traversed()} vs {total}, rows "
                                 f"{len(rows)} vs {kept}")
        d = np.asarray(rows.column_array("d"), np.int64)
        w = np.asarray(rows.column_array("w"), np.int64)
        if not same_multiset([d, w], [want_d, want_w]):
            raise AssertionError(f"{label} {flabel}: rows differ from the "
                                 f"oracle")
        if keep_rows is not None:
            keep_rows[flabel] = (rows, st)
        p50 = float(np.median(lat[1:]))
        results[flabel] = {
            "rows": len(rows), "edges": total,
            "hop_edges": st.hop_edges, "frontier_sizes": st.frontier_sizes,
            "e_cap": st.e_cap, "p50_ms": p50 * 1e3,
            "min_ms": min(lat[1:]) * 1e3, "max_ms": max(lat[1:]) * 1e3,
            "device_p50_ms": float(np.median(dev_lat[1:])) * 1e3,
            "fetch_ms": st.fetch_s * 1e3, "mat_ms": st.mat_s * 1e3,
            "edges_per_s": total / p50, "samples": len(lat) - 1}
        log(f"    GO 3 STEPS {label} {flabel}: "
            f"{json.dumps(results[flabel])}")
    torch.cuda.synchronize()
    launches = counts(K)
    log(f"    {label} launches over {2 * (repeats + 1)} queries: "
        f"{launches}")
    return results, launches


def run_algo(rt, ns, K, AE, AK):
    """Phase 5a: PageRank, WCC and SSSP through run_algorithm on the
    north-star snapshot, launch counts against iterations, then the same
    iterations through the plain steps on the card (state compared) and
    PageRank twice (bit-identical).  Returns (results, launch counts);
    each result carries the step inputs of its first and middle
    iteration for phase 5c."""
    import numpy as np
    import torch
    snap, sd = ns.snap, ns.store.space("ns")
    res = {}
    K.reset_launch_counts()
    for func, (params, _k) in ALGO_RUNS.items():
        us = []
        t = time.perf_counter()
        rows, info = AE.run_algorithm(func, {**params, "mode": "device"},
                                      snap, sd, rt=rt, iter_us=us)
        e2e = time.perf_counter() - t
        vals = np.asarray([r[1] for r in rows], np.float64)
        if func == "pagerank":
            ok = (len(rows) == info["n_vertices"] and np.isfinite(vals).all()
                  and abs(vals.sum() - 1.0) < 1e-6)
        elif func == "wcc":
            ok = len(rows) == info["n_vertices"] and (vals >= 0).all()
        else:
            ok = (0 < len(rows) <= info["n_vertices"] and rows[0][1] == 0.0
                  and np.isfinite(vals).all() and (vals >= 0).all())
        if not ok:
            raise AssertionError(f"algo.{func}: malformed rows")
        res[func] = {"iterations": info["iterations"],
                     "iter_ms_p50": float(np.median(us)) / 1e3,
                     "iter_ms": [u / 1e3 for u in us],
                     "e2e_cold_s": e2e, "rows": len(rows),
                     "n_edges": info["n_edges"],
                     "n_vertices": info["n_vertices"]}
        if func == "wcc":
            res[func]["components"] = len({r[1] for r in rows})
    torch.cuda.synchronize()
    launches = {**K.launch_counts(), **K.route_launch_counts()}
    route = AK.relax_route(snap.num_parts * snap.vmax)
    for func, (params, kname) in ALGO_RUNS.items():
        names = [kname] + ([f"{kname} ({route})"] if func in RELAX_RUNS
                           else [])
        for name in names:
            if launches[name] <= 0 \
                    or launches[name] != res[func]["iterations"]:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times in {res[func]['iterations']} "
                                     f"iterations")
    loops = {"pagerank": AE._device_pagerank, "wcc": AE._device_wcc,
               "sssp": AE._device_sssp}
    for func, (params, kname) in ALGO_RUNS.items():
        p, keys, g, src = AE.prepare(func, {**params, "mode": "device"},
                                     snap, sd)
        extra = (src,) if func == "sssp" else ()
        calls = []

        def plain(*a, fn=getattr(AK, kname + "_plain")):
            calls.append(a)
            return fn(*a)

        t = time.perf_counter()
        state_k, it_k = loops[func](rt, snap, keys, g, p, None, *extra)
        warm = time.perf_counter() - t
        state_p, it_p = loops[func](rt, snap, keys, g, p, None, *extra,
                                      step=plain)
        if it_k != it_p or it_k != res[func]["iterations"]:
            raise AssertionError(f"algo.{func}: iterations {it_k} (kernel) "
                                 f"vs {it_p} (plain)")
        if func == "pagerank":
            diff = float(np.abs(state_k - state_p).max())
            again, _ = loops[func](rt, snap, keys, g, p, None)
            if not np.array_equal(again.view(np.int64),
                                  state_k.view(np.int64)):
                raise AssertionError("two PageRank runs differ")
            if diff > PAGERANK_RUN_TOL:
                raise AssertionError(f"PageRank kernel vs plain: {diff}")
            res[func]["max_abs_diff_vs_plain"] = diff
            res[func]["bit_identical_rerun"] = True
        elif not np.array_equal(state_k.view(np.int64),
                                state_p.view(np.int64)):
            raise AssertionError(f"algo.{func}: kernel state differs from "
                                 f"the plain steps'")
        res[func]["e2e_warm_s"] = warm
        if func in COLD_PARTS:
            res[func].update(cold_parts(AE, rt, snap, sd, func, params, g,
                                        state_k))
        mid = it_k // 2 + 1
        log(f"[5a] algo.{func}: {json.dumps(res[func])}")
        res[func]["check_args"] = [(1, calls[0])] + (
            [(mid, calls[mid - 1])] if mid > 1 else [])
        if func in RELAX_RUNS:
            res[func]["all_args"] = calls
    return res, launches


def run_algo_global(rt, K, AE, AK):
    """Phase 5d: WCC and SSSP through run_algorithm on a graph past the
    staged route's capacity (GLOBAL_PERSONS persons in 8 parts, so every
    step takes csrc/relax.cu's global route), launch counters zeroed
    just before and read just after: each step's launches, all on the
    global route, must equal the iterations run; the same iterations
    through the plain steps must give the same state bit for bit.  The
    algo caches are restored after.  Returns (results, launch counts,
    {func: the middle iteration's step inputs}, the snapshot, which
    phase 6d's BFS reuses)."""
    import numpy as np
    import torch
    from nebula_tpu_torch.bench.datagen import (
        SnapshotStore, make_social_arrays, snapshot_from_arrays)
    t = time.perf_counter()
    arrs = make_social_arrays(GLOBAL_PERSONS, GLOBAL_DEGREE,
                              seed=GLOBAL_SEED)
    snap = snapshot_from_arrays(arrs, parts=8, space="g")
    sd = SnapshotStore(snap).space("g")
    n = snap.num_parts * snap.vmax
    res = {"persons": GLOBAL_PERSONS, "degree": GLOBAL_DEGREE,
           "n_slots": n, "route": AK.relax_route(n),
           "build_s": time.perf_counter() - t}
    if res["route"] != "global":
        raise AssertionError(f"[5d] {n} slots take the {res['route']} "
                             f"route")
    caches = (AE._graph_cache, AE._dev_cache)
    saved = [dict(c) for c in caches]
    mids = {}
    try:
        K.reset_launch_counts()
        for func in RELAX_RUNS:
            params, kname = ALGO_RUNS[func]
            us = []
            t = time.perf_counter()
            rows, info = AE.run_algorithm(func, {**params, "mode": "device"},
                                          snap, sd, rt=rt, iter_us=us)
            res[func] = {"iterations": info["iterations"],
                         "iter_ms_p50": float(np.median(us)) / 1e3,
                         "e2e_cold_s": time.perf_counter() - t,
                         "rows": len(rows), "n_edges": info["n_edges"]}
            if not rows or len(rows) > info["n_vertices"]:
                raise AssertionError(f"[5d] algo.{func}: malformed rows")
        torch.cuda.synchronize()
        launches = {**K.launch_counts(), **K.route_launch_counts()}
        loops = {"wcc": AE._device_wcc, "sssp": AE._device_sssp}
        for func in RELAX_RUNS:
            params, kname = ALGO_RUNS[func]
            it = res[func]["iterations"]
            if (launches[kname] != it or launches[f"{kname} (global)"] != it
                    or launches[f"{kname} (staged)"] != 0):
                raise AssertionError(f"[5d] {kname}: {launches} in {it} "
                                     f"iterations")
            p, keys, g, src = AE.prepare(func, {**params, "mode": "device"},
                                         snap, sd)
            extra = (src,) if func == "sssp" else ()
            calls = []

            def plain(*a, fn=getattr(AK, kname + "_plain")):
                calls.append(a)
                return fn(*a)

            state_k, _ = loops[func](rt, snap, keys, g, p, None, *extra)
            state_p, it_p = loops[func](rt, snap, keys, g, p, None, *extra,
                                        step=plain)
            if it_p != it or not np.array_equal(state_k.view(np.int64),
                                                state_p.view(np.int64)):
                raise AssertionError(f"[5d] algo.{func}: kernel state "
                                     f"differs from the plain steps'")
            mid = it // 2 + 1
            mids[func] = (mid, calls[mid - 1])
            log(f"[5d] algo.{func} past the staged capacity: "
                f"{json.dumps(res[func])}")
    finally:
        for c, old in zip(caches, saved):
            c.clear()
            c.update(old)
    graph = {k: v for k, v in res.items() if k not in RELAX_RUNS}
    log(f"[5d] graph: {json.dumps(graph)}")
    return res, launches, mids, snap


def relax_timings(AK, func, kname, mid, mid_args, every, row, reps):
    """[5c] beside a relax row (`row`, timed at iteration `mid`): each
    route forced at that iteration's inputs, held bit for bit against the
    plain version and timed (`relax paths`); the step at every
    iteration's inputs of the [5a] run, each held against the plain
    version, timed through the wrapper's choice and summed beside the
    summed bounds (`whole run`: launches x ms measured, not
    extrapolated); for WCC the gather floor, one label.index_select over
    esrc at the middle iteration's shape (a yardstick the port never
    calls; its own bytes are the indices and the output)."""
    kern, plain = getattr(AK, kname), getattr(AK, kname + "_plain")
    want = plain(*mid_args)
    paths = {}
    for route in AK.RELAX_ROUTES:
        max_abs_err(kern(*mid_args, route=route), want)
        paths[route + "_ms"] = cuda_ms(
            lambda r=route: kern(*mid_args, route=r), reps)
    paths["chosen"] = AK.relax_route(mid_args[0].numel())
    log(f"[5c] relax paths ({kname}, {func} iteration {mid}): "
        f"{json.dumps(paths)}")
    per, bounds, active = [], [], []
    for a in every:
        max_abs_err(kern(*a), plain(*a))
        per.append(cuda_ms(lambda a=a: kern(*a), reps))
        nbytes, ops, rate, _ = algo_work(kname, a)
        bounds.append(bound(nbytes, ops, rate)[0])
        active.append(int(a[1].sum()))
    run = {"iterations": len(every), "sum_ms": sum(per),
           "bound_sum_ms": sum(bounds), "ms": per, "bound_ms": bounds,
           "frontier": active}
    log(f"[5c] {kname} whole run ({func}, every iteration's inputs): "
        f"{json.dumps(run)}")
    if kname == "wcc_step":
        label, idx = mid_args[0], mid_args[2].long()
        floor = {"ms": cuda_ms(lambda: label.index_select(0, idx), reps),
                 "bound_ms": bound(16 * idx.numel() + 8 * label.numel(),
                                   0)[0],
                 "kernel_ms": row["ms"], "kernel_bound_ms": row["bound_ms"]}
        log(f"[5c] wcc_step gather floor (label.index_select(0, "
            f"esrc.long()), {idx.numel()} edges): {json.dumps(floor)}")


def cold_parts(AE, rt, snap, sd, func, params, g, state):
    """Where a cold run's host time goes: rows from the final state,
    then, with the algo caches emptied (and restored after, so later
    runs stay warm), the flat graph, its destination sort and the
    upload, each timed alone (seconds)."""
    import torch
    t = time.perf_counter()
    AE.assemble_rows(func, g, state)
    out = {"rows_s": time.perf_counter() - t}
    caches = (AE._graph_cache, AE._dev_cache)
    saved = [dict(c) for c in caches]
    for c in caches:
        c.clear()
    try:
        t = time.perf_counter()
        p, keys, g2, _ = AE.prepare(func, {**params, "mode": "device"},
                                    snap, sd)
        out["graph_s"] = time.perf_counter() - t
        t = time.perf_counter()
        g2.by_dst()
        out["sort_s"] = time.perf_counter() - t
        t = time.perf_counter()
        AE._device_edges(rt, snap, keys, p.get("weight"), g2)
        torch.cuda.synchronize()
        out["upload_s"] = time.perf_counter() - t
    finally:
        for c, old in zip(caches, saved):
            c.clear()
            c.update(old)
    return out


def run_algo_suite(rt, persons: int):
    """Phase 5b: the port's algo_bench at bench.py's algo degree on
    `persons` persons; rows must equal the numpy oracles'."""
    from nebula_tpu_torch.tools.algo_bench import run_suite
    t = time.perf_counter()
    suite = run_suite(persons=persons, degree=30, parts=8, repeats=1,
                      runtime=rt)
    suite["wall_s"] = time.perf_counter() - t
    log(f"[5b] algo_bench: {json.dumps(suite)}")
    for func in ALGO_RUNS:
        if not suite[func]["rows_match"]:
            raise AssertionError(f"algo_bench {func}: rows differ from the "
                                 f"oracle")
    return suite


def algo_work(kname: str, a):
    """(bytes, operations, operation rate, library call) of one step on
    inputs `a`: each input read once and each output written once; for
    WCC and SSSP the edges whose source is masked off need their esrc
    only (their kernel reads no more of them)."""
    import torch
    if kname == "pagerank_step":
        rank, esrc, starts, out_inv_e, dmask, vmask = a[:6]
        n, E = rank.numel(), esrc.numel()
        contrib = rank[esrc.long()] * out_inv_e
        dst = torch.repeat_interleave(
            torch.arange(n, device=rank.device), starts[1:] - starts[:-1])

        def lib():
            return torch.zeros_like(rank).index_add_(0, dst, contrib)
        return (12 * E + (8 + 8 + 1 + 1 + 8) * n + 8 + 16, 2 * E + 6 * n,
                FP64_OPS_PER_S, lib)
    val, mask, esrc, edst = a[:4]
    w = a[4] if len(a) > 4 else None
    n, E = val.numel(), esrc.numel()
    s = esrc.long()
    active_e = int(mask[s].sum())
    sentinel = (1 << 63) - 1 if kname == "wcc_step" else float("inf")
    inc = 1.0 if kname == "sssp_step" and w is None else w
    send = torch.where(mask[s], val[s] if inc is None else val[s] + inc,
                       sentinel)
    d = edst.long()

    def lib():
        return val.clone().scatter_reduce_(0, d, send, "amin",
                                           include_self=True)
    per_edge = 4 + (8 if w is not None else 0)
    rate = FP64_OPS_PER_S if kname == "sssp_step" else INT32_OPS_PER_S
    return (4 * E + per_edge * active_e + 2 * (8 + 1) * n + 8, active_e,
            rate, lib)


def host_bfs_where(snap, src_dense, steps: int, w_gt: int):
    """Numpy level-synchronous BFS over the KNOWS out-edges with w > w_gt:
    the oracle of the filtered device BFS (host_bfs with the edge mask)."""
    import numpy as np
    P = snap.num_parts
    blk = snap.block("KNOWS", "out")
    dist = np.full(len(snap.dense_to_vid), -1, np.int32)
    fr = np.unique(np.asarray(src_dense, np.int64))
    dist[fr] = 0
    for hop in range(1, steps + 1):
        owner, local = fr % P, fr // P
        s = blk.indptr[owner, local].astype(np.int64)
        deg = blk.indptr[owner, local + 1].astype(np.int64) - s
        rows = np.repeat(np.arange(fr.size), deg)
        idx = s[rows] + np.arange(int(deg.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(deg) - deg, deg)
        kept = blk.props["w"][owner[rows], idx] > w_gt
        nxt = np.unique(blk.nbr[owner[rows], idx][kept].astype(np.int64))
        fr = nxt[dist[nxt] < 0]
        dist[fr] = hop
    return dist


def bfs_branches(dist, steps: int):
    """The levels the reference's switch (tpu/bfs.py:159) sends
    bottom-up, derived from a dense-id depth array: the frontier entering
    level L is dist == L-1, the unvisited set dist < 0 or dist >= L (the
    switch subtracts the padding slots, which a dense-id array lacks)."""
    return [int((dist == level - 1).sum()) * 8
            > int(((dist < 0) | (dist >= level)).sum())
            for level in range(1, steps + 1)]


def bfs_level_edges(snap, dist, steps: int, switch: bool = True):
    """The pre-filter slots each level of the direction-optimizing BFS
    expands, from a dense-id depth array and the unsplit snapshot's
    degrees: the frontier's out-degrees on a top-down level, the
    unvisited vertices' in-degrees on a bottom-up one.  switch=False:
    every level top-down (the sharded BFS)."""
    import numpy as np
    P = snap.num_parts
    vv = np.arange(len(snap.dense_to_vid))

    def degrees(direction):
        ip = snap.block("KNOWS", direction).indptr
        return (ip[:, 1:] - ip[:, :-1])[vv % P, vv // P].astype(np.int64)

    out_deg, in_deg = degrees("out"), degrees("in")
    edges = []
    branches = bfs_branches(dist, steps) if switch else [False] * steps
    for level, bu in enumerate(branches, 1):
        front = dist == level - 1
        if not front.any():
            edges.append(0)
        elif bu:
            edges.append(int(in_deg[(dist < 0) | (dist >= level)].sum()))
        else:
            edges.append(int(out_deg[front].sum()))
    return edges


def halve_parts(snap):
    """`snap` (laid out by snapshot_from_arrays: dense id = vid, owner =
    vid % P) at P / 2 parts, equal to snapshot_from_arrays(arrs, P / 2)
    of the same arrays (edge blocks only) without its two argsorts:
    row r of part q holds vid r * P/2 + q, which is row r // 2 of part
    q + P/2 * (r % 2) here, and each row keeps its edges in order."""
    import copy

    import numpy as np
    from nebula_tpu_torch.graphstore.csr import CsrBlock, CsrSnapshot
    P = snap.num_parts
    if P % 2 or snap.hub_dense is not None:
        raise ValueError("halve_parts: an even, unsplit layout")
    Q, n = P // 2, len(snap.dense_to_vid)
    counts = np.bincount(np.arange(n, dtype=np.int64) % Q, minlength=Q)
    vmax = max(int(counts.max()), 1)
    r = np.arange(vmax, dtype=np.int64)
    src_part = (np.arange(Q)[:, None] + Q * (r % 2)[None, :]).ravel()
    src_row = np.broadcast_to(r // 2, (Q, vmax)).ravel()
    out = CsrSnapshot(space=snap.space, epoch=0, num_parts=Q, vmax=vmax,
                      num_vertices=counts.astype(np.int32),
                      pool=copy.deepcopy(snap.pool),
                      dense_to_vid=list(snap.dense_to_vid))
    for key, b in snap.blocks.items():
        start = b.indptr[src_part, src_row].astype(np.int64)
        deg = b.indptr[src_part, src_row + 1].astype(np.int64) - start
        indptr = np.zeros((Q, vmax + 1), np.int64)
        np.cumsum(deg.reshape(Q, vmax), axis=1, out=indptr[:, 1:])
        ends = indptr[:, -1]
        emax = max(int(ends.max()), 1)
        bounds = np.concatenate([[0], np.cumsum(ends)])
        # the flat index into snap's (P, emax) arrays of each edge, in
        # the halved layout's order (part-major, row by row)
        base = src_part * b.nbr.shape[1] + start - (np.cumsum(deg) - deg)
        flat = np.repeat(base, deg) + np.arange(int(bounds[-1]),
                                                dtype=np.int64)

        def lay(a, fill):
            got = a.reshape(-1).take(flat)
            dst = np.full((Q, emax), fill, a.dtype)
            for i in range(Q):
                dst[i, :ends[i]] = got[bounds[i]:bounds[i + 1]]
            return dst
        nbr = lay(b.nbr, -1)
        out.blocks[key] = CsrBlock(
            etype=b.etype, direction=b.direction,
            indptr=indptr.astype(b.indptr.dtype), nbr=nbr,
            rank=np.zeros_like(nbr),
            props={k: lay(v, np.nan if v.dtype.kind == "f" else -2)
                   for k, v in b.props.items()},
            prop_types=dict(b.prop_types))
    return out


def run_bfs_path(rt, ns, seed, label, K, filt=None, tag="[6a]",
                 space="ns"):
    """Drive GpuRuntime.bfs as bench.py config 5 does (one cold run, then
    warm runs) on ns.store's `space` (ns.snap its snapshot), launch
    counters zeroed just before and read just after (each route's too).
    Returns (dist as dense-id order, stats of the last run, results,
    launches)."""
    import numpy as np
    import torch
    P = ns.snap.num_parts
    vv = np.arange(len(ns.snap.dense_to_vid))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    lat, dev_lat = [], []
    for _ in range(BFS_RUNS):
        t = time.perf_counter()
        dist, st = rt.bfs(ns.store, space, [seed], ["KNOWS"], "out",
                          BFS_STEPS, edge_filter=filt)
        lat.append(time.perf_counter() - t)
        dev_lat.append(st.device_s)
    torch.cuda.synchronize()
    launches = {**K.launch_counts(), **K.route_launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    d = dist[vv % P, vv // P]
    res = {"hop_edges": st.hop_edges, "e_cap": st.e_cap,
           "edges_per_run": st.edges_traversed(),
           "reached": int((d >= 0).sum()),
           "per_level": [int((d == lv).sum())
                         for lv in range(BFS_STEPS + 1)],
           "p50_ms": float(np.median(lat[1:])) * 1e3,
           "min_ms": min(lat[1:]) * 1e3, "max_ms": max(lat[1:]) * 1e3,
           "cold_ms": lat[0] * 1e3,
           "device_p50_ms": float(np.median(dev_lat[1:])) * 1e3,
           "put_ms": st.put_s * 1e3, "max_memory_allocated": peak,
           "working_set_bytes": peak - base,
           "pinned_bytes": rt.hbm_bytes(), "samples": BFS_RUNS - 1,
           "launches_per_run": {k: v / BFS_RUNS for k, v in launches.items()
                                if v},
           "pack_bits_launches": launches["pack_bits"]}
    log(f"{tag} BFS {label}: {json.dumps(res)}")
    return d, st, res, launches


def check_probe_routes(launches, label, route) -> None:
    """A local BFS run's probes all took `route` (the main path's
    frontier fits a block's shared memory as bits; phase 6d's does
    not), and it packed no frontier with pack_bits: bfs_level wrote the
    probe's words."""
    other = next(r for r in ("staged", "global") if r != route)
    if (launches[f"bfs_probe ({route})"] != launches["bfs_probe"]
            or launches[f"bfs_probe ({other})"] != 0
            or launches["pack_bits"] != 0):
        raise AssertionError(f"BFS {label}: bfs_probe routes "
                             f"{launches['bfs_probe (staged)']} staged, "
                             f"{launches['bfs_probe (global)']} global, "
                             f"pack_bits {launches['pack_bits']}")


def strided_copy(v):
    """A copy of the (P, n) view v with v's row stride (the first n
    columns of a fresh (P, stride) buffer)."""
    import torch
    buf = torch.empty((v.shape[0], v.stride(0)), dtype=v.dtype,
                      device=v.device)
    buf[:, :v.shape[1]] = v
    return buf[:, :v.shape[1]]


def capture_bfs_calls(rt, store, space, seed, FR, GB, filt=None):
    """One more run of a BFS path with bfs_probe, bfs_level and expand
    wrapped to keep each call's inputs (the buffers they update in place
    copied with their row stride; bfs_probe's frontier words and
    bfs_level's counts row as the main path passes them), for phases 6c
    and 6d: probe calls are (src, nbr, keep, total, fbm, out, fbits),
    level calls (cand, dist, level, fbm_out, unvis_out, fbits_out or
    None)."""
    from nebula_tpu_torch.gpu import hop as GH
    calls = {"bfs_probe": [], "bfs_level": [], "expand": []}
    kernels = FR.bfs_probe, GB.bfs_level, GH.expand

    def expand(indptr, nbr, rank, fbm, *a, **kw):
        calls["expand"].append(((indptr, nbr, rank, fbm.clone(), *a), kw))
        return kernels[2](indptr, nbr, rank, fbm, *a, **kw)

    def probe(src, nbr, keep, total, fbm, out, fbits=None):
        calls["bfs_probe"].append((src, nbr, keep, total,
                                   strided_copy(fbm), strided_copy(out),
                                   fbits.clone()))
        return kernels[0](src, nbr, keep, total, fbm, out, fbits)

    def level(cand, dist, lv, fbm_out, unvis_out, fbits_out=None,
              counts=None):
        calls["bfs_level"].append((strided_copy(cand), dist.clone(), lv,
                                   strided_copy(fbm_out),
                                   strided_copy(unvis_out),
                                   None if fbits_out is None
                                   else fbits_out.clone()))
        return kernels[1](cand, dist, lv, fbm_out, unvis_out, fbits_out,
                          counts)

    FR.bfs_probe, GB.bfs_level, GH.expand = probe, level, expand
    try:
        rt.bfs(store, space, [seed], ["KNOWS"], "out", BFS_STEPS,
               edge_filter=filt)
    finally:
        FR.bfs_probe, GB.bfs_level, GH.expand = kernels
    return calls


def level_args(a):
    """Fresh outputs for a captured bfs_level call `a`: (cand, dist,
    level, fbm_out, unvis_out) with copies of what it writes, and the
    keyword arguments the main path passes (fbits_out where it gave one,
    a zeroed counts row)."""
    import torch
    kw = {"counts": torch.zeros((2,), dtype=torch.int64,
                                device=a[1].device)}
    if a[5] is not None:
        kw["fbits_out"] = torch.empty_like(a[5])
    return ((strided_copy(a[0]), a[1].clone(), a[2], strided_copy(a[3]),
             strided_copy(a[4])), kw)


def check_bfs_calls(K, calls) -> float:
    """Hold every captured bfs_probe call (kernel, reading the words)
    against the plain version reading the frontier's bitmap, and every
    bfs_level call against its plain version in every output; also that
    each probe's words equal pack_bits of its bitmap (the previous
    level's fbits_out).  Returns the max abs err (0; raises otherwise)."""
    import torch
    got, want = [], []
    for a in calls["bfs_probe"]:
        if not torch.equal(a[6], K.pack_bits_plain(a[4][None])[0]):
            raise AssertionError("bfs_level's words differ from pack_bits "
                                 "of its frontier")
        got.append(K.bfs_probe(*a[:5], strided_copy(a[5]), a[6]))
        want.append(K.bfs_probe_plain(*a[:5], strided_copy(a[5])))
    for a in calls["bfs_level"]:
        for out, fn in ((got, K.bfs_level), (want, K.bfs_level_plain)):
            la, kw = level_args(a)
            out.append(fn(*la, **kw))
            out.extend([la[0], la[1], la[3], la[4], *kw.values()])
    return max_abs_err(got, want)


def probe_measure(K, pa, reps, route=None):
    """A bfs_probe row's numbers at one captured call pa = (src, nbr,
    keep, total, fbm, out, fbits): the kernel (through `route`; None the
    wrapper's choice), its plain version and one library formulation
    (the frontier gather plus index_put_), timed with CUDA events; the
    bytes of its bound (nbr, and keep where given, of each valid slot,
    the frontier's words once, src of each slot whose neighbour is on
    the frontier, total, and a byte for each vertex it reaches; ops two
    a slot).  Also each route that fits forced at the same call, held
    bit for bit against the plain version (`probe paths`), and the
    gather floor: the frontier's bytes gathered at every valid slot's
    neighbour, one index_select over precomputed indices (a yardstick
    the port never calls: what the parent kernel's byte gathers cost)."""
    import torch
    src, nbr, keep, total, fbm, out0, fbits = pa
    P, EB = src.shape
    vmax = fbm.shape[1]
    nb = nbr.long()
    ok = (torch.arange(EB, device=src.device) < total[:, None]) \
        & (nb >= 0) & (nb < P * vmax)
    if keep is not None:
        ok &= keep
    nbl = torch.where(ok, nb, 0)
    members = int((ok & fbm[nbl % P, nbl // P]).sum())
    want = K.bfs_probe_plain(*pa[:5], strided_copy(out0))
    reached = int((want & ~out0).sum())
    out_t = strided_copy(out0)

    def lib_probe():
        sel = ok & fbm[nbl % P, nbl // P]
        sl = src[sel].long()
        out_t.index_put_((sl % P, sl // P),
                         torch.ones((), dtype=torch.bool, device=sl.device))
        return out_t

    slots = int(total.clamp(0, EB).sum())
    W = -(-vmax // 32)
    res = {"ms": cuda_ms(lambda: K.bfs_probe(*pa[:5], out_t, fbits,
                                             route=route), reps),
           "plain_ms": cuda_ms(lambda: K.bfs_probe_plain(*pa[:5], out_t),
                               reps),
           "lib_ms": cuda_ms(lib_probe, reps),
           "nbytes": (4 * slots + (slots if keep is not None else 0)
                      + 4 * P * W + 4 * members + 4 * P + reached),
           "ops": 2 * slots, "slots": slots, "members": members,
           "reached": reached}
    paths = {}
    for r in K.PROBE_ROUTES:
        if r == "staged" and K.probe_route(P, vmax) != "staged":
            continue
        got = K.bfs_probe(*pa[:5], strided_copy(out0), fbits, route=r)
        if not torch.equal(got, want):
            raise AssertionError(f"bfs_probe ({r}) differs from the plain "
                                 f"version")
        paths[r + "_ms"] = cuda_ms(
            lambda r=r: K.bfs_probe(*pa[:5], out_t, fbits, route=r), reps)
    paths["chosen"] = K.probe_route(P, vmax)
    flat = torch.as_strided(fbm, (P * fbm.stride(0),), (1,), 0)
    idx = ((nbl % P) * fbm.stride(0) + nbl // P)[ok]
    floor = {"ms": cuda_ms(lambda: flat.index_select(0, idx), reps),
             "gathers": idx.numel(),
             "bound_ms": bound(9 * idx.numel(), 0)[0]}
    return res, paths, floor


def level_measure(K, la, reps):
    """A bfs_level row's numbers at one captured call: the kernel, its
    plain version and one library formulation (three torch ops and two
    sums), each timed alone on the device on fresh copies of the depth
    array, the candidates and the counts row (cuda_ms_fresh), as the
    main path calls it (fbits_out and a zeroed counts row); the bytes of
    its bound (cand, dist, fbm and unvis once each, dist at the fresh
    vertices, the cleared candidates, the words, the counts)."""
    import torch
    a, kw = level_args(la)
    cand0, dist0 = la[0], la[1]
    cand, d_t, lv = a[0], a[1], a[2]

    def reset():
        d_t.copy_(dist0)
        cand.copy_(cand0)
        kw["counts"].zero_()

    def lib_level():
        new = cand & (d_t < 0)
        nd = torch.where(new, lv, d_t)
        return nd, torch.stack([new.sum(), (nd < 0).sum()])

    n = cand0.numel()
    fresh = int((cand0 & (dist0 < 0)).sum())
    words = 0 if la[5] is None else 4 * la[5].numel()
    return {"ms": cuda_ms_fresh(lambda: K.bfs_level(*a, **kw), reset, reps),
            "plain_ms": cuda_ms_fresh(lambda: K.bfs_level_plain(*a, **kw),
                                      reset, reps),
            "lib_ms": cuda_ms_fresh(lib_level, reset, reps),
            "nbytes": 7 * n + 4 * fresh + int(cand0.sum()) + words + 16,
            "ops": 4 * n, "slots": n, "fresh": fresh}


def bfs_whole_run(K, calls, reps):
    """Every bfs_probe and bfs_level call of one captured BFS run timed
    at its own inputs as the main path makes them (the probe reading the
    words, the level with fbits_out and a zeroed counts row, each alone
    on the device on fresh copies of what it writes), summed beside the
    summed bounds (loop_bound's formulas): launches x ms measured, not
    extrapolated from one level.  A probe call with no slot launches
    nothing and is left out."""
    import torch
    run = {}
    for name in ("bfs_probe", "bfs_level"):
        ms, bounds = [], []
        for a in calls[name]:
            if name == "bfs_probe" and a[0].numel() == 0:
                continue                 # no slot: the wrapper launches none
            if name == "bfs_probe":
                o = strided_copy(a[5])
                ms.append(cuda_ms_fresh(
                    lambda a=a, o=o: K.bfs_probe(*a[:5], o, a[6]),
                    lambda: None, reps))
                P, EB = a[0].shape
                slots = int(a[3].clamp(0, EB).sum())
                nbytes = (4 * slots + (slots if a[2] is not None else 0)
                          + 4 * a[6].numel() + 4 * P)
                bounds.append(bound(nbytes, 2 * slots)[0])
                continue
            la, kw = level_args(a)

            def reset(a=a, la=la, kw=kw):
                la[1].copy_(a[1])
                la[0].copy_(a[0])
                kw["counts"].zero_()

            ms.append(cuda_ms_fresh(lambda la=la, kw=kw: K.bfs_level(
                *la, **kw), reset, reps))
            n = a[0].numel()
            words = 0 if a[5] is None else 4 * a[5].numel()
            bounds.append(bound(7 * n + words + 16, 4 * n)[0])
        run[name] = {"calls": len(ms), "sum_ms": sum(ms),
                     "bound_sum_ms": sum(bounds), "ms": ms,
                     "bound_ms": bounds}
    torch.cuda.synchronize()
    return run


def loop_bound(K, run):
    """Run `run()` once with every kernel wrapper the host loops call
    (through gpu/hop.py, gpu/bfs.py, algo/frontier.py, gpu/runtime.py)
    wrapped to add its call's bound to a tally: each input read once and
    each output written once, from the call's own shapes and counts, by
    the formulas of the kernel rows (terms a call does not return, as a
    probe's reached count, are left out, so the sum stays a lower bound).
    Returns {kernel: summed bound ms}."""
    import importlib
    import math as _m
    mods = [importlib.import_module("nebula_tpu_torch." + m) for m in
            ("gpu.hop", "gpu.bfs", "algo.frontier", "gpu.runtime")]
    tally = {}

    def rows(t):
        return _m.prod(t.shape[:-1])

    def cost(name, a, kw, r):
        if name == "expand":
            fbm = a[3]
            hd = a[4] if len(a) > 4 else kw.get("hub_dense")
            tot, EB = int(r[4].sum()), r[0].shape[-1]
            H = 0 if hd is None else hd.numel()
            return (expand_bytes(rows(fbm), fbm.shape[-1], H, tot, EB,
                                 kw.get("hub_owner") is not None),
                    rows(fbm) * fbm.shape[-1] * 3 + tot)
        if name == "mark":
            n = a[0].numel()
            keep = a[3] if len(a) > 3 else kw.get("keep")
            return (4 + (keep is not None)) * n + r.numel(), 3 * n
        if name == "bfs_probe":
            tot = int(a[3].clamp(0, a[0].shape[1]).sum())
            keep = (a[2] is not None) * tot
            words = 4 * rows(a[4]) * -(-a[4].shape[1] // 32)
            return 4 * tot + keep + words + 4 * rows(a[0]), 2 * tot
        if name == "bfs_level":
            n = a[0].numel()
            words = 4 * rows(a[0]) * -(-a[0].shape[1] // 32)
            return 7 * n + (words if len(a) > 5 and a[5] is not None
                            else 0) + 16, 4 * n
        if name == "predicate_mask":
            tot = int(a[5].sum())        # a valid mask or row totals
            return 13 * tot + 4 * rows(a[1]), tot * len(a[0].code)
        if name == "compact_capture":
            ext = kw.get("extent")
            valid = a[0].numel() if ext is None else int(ext.sum())
            return (compact_bytes(a[0].numel(), valid, int(r[5].sum()),
                                  len(a[5]), rows(a[0])), 2 * valid)
        if name == "pack_bits":
            return a[0].numel() + 4 * r.numel(), a[0].numel()
        if name == "unpack_or":
            return 4 * a[0].numel() + a[2].numel(), a[0].numel()
        if name == "owned_hub_bits":          # a slot's or a group's bits
            lh = a[0].shape[-3] * a[2].numel()
            return 8 * a[2].numel() + 5 * lh, lh
        if name == "fill_hub_columns":        # every slot's hub columns
            lh = a[1].numel()
            return 4 * lh + rows(a[0]) // a[0].shape[-3] * lh, lh
        raise AssertionError(f"no bound formula for {name}")

    def wrap(name, fn):
        def counted(*a, **kw):
            r = fn(*a, **kw)
            b = bound(*cost(name, a, kw, r))[0]
            tally[name] = tally.get(name, 0.0) + b
            return r
        return counted

    wrappers = {id(w): w.__name__ for w in K._own_wrappers()}
    saved = []
    for mod in mods:
        for attr, val in list(vars(mod).items()):
            if id(val) in wrappers:
                saved.append((mod, attr, val))
                setattr(mod, attr, wrap(wrappers[id(val)], val))
    try:
        run()
    finally:
        for mod, attr, val in saved:
            setattr(mod, attr, val)
    return tally


def predicates(E, NULL):
    """WHERE KNOWS.w > 50 and eleven predicates over the w/f/city columns
    and the nullable wn (int), fn (float), bn (bool), cn (string-code)
    columns; they mix /, %, IN with NULL, AND/OR/XOR/NOT, IS NULL, unary
    minus, id($$) IN [...] and rank(edge)."""
    def col(n):
        return E.EdgeProp("KNOWS", n)

    def lit(v):
        return E.Literal(v)

    def b(op, x, y):
        return E.Binary(op, x, y)

    def lst(*vs):
        return E.ListExpr([lit(v) for v in vs])

    dst_id = E.FunctionCall("id", [E.VertexExpr("$$")])
    rank = E.FunctionCall("rank", [E.EdgeExpr()])
    return {
        "w>50": b(">", col("w"), lit(50)),
        "wn/7>2 AND fn<0.25": b("AND", b(">", b("/", col("wn"), lit(7)),
                                           lit(2)),
                                b("<", col("fn"), lit(0.25))),
        "wn%7==-3 OR (bn AND true)": b(
            "OR", b("==", b("%", col("wn"), lit(7)), lit(-3)),
            b("AND", col("bn"), lit(True))),
        "cn IN [eve,bob,NULL] XOR fn IS NULL": b(
            "XOR", b("IN", col("cn"), lst("eve", "bob", NULL)),
            E.Unary("IS_NULL", col("fn"))),
        "NOT bn AND wn IS NOT NULL": b(
            "AND", E.Unary("NOT", col("bn")),
            E.Unary("IS_NOT_NULL", col("wn"))),
        "fn%0.3<0.1 OR wn IN [1,2,3,NULL]": b(
            "OR", b("<", b("%", col("fn"), lit(0.3)), lit(0.1)),
            b("IN", col("wn"), lst(1, 2, 3, NULL))),
        "id($$) IN [...] OR -wn<-40": b(
            "OR", b("IN", dst_id, lst(0, 1, 2, 3, 5, 8, 13, 21)),
            b("<", E.Unary("-", col("wn")), lit(-40))),
        "(wn&7)==3 AND cn!=ada": b(
            "AND", b("==", b("&", col("wn"), lit(7)), lit(3)),
            b("!=", col("cn"), lit("ada"))),
        "wn/(w-50)>0": b(">", b("/", col("wn"), b("-", col("w"), lit(50))),
                         lit(0)),
        "rank==0 AND fn*100>=wn": b(
            "AND", b("==", rank, lit(0)),
            b(">=", b("*", col("fn"), lit(100)), col("wn"))),
        "wn NOT IN [0,-1,NULL] OR city==eve": b(
            "OR", b("NOT IN", col("wn"), lst(0, -1, NULL)),
            b("==", col("city"), lit("eve"))),
        "bn IN [true] AND wn+fn>10": b(
            "AND", b("IN", col("bn"), lst(True)),
            b(">", b("+", col("wn"), col("fn")), lit(10))),
    }


def write_batch(store, arrs, seeds, seed: int):
    """Phase 7's writes, made from `seed` with numpy, in a random order:
    ("insert", src, dst, props), ("delete", src, dst) and ("overwrite",
    src, dst, {"w": new w}).  Deletes and overwrites take distinct base
    edges the store can address (no parallel edge shares their (src,
    dst)); inserts take pairs of distinct persons that are no base edge,
    distinct among themselves, WRITES["seed_insert"] of them from a
    seed."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import _NAMES
    rng = np.random.default_rng(seed)
    n = int(arrs["n"])
    pick = rng.choice(store.writable_edges(),
                      WRITES["delete"] + WRITES["overwrite"], replace=False)
    ops = [("delete", int(arrs["src"][i]), int(arrs["dst"][i]))
           for i in pick[:WRITES["delete"]]]
    for i in pick[WRITES["delete"]:]:
        w = int(arrs["w"][i])
        ops.append(("overwrite", int(arrs["src"][i]), int(arrs["dst"][i]),
                    {"w": (w + 1 + int(rng.integers(99))) % 100}))
    n_seed = WRITES["seed_insert"]
    m = 2 * WRITES["insert"]
    src = rng.integers(0, n, m)
    src[:2 * n_seed] = rng.choice(np.asarray(seeds), 2 * n_seed)
    dst = rng.integers(0, n, m)
    ok = (src != dst) & ~store.base_has(src, dst)
    _, at = np.unique(src * n + dst, return_index=True)
    once = np.zeros(m, bool)
    once[at] = True
    idx = np.nonzero(ok & once)[0]
    idx = np.concatenate([idx[idx < 2 * n_seed][:n_seed],
                          idx[idx >= 2 * n_seed][:WRITES["insert"] - n_seed]])
    if idx.size != WRITES["insert"]:
        raise AssertionError(f"made {idx.size} inserts")
    for i in idx:
        ops.append(("insert", int(src[i]), int(dst[i]),
                    {"w": int(rng.integers(100)), "f": float(rng.random()),
                     "city": _NAMES[int(rng.integers(len(_NAMES)))]}))
    return [ops[i] for i in rng.permutation(len(ops))]


def apply_writes(store, ops) -> None:
    for op in ops:
        if op[0] == "insert":
            store.insert_edge(op[1], op[2], op[3])
        elif op[0] == "delete":
            store.delete_edge(op[1], op[2])
        else:
            store.update_edge(op[1], op[2], op[3])


def delta_rule_edges(base, hd, frontiers):
    """The reference's hop_edges over a delta plane, per hop: the base
    out-degrees of the hop's frontier (tombstoned edges included) plus
    the plane's insert rows whose source is on it (hop.py:145-159)."""
    import numpy as np
    P = base.num_parts
    ip = base.block("KNOWS", "out").indptr
    deg = (ip[:, 1:] - ip[:, :-1]).T.reshape(-1).astype(np.int64)
    ins = hd.ins[("KNOWS", "out")]
    dsrc = np.asarray([li * P + p for p in range(P)
                       for (li, _nbr, _rank) in ins[p]], np.int64)
    return [int(deg[f].sum()) + int(np.isin(dsrc, f).sum())
            for f in frontiers]


def go_frontiers(snap, seeds, steps: int):
    """The dense ids entering each hop of GO on `snap` (every hop's
    destinations, deduplicated, as the device marks them)."""
    import numpy as np
    P = snap.num_parts
    blk = snap.block("KNOWS", "out")
    fr = np.unique(np.asarray(seeds, np.int64))
    out = []
    for _ in range(steps):
        out.append(fr)
        o, lo = fr % P, fr // P
        s = blk.indptr[o, lo].astype(np.int64)
        deg = blk.indptr[o, lo + 1].astype(np.int64) - s
        rows = np.repeat(np.arange(fr.size), deg)
        idx = s[rows] + np.arange(int(deg.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(deg) - deg, deg)
        fr = np.unique(blk.nbr[o[rows], idx].astype(np.int64))
    return out


def time_go(rt, store, ns, repeats: int):
    """p50 milliseconds of GO 3 STEPS, unfiltered and WHERE w > 50, after
    one warm-up run each; returns ({label: p50}, {label: (rows, stats)})."""
    import numpy as np
    p50, last = {}, {}
    for flabel, filt in (("unfiltered", None),
                         (f"w>{ns.w_gt}", ns.w_filter)):
        lat = []
        for _ in range(repeats + 1):
            t = time.perf_counter()
            rows, st = rt.traverse(store, "ns", ns.seeds, ["KNOWS"], "out",
                                   3, edge_filter=filt, yields=ns.yields)
            lat.append(time.perf_counter() - t)
        p50[flabel] = float(np.median(lat[1:])) * 1e3
        last[flabel] = (rows, st)
    return p50, last


def time_bfs(rt, store, src: int):
    """p50 milliseconds of config 5's BFS over BFS_RUNS - 1 warm runs;
    returns (p50, dist, stats of the last run)."""
    import numpy as np
    lat = []
    for _ in range(BFS_RUNS):
        t = time.perf_counter()
        dist, st = rt.bfs(store, "ns", [src], ["KNOWS"], "out", BFS_STEPS)
        lat.append(time.perf_counter() - t)
    return float(np.median(lat[1:])) * 1e3, dist, st


def add_company():
    """Two dummy statements in the port's live registry: the batch
    former's concurrency hint is then true whatever order phase 8's
    threads arrive in (as tests/unit/test_batch.py:67-80 does)."""
    from nebula_tpu_torch.utils.workload import live_registry
    for qid in (-1, -2):
        live_registry().register(qid=qid, session=0, user="chip_smoke",
                                 stmt="company", kind="Go")


def rows_equal(a, b) -> bool:
    """Two ColumnarDataSets with the same columns, equal in order."""
    import numpy as np
    if a.column_names != b.column_names or len(a) != len(b):
        return False
    return all(np.array_equal(np.asarray(a.column_array(n)),
                              np.asarray(b.column_array(n)))
               for n in a.column_names)


def same_multiset(got, want) -> bool:
    """Whether two tables of integer columns (equal-length arrays, the
    same columns in the same order) hold the same rows as multisets.
    Each row's columns are packed into as few int64 words as the two
    tables' joint ranges allow; one word is compared by np.sort, more by
    a lexsort over the words (a lexsort over the columns themselves
    takes tens of seconds at 30M rows)."""
    import numpy as np
    got = [np.asarray(c).astype(np.int64, copy=False).ravel() for c in got]
    want = [np.asarray(c).astype(np.int64, copy=False).ravel()
            for c in want]
    n = got[0].size
    if any(c.size != n for c in got + want):
        return False
    if n == 0:
        return True
    words, used = ([], []), 63
    for x, y in zip(got, want):
        lo = min(int(x.min()), int(y.min()))
        bits = (max(int(x.max()), int(y.max())) - lo).bit_length()
        if bits == 0:                   # one value in both: no order
            continue
        if bits > 62:                   # the column alone, as it is
            for w, c in zip(words, (x, y)):
                w.append(c.copy())
            used = 63
            continue
        if used + bits > 63:
            for w in words:
                w.append(np.zeros(n, np.int64))
            used = 0
        for w, c in zip(words, (x, y)):
            w[-1] <<= bits
            w[-1] |= c - lo
        used += bits
    if len(words[0]) <= 1:
        if not words[0]:
            return True
        return np.array_equal(np.sort(words[0][0]), np.sort(words[1][0]))
    a, b = (np.lexsort(w[::-1]) for w in words)
    return all(np.array_equal(x[a], y[b]) for x, y in zip(*words))


def go_call(rt, store, steps, filt, yields):
    """One GO statement of phase 8 on the north-star space, by seeds."""
    return lambda seeds: rt.traverse(store, "ns", seeds, ["KNOWS"], "out",
                                     steps, edge_filter=filt, yields=yields)


def run_batch(label, go, seed_sets, steps, K, same=rows_equal, size=len,
              rows=1):
    """Phase 8's and 9c's statements, `go(seeds)` -> (result, stats): each
    run solo (batching off; launch counters zeroed before the first and
    read after it), then all at once from threads with the former on,
    counters zeroed just before and read just after.  Checks one batch of
    all of them, the batch's launches against one solo run's (times
    `rows`, the lane rows of a grid, each running its chunk of the lanes
    where a solo run takes one row), and every statement's result
    (`same`: rows in order, or frames) and hop_edges against its solo
    run.  Returns (results, the batch's launches)."""
    import threading

    import numpy as np
    import torch
    from nebula_tpu_torch.utils.config import get_config
    from nebula_tpu_torch.utils.stats import stats
    cfg = get_config()
    n = len(seed_sets)
    cfg.set_dynamic_many({"batch_max_lanes": 0})
    go(seed_sets[0])                          # warm-up
    torch.cuda.synchronize()
    solo, solo_wall = [], []
    for i, seeds in enumerate(seed_sets):
        if i == 0:
            K.reset_launch_counts()
        t = time.perf_counter()
        solo.append(go(seeds))
        solo_wall.append(time.perf_counter() - t)
        if i == 0:
            torch.cuda.synchronize()
            solo_launches = counts(K)

    cfg.set_dynamic_many({"batch_max_lanes": n,
                          "batch_wait_us": BATCH_WAIT_US})
    out, errs = {}, {}
    start = threading.Barrier(n + 1)

    def member(i):
        try:
            start.wait()
            t = time.perf_counter()
            rows, st = go(seed_sets[i])
            out[i] = (rows, st, time.perf_counter() - t)
        except BaseException as ex:  # noqa: BLE001 — reported below
            errs[i] = ex

    threads = [threading.Thread(target=member, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s0 = stats().snapshot()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    start.wait()
    deadline = t0 + BATCH_JOIN_S
    for th in threads:
        th.join(max(deadline - time.perf_counter(), 0.0))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = counts(K)
    peak = torch.cuda.max_memory_allocated()
    s1 = stats().snapshot()
    cfg.set_dynamic_many({"batch_max_lanes": 0})
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"[{label}] a batched statement did not finish "
                             f"in {BATCH_JOIN_S} s")
    if errs:
        raise AssertionError(f"[{label}] batched statements failed: {errs}")

    def delta(k):
        return s1.get(k, 0) - s0.get(k, 0)

    if delta("tpu_batches_formed") != 1 or delta("tpu_kernel_runs") != 1 \
            or delta("tpu_batch_lanes.count") != 1 \
            or delta("tpu_batch_lanes.sum") != n:
        raise AssertionError(
            f"[{label}] {delta('tpu_batches_formed')} batches, "
            f"{delta('tpu_kernel_runs')} device runs, "
            f"{delta('tpu_batch_lanes.sum')} lanes for {n} statements")
    used = {k: v for k, v in launches.items() if v}
    if used != {k: v * rows for k, v in solo_launches.items() if v}:
        raise AssertionError(f"[{label}] batch launches {used} vs one solo "
                             f"run's {solo_launches}")
    for i in range(n):
        rows, st, _ = out[i]
        srows, sst = solo[i]
        if not same(rows, srows):
            raise AssertionError(f"[{label}] statement {i}: result differs, "
                                 f"in order, from its solo run")
        if st.hop_edges != sst.hop_edges \
                or st.frontier_sizes != sst.frontier_sizes:
            raise AssertionError(f"[{label}] statement {i}: hop_edges "
                                 f"{st.hop_edges} vs {sst.hop_edges}")
    st_b = out[0][1]
    res = {
        "statements": n, "steps": steps,
        "seeds_per_statement": len(seed_sets[0]),
        "rows": [size(out[i][0]) for i in range(n)],
        "dispatches_per_statement": delta("tpu_kernel_runs") / n,
        "batch_device_s": st_b.device_s,
        "solo_device_s_sum": float(sum(s.device_s for _, s in solo)),
        "batch_e_cap": st_b.e_cap,
        "solo_e_cap_max": [max(s.e_cap[h] for _, s in solo)
                           for h in range(steps)],
        "batched_wall_s": wall, "batched_wall_per_statement_s": wall / n,
        "batched_latency_p50_s": float(np.median(
            [out[i][2] for i in range(n)])),
        "solo_wall_per_statement_s": float(np.mean(solo_wall)),
        "solo_wall_sum_s": float(sum(solo_wall)),
        "form_wait_s": float(np.median([out[i][1].queue_s
                                        for i in range(n)])),
        "batch_fetch_s": st_b.fetch_s,
        "mat_s_p50": float(np.median([out[i][1].mat_s for i in range(n)])),
        "max_memory_allocated_above_pin": peak - base,
        "launches_per_batch": used}
    log(f"[{label}] {json.dumps(res)}")
    return res, launches


def lane_frontiers(K, dev, lane_dense, steps: int, dl=None, extra=0):
    """Phase 8d's inputs, from the plain versions: the (L, P, vmax + H)
    frontier stacks entering each hop (hub columns filled) and each hop's
    (L, P, W) slots but the last's.  With a delta plane (`dl`, its
    tensors) each hop's slots are merged first."""
    import torch
    from nebula_tpu_torch.gpu.hop import new_frontier
    blk = dev.blocks[("KNOWS", "out")]
    P, vmax = dev.num_parts, dev.vmax
    cap = max(len(d) for d in lane_dense)
    pad = torch.full((len(lane_dense), cap), -1, dtype=torch.int32)
    for i, d in enumerate(lane_dense):
        pad[i, :len(d)] = torch.tensor(sorted(set(d)), dtype=torch.int32)
    ids = pad.to(dev.device)
    buf = new_frontier(dev, lanes=len(lane_dense))
    K.mark_plain(ids, P, vmax, out=buf[..., :vmax])
    bufs, dsts = [], []
    for hop in range(steps):
        if dev.num_hubs:
            K.extend_hubs_plain(buf, dev.hub_owner, dev.hub_local, vmax)
        bufs.append(buf)
        if hop == steps - 1:
            break
        sl = K.expand_plain(blk.indptr, blk.nbr, blk.rank, buf,
                            dev.hub_dense, extra)
        if dl is not None:
            K.merge_delta_plain(*sl, buf[..., :vmax], dl["d_src"],
                                dl["d_dst"], dl["d_rank"], dl["d_valid"],
                                dl["d_tomb"], blk.nbr.shape[1])
        dsts.append(sl[1])
        buf = new_frontier(dev, lanes=len(lane_dense))
        K.mark_plain(sl[1], P, vmax, out=buf[..., :vmax])
    return ids, bufs, dsts


def expand_bytes(P, nrows, H, tot, EB, owners: bool = False):
    """expand's bytes: the P CSR rows' offsets and the frontier read once,
    each traversed edge's neighbour and rank, the four (P, EB) slot
    arrays and the totals written, the hub ids read.  Through the owner
    tables (`owners`) the frontier is its (P, nrows - H) ownership
    columns, whose bytes hold every hub's bit, and the two (H,) tables
    are read; the H tail columns are not."""
    front = P * (nrows - H) + 8 * H if owners else P * nrows
    return (P * (nrows + 1) * 4 + front + 8 * tot + 16 * P * EB
            + 4 * P + 4 * H)


def compact_bytes(slots: int, valid: int, gathered: int, ncols: int,
                  rows: int) -> int:
    """compact_capture's byte bound (see compact_capture.cu): keep read
    once a slot, src/dst/rank/eidx read for each valid slot (the sectors
    of the kept ones cover them), every output written once — the padded
    tails too — and each column's words gathered once; kcount written and
    the extent read once a row."""
    return (slots + 16 * valid + (16 + 8 * ncols) * slots
            + 8 * ncols * gathered + 8 * rows)


def edge_cases(K, AK, device) -> None:
    """[4e]: expand, compact_capture, mark, predicate_mask, merge_delta and
    pagerank_step against their plain versions on bench/kernel_cases.py's
    edge cases at their card sizes: all but the last bit for bit (every
    output, padding included; expand's owner route too, the hub bits
    from their owners' rows past junk tail columns; mark through each of its two kernels that
    fits, and the wrapper's own choice, with the whole buffer around a
    bitmap view compared; predicate_mask through each route its program
    has and the wrapper's choice; merge_delta's mask, totals and every
    slot array it merges in place), a PageRank step within
    PAGERANK_STEP_TOL and two runs bit-identical; raises on the first
    difference."""
    import torch
    from nebula_tpu_torch.bench.kernel_cases import (
        compact_cases, copy_view, expand_cases, expand_owner_cases,
        fresh_merge_args, mark_cases, merge_delta_cases, pagerank_cases,
        predicate_cases)
    t0 = time.perf_counter()
    for kname, cases in (("expand", expand_cases(device, big=True)
                          + expand_owner_cases(device, big=True)),
                         ("compact_capture",
                          compact_cases(device, big=True))):
        kern, plain = getattr(K, kname), getattr(K, kname + "_plain")
        for name, args, kw in cases:
            got, want = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            if kname == "compact_capture":
                got = [*got[:4], *got[4], got[5]]
                want = [*want[:4], *want[4], want[5]]
            try:
                max_abs_err(got, want)
            except AssertionError as e:
                raise AssertionError(f"[4e] {kname}, {name}: {e}") from None
            shape = tuple(args[4 if kname == "compact_capture" else 3].shape)
            log(f"[4e] {kname}, {name} {shape}: equal")
    for name, (ids, P, vmax), kw in mark_cases(device, big=True):
        want = copy_view(kw["out"])
        K.mark_plain(ids, P, vmax, keep=kw.get("keep"), out=want)
        paths = [None] + [p for p in K.MARK_PATHS if p == "direct"
                          or K.mark_stage_bytes(P, vmax) <= K.MARK_SMEM_BYTES]
        for path in paths:
            got = copy_view(kw["out"])
            K.mark(ids, P, vmax, keep=kw.get("keep"), out=got, path=path)
            torch.cuda.synchronize()
            if not torch.equal(got._base, want._base):
                raise AssertionError(f"[4e] mark ({path or 'chosen'}), "
                                     f"{name}: differs from mark_plain")
        log(f"[4e] mark, {name} {tuple(ids.shape)} into "
            f"{tuple(kw['out'].shape)}: equal through "
            f"{[p or 'chosen' for p in paths]}")
    for name, args, kw in predicate_cases(device, big=True):
        want = K.predicate_mask_plain(*args, **kw)
        paths = [None] + [p for p in K.PREDICATE_PATHS
                          if p == "interpreter"
                          or K.predicate_path(args[0]) == p]
        for path in paths:
            got = K.predicate_mask(*args, **kw, path=path)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"[4e] predicate_mask "
                                     f"({path or 'chosen'}), {name}: "
                                     f"differs from the plain version")
        log(f"[4e] predicate_mask, {name} {tuple(args[1].shape)}: equal "
            f"through {[p or 'chosen' for p in paths]}")
    for name, args, kw in merge_delta_cases(device, big=True):
        g, w = fresh_merge_args(args), fresh_merge_args(args)
        got = [*K.merge_delta(*g, **kw), *g[:4]]
        want = [*K.merge_delta_plain(*w, **kw), *w[:4]]
        torch.cuda.synchronize()
        try:
            max_abs_err(got, want)
        except AssertionError as e:
            raise AssertionError(f"[4e] merge_delta, {name}: {e}") from None
        log(f"[4e] merge_delta, {name} {tuple(args[0].shape)}, Tcap "
            f"{args[10].shape[1]}: equal ({int(want[0].sum())} valid)")
    for name, args, _ in pagerank_cases(device, big=True):
        got, want = AK.pagerank_step(*args), AK.pagerank_step_plain(*args)
        again = AK.pagerank_step(*args)
        torch.cuda.synchronize()
        err = pagerank_step_err(f"[4e] {name}", args, got, want)
        if not (torch.equal(got[0].view(torch.int64),
                            again[0].view(torch.int64))
                and torch.equal(got[1].view(torch.int64),
                                again[1].view(torch.int64))
                and int(got[2]) == int(again[2])):
            raise AssertionError(f"[4e] pagerank_step, {name}: two runs "
                                 f"differ")
        log(f"[4e] pagerank_step, {name} (n {args[0].numel()}, E "
            f"{args[1].numel()}): max abs err {err}, rerun bit-identical")
    relax_edge_cases(AK, device)
    bfs_edge_cases(K, device)
    exchange_edge_cases(K, device)
    log(f"[4e] edge cases done in {time.perf_counter() - t0:.1f} s")


def exchange_edge_cases(K, device) -> None:
    """[4e]: the mesh's exchange kernels (pack_bits, unpack_or,
    owned_hub_bits, fill_hub_columns) against their plain versions, bit
    for bit, on bench/kernel_cases.py's exchange cases at card sizes, one
    slot and slot groups: every load and store width, the transports'
    strided views; the whole buffer around a view written in place
    compared."""
    import torch
    from nebula_tpu_torch.bench.kernel_cases import copy_view, exchange_cases
    for name, kname, args in exchange_cases(device, big=True):
        outs = []
        for fn in (getattr(K, kname), getattr(K, kname + "_plain")):
            a = list(args)
            if kname == "unpack_or":
                a[2] = copy_view(a[2])
            elif kname == "fill_hub_columns":
                a[0] = a[0].clone()
            r = fn(*a)
            outs.append(r._base if kname == "unpack_or" else r)
        torch.cuda.synchronize()
        try:
            max_abs_err(outs[:1], outs[1:])
        except AssertionError as e:
            raise AssertionError(f"[4e] {kname}, {name}: {e}") from None
        log(f"[4e] {kname}, {name}: equal")


def bfs_edge_cases(K, device) -> None:
    """[4e]: bfs_probe and bfs_level against their plain versions, bit for
    bit, on bench/kernel_cases.py's BFS cases at card sizes: the probe
    through each route that fits (forced) and the wrapper's own choice,
    the whole buffer around its bitmap view compared, against the plain
    version reading the frontier's bitmap (not its words); the level
    update in every output (dist, the next frontier and unvisited
    buffers, the cleared candidates, the frontier's words and the counts'
    whole buffer)."""
    import torch
    from nebula_tpu_torch.bench.kernel_cases import bfs_cases, fresh_bfs_args
    for name, kname, args, kw in bfs_cases(device, big=True):
        a, k = fresh_bfs_args(kname, args, kw)
        if kname == "bfs_probe":
            P, vmax = args[4].shape
            want = K.bfs_probe_plain(*a)._base
            routes = [None] + [r for r in K.PROBE_ROUTES if r == "global"
                               or K.probe_route(P, vmax) == r]
            for route in routes:
                g, gk = fresh_bfs_args(kname, args, kw)
                K.bfs_probe(*g, **gk, route=route)
                torch.cuda.synchronize()
                if not torch.equal(g[5]._base, want):
                    raise AssertionError(f"[4e] bfs_probe "
                                         f"({route or 'chosen'}), {name}: "
                                         f"differs from the plain version")
            log(f"[4e] bfs_probe, {name} ({P}, {vmax}), "
                f"{int(args[3].clamp(0, args[0].shape[1]).sum())} slots, "
                f"{int((want & ~args[5]._base).sum())} reached: equal "
                f"through {[r or 'chosen' for r in routes]}")
            continue
        want = K.bfs_level_plain(*a, **k)
        g, gk = fresh_bfs_args(kname, args, kw)
        got = K.bfs_level(*g, **gk)
        torch.cuda.synchronize()
        outs = [(got, want), (g[1], a[1])] + [
            (x._base, y._base) for x, y in zip((g[0], g[3], g[4]),
                                               (a[0], a[3], a[4]))]
        outs += [(gk[n] if n == "fbits_out" else gk[n]._base,
                  k[n] if n == "fbits_out" else k[n]._base) for n in gk]
        for x, y in outs:
            if not torch.equal(x, y):
                raise AssertionError(f"[4e] bfs_level, {name}: differs "
                                     f"from the plain version")
        log(f"[4e] bfs_level, {name} {tuple(args[1].shape)}: equal in "
            f"every output, counts {want.tolist()}")


def relax_edge_cases(AK, device) -> None:
    """[4e]: wcc_step and sssp_step against their plain versions, bit for
    bit in every output, on bench/kernel_cases.py's relax cases at card
    sizes, through each route that fits (forced) and the wrapper's own
    choice; then the largest case again with its edges in a random order
    (the kernel needs no sort to be exact)."""
    import torch
    from nebula_tpu_torch.bench.kernel_cases import relax_cases
    cases = relax_cases(device, big=True)
    name, kname, args = max(cases, key=lambda c: c[2][2].numel())
    perm = torch.randperm(args[2].numel(), device=device)
    shuffled = (*args[:2], args[2][perm], args[3][perm],
                *(a[perm] for a in args[4:]))
    cases.append((f"{name}, edges in a random order", kname, shuffled))
    for name, kname, args in cases:
        kern, plain = getattr(AK, kname), getattr(AK, kname + "_plain")
        want = plain(*args)
        routes = [None] + [r for r in AK.RELAX_ROUTES if r == "global"
                           or AK.relax_route(args[0].numel()) == r]
        for route in routes:
            got = kern(*args, route=route)
            torch.cuda.synchronize()
            try:
                max_abs_err(got, want)
            except AssertionError as e:
                raise AssertionError(f"[4e] {kname} ({route or 'chosen'}), "
                                     f"{name}: {e}") from None
        log(f"[4e] {kname}, {name} (n {args[0].numel()}, E "
            f"{args[2].numel()}, {int(want[2])} changed): equal through "
            f"{[r or 'chosen' for r in routes]}")


def mark_paths(K, tag, label, call, want, chosen, reps):
    """Time each of mark's two kernels at one shape — call(path) marks
    into a fresh bitmap — after holding each bit for bit against `want`;
    logs {path: ms} beside the wrapper's choice `chosen`."""
    import torch
    res = {}
    for path in K.MARK_PATHS:
        if not torch.equal(call(path), want):
            raise AssertionError(f"{tag} mark ({path}) at {label}: differs "
                                 f"from mark_plain")
        res[path + "_ms"] = cuda_ms(lambda p=path: call(p), reps)
    res["chosen"] = chosen
    log(f"{tag} mark paths ({label}): {json.dumps(res)}")
    return res


def w_gt_50_torch(w, eidx, total):
    """The main path's WHERE w > 50 in three PyTorch calls, over the
    (P, emax) column and (..., P, EB) slots with the prefix `total`: a
    yardstick beside predicate_mask, not a library call of the same
    function."""
    import torch
    e = eidx.long()
    return (torch.arange(e.shape[-1], device=e.device) < total[..., None]) \
        & (w.expand(*e.shape[:-1], w.shape[-1]).gather(-1, e) > 50)


def predicate_paths(K, tag, label, pa, want, reps):
    """Where a program has two routes (gpu/kernels.py:predicate_path),
    time each of predicate_mask's kernels at one shape after holding it
    bit for bit against `want` — back to back (`_ms`, as the kernel rows
    are timed: the wrapper's host time shows where it exceeds the
    kernel's) and each launch alone on the device (`_device_ms`,
    cuda_ms_fresh) — and the torch formulation of w > 50 (w_gt_50_torch,
    three calls); logs {path: ms} beside the wrapper's choice."""
    import torch
    chosen = K.predicate_path(pa[0])
    if chosen == "interpreter":
        return None
    res = {}
    for path in K.PREDICATE_PATHS:
        if not torch.equal(K.predicate_mask(*pa, path=path), want):
            raise AssertionError(f"{tag} predicate_mask ({path}) at "
                                 f"{label}: differs from the plain version")
        res[path + "_ms"] = cuda_ms(
            lambda p=path: K.predicate_mask(*pa, path=p), reps)
        res[path + "_device_ms"] = cuda_ms_fresh(
            lambda p=path: K.predicate_mask(*pa, path=p), lambda: None,
            reps)
    def yard():
        return w_gt_50_torch(pa[6][0], pa[4], pa[5])

    if not torch.equal(yard(), want):
        raise AssertionError(f"{tag} w > 50 in torch at {label}: differs")
    res["torch_3_calls_ms"] = cuda_ms(yard, reps)
    res["chosen"] = chosen
    log(f"{tag} predicate paths ({label}): {json.dumps(res)}")
    return res


def ptxas_lines(report: str, kernels) -> list:
    """Registers, stack frame and spills of each compiled entry whose name
    holds one of `kernels`, from nvcc -Xptxas -v's report: one line an
    entry (a template's instances each)."""
    out, entry, props = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, props = m.group(1), ""
            continue
        if entry is None:
            continue
        if "stack frame" in line:
            props = line.split(":", 1)[-1].strip() if ":" in line \
                else line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name = next((k for k in kernels if k in entry), None)
            if name is not None:
                out.append(f"{name} [{entry}]: {m.group(1)} registers, "
                           f"{props}")
            entry = None
    return out


def distinct_edges(eidx, mask) -> int:
    """Distinct (part, eidx) pairs among the slots `mask` selects of an
    (L, P, W) eidx array: the edges whose columns a lane-widened kernel
    must read at least once."""
    import torch
    P = eidx.shape[-2]
    part = torch.arange(P, device=eidx.device).view(1, P, 1)
    key = (eidx.long() * P + part)[mask]
    return int(torch.unique(key).numel())


def count_trails(frames, seeds):
    """The MATCH executor's trail assembly (executors.py:487-500 in the
    reference), counting: extend every trail by its last vertex's edges
    in the next frame, drop a continuation that reuses an edge of its
    trail.  Returns the number of trails of every length."""
    import numpy as np
    from nebula_tpu_torch.gpu import join_frontier_trails, \
        trail_distinct_keep
    last = np.asarray(sorted(set(seeds)), np.int64)
    path, total = [], 0
    for fr in frames:
        if last.size == 0 or fr.n == 0:
            break
        parent, fidx = join_frontier_trails(fr, last)
        keep = trail_distinct_keep(frames, path, parent, fr, fidx)
        parent, fidx = parent[keep], fidx[keep]
        total += int(fidx.size)
        path = [pe[parent] for pe in path] + [fidx]
        last = fr.dst[fidx]
    return total


def frames_equal(a, b) -> bool:
    """Two runs' HopFrames with the same columns, in order."""
    import numpy as np
    return len(a) == len(b) and all(
        x.n == y.n and all(np.array_equal(getattr(x, k), getattr(y, k))
                           for k in ("src", "dst", "rank", "key_et",
                                     "key_s", "key_d"))
        for x, y in zip(a, b))


def check_frames(label, frames, oracle) -> None:
    """Each hop's frame equals the numpy every-hop expansion
    (datagen.host_hop_edges) as a multiset of (src, dst, rank)."""
    if len(frames) != len(oracle):
        raise AssertionError(f"[{label}] {len(frames)} frames, "
                             f"{len(oracle)} oracle hops")
    for h, (f, (s, d, r)) in enumerate(zip(frames, oracle)):
        if f.n != s.size or not same_multiset([f.src, f.dst, f.rank],
                                              [s, d, r]):
            raise AssertionError(f"[{label}] hop {h + 1}: frame of {f.n} "
                                 f"edges differs from the oracle's "
                                 f"{s.size}")


def match_inputs(K, dev, seeds, prog, steps: int):
    """Phase 9d's inputs, from the plain versions: per hop of the
    filtered every-hop run, the frontier buffer entering it (hub columns
    filled), its slots (src, dst, rank, eidx, total) and the predicate's
    keep mask; the next frontier marks only the kept dsts."""
    import torch
    from nebula_tpu_torch.gpu.hop import new_frontier
    blk = dev.blocks[("KNOWS", "out")]
    P, vmax = dev.num_parts, dev.vmax
    ids = torch.tensor(sorted(set(seeds)), dtype=torch.int32,
                       device=dev.device)
    buf = new_frontier(dev)
    K.mark_plain(ids, P, vmax, out=buf[:, :vmax])
    hops = []
    for hop in range(steps):
        if dev.num_hubs:
            K.extend_hubs_plain(buf, dev.hub_owner, dev.hub_local, vmax)
        sl = K.expand_plain(blk.indptr, blk.nbr, blk.rank, buf,
                            dev.hub_dense)
        keep = K.predicate_mask_plain(prog, *sl[:4], sl[4],
                                      [blk.props[n] for n in prog.columns])
        hops.append((buf, sl, keep))
        if hop < steps - 1:
            buf = new_frontier(dev)
            K.mark_plain(sl[1], P, vmax, keep=keep, out=buf[:, :vmax])
    return ids, hops


def run_match(rt, store, space, seeds, steps, filt, runs: int, K,
              assemble: bool = True):
    """MATCH's every-hop expansion through `rt.traverse_hops`: one warm
    run, then `runs` runs, launch counters zeroed just before the first
    and read just after it; with `assemble`, each run's frames counted
    into trails by `count_trails`.  Returns (frames, stats, launches,
    per-phase p50 seconds, trail count or None) of the first counted
    run."""
    import numpy as np
    import torch
    rt.traverse_hops(store, space, seeds, ["KNOWS"], "out", steps,
                     edge_filter=filt)
    torch.cuda.synchronize()
    phases = {k: [] for k in ("total_s", "device_s", "fetch_s", "mat_s",
                              "assembly_s")}
    first = None
    for i in range(runs):
        if i == 0:
            K.reset_launch_counts()
        t0 = time.perf_counter()
        frames, st = rt.traverse_hops(store, space, seeds, ["KNOWS"], "out",
                                      steps, edge_filter=filt)
        total = time.perf_counter() - t0
        if i == 0:
            torch.cuda.synchronize()
            launches = counts(K)
        t0 = time.perf_counter()
        trails = count_trails(frames, seeds) if assemble else None
        asm = time.perf_counter() - t0
        for k, v in (("total_s", total), ("device_s", st.device_s),
                     ("fetch_s", st.fetch_s), ("mat_s", st.mat_s),
                     ("assembly_s", asm if assemble else None)):
            phases[k].append(v)
        if first is None:
            first = (frames, st, trails)
        del frames
    p50 = {k: None if v[0] is None else float(np.median(v))
           for k, v in phases.items()}
    return first[0], first[1], launches, p50, first[2]


def temporal_words(f, pool):
    """Phase 11's edge columns as the snapshot stores them ((P, Emax)
    int64 words), each derived from the block's `f` column, one uniform
    draw an edge and the same in both directions, by a fixed rule:
    d, a DATE in 1920-2019; d2, 0 to 98 days before d or, for 1 edge in
    100, one day after it (so that WHERE d < d2 keeps about 1% of the
    final hop); t, a DATETIME in 1920-2019 with microseconds; tm, a
    TIME; g, one of TEMPORAL_POINTS point WKTs (pool codes); about one
    value in TEMPORAL_NULL_EVERY of each column NULL."""
    import numpy as np
    from nebula_tpu_torch.graphstore.csr import INT_NULL
    u = (np.nan_to_num(f, nan=0.0) * float(1 << 40)).astype(np.int64)
    d = u % 36_525 - 18_262
    k = (u >> 17) % 100
    pts = np.asarray([pool.encode(f"POINT({i % 360 - 180}.25 "
                                  f"{(i // 360) * 30 - 45}.5)")
                      for i in range(TEMPORAL_POINTS)], np.int64)
    words = {"d": d, "d2": np.where(k == 99, d + 1, d - k),
             "t": (u >> 3) % (36_525 * DAY_US) - 18_262 * DAY_US,
             "tm": (u >> 7) % DAY_US,
             "g": pts[(u >> 23) % TEMPORAL_POINTS]}
    for j, name in enumerate(TEMPORAL_TYPES):
        words[name][(u >> (29 + j)) % TEMPORAL_NULL_EVERY == 0] = INT_NULL
    return words


def temporal_snapshot(snap):
    """`snap` (an unsplit north-star snapshot) with phase 11's columns
    added to every block: the CSR arrays and w, f, city shared, the pool
    a copy."""
    from nebula_tpu_torch.graphstore.csr import (CsrBlock, CsrSnapshot,
                                                 StringPool)
    from nebula_tpu_torch.graphstore.schema import PropType
    pool = StringPool(list(snap.pool.strings))
    types = {n: PropType[t] for n, t in TEMPORAL_TYPES.items()}
    blocks = {key: CsrBlock(
        etype=b.etype, direction=b.direction, indptr=b.indptr, nbr=b.nbr,
        rank=b.rank, props={**b.props, **temporal_words(b.props["f"], pool)},
        prop_types={**b.prop_types, **types})
        for key, b in snap.blocks.items()}
    return CsrSnapshot(space=snap.space, epoch=snap.epoch,
                       num_parts=snap.num_parts, vmax=snap.vmax,
                       num_vertices=snap.num_vertices, blocks=blocks,
                       tags=snap.tags, pool=pool,
                       dense_to_vid=snap.dense_to_vid)


def final_words(snap, seeds, steps: int, names, where: bool):
    """The numpy oracle of a GO over out-KNOWS on `snap`: (edges
    traversed, {name: the final hop's words}, final dsts), with `where`
    only the edges whose d < d2 (both non-NULL, as the WHERE keeps
    them)."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import host_final_hop
    from nebula_tpu_torch.graphstore.csr import INT_NULL
    total, ((blk, o, i),) = host_final_hop(snap, seeds, steps)
    keep = np.ones(o.size, bool)
    if where:
        d, d2 = blk.props["d"][o, i], blk.props["d2"][o, i]
        keep = (d != INT_NULL) & (d2 != INT_NULL) & (d < d2)
    o, i = o[keep], i[keep]
    return total, {n: blk.props[n][o, i] for n in names}, blk.nbr[o, i]


def check_decoded(label, rows, words, types, pool) -> dict:
    """The rows' decoded columns equal, as a multiset of rows, the
    oracle's words decoded as the runtime decodes a column
    (decode_prop_column_np: decode_prop one by one for these types).
    Returns each column's decode seconds."""
    from collections import Counter
    from nebula_tpu_torch.graphstore.csr import decode_prop_column_np
    want, secs = [], {}
    for n in words:
        t0 = time.perf_counter()
        want.append(decode_prop_column_np(types[n], words[n], pool))
        secs[n] = time.perf_counter() - t0
    got = [rows.column(n) for n in words]
    if len(rows) != len(want[0]) \
            or Counter(zip(*got)) != Counter(zip(*want)):
        raise AssertionError(f"[{label}] {len(rows)} rows differ from the "
                             f"oracle's {len(want[0])}")
    return secs


def edge_props_ok(blk, P, pool, e) -> bool:
    """Whether Edge `e` (dense src and dst) carries the decoded props of
    one of the out-block's (src, dst) edges (a multigraph key may have
    several)."""
    import numpy as np
    from nebula_tpu_torch.graphstore.csr import decode_prop
    o, lo = e.src % P, e.src // P
    a, b = int(blk.indptr[o, lo]), int(blk.indptr[o, lo + 1])
    names = list(blk.prop_types)
    got = tuple(e.props[n] for n in names)
    return any(got == tuple(decode_prop(blk.prop_types[n],
                                        blk.props[n][o, j], pool)
                            for n in names)
               for j in a + np.flatnonzero(blk.nbr[o, a:b] == e.dst))


def temporal_inserts(store, arrs, seeds, pool, n_ins: int):
    """11c's writes: n_ins KNOWS inserts, each from one of `seeds` to a
    person it has no base edge to, distinct keys, with values of every
    phase 11 column (dates and datetimes on both sides of 1970, new
    points, some NULL) made from a fixed seed: (src, dst, props)."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import _NAMES
    from nebula_tpu_torch.core.geo import from_wkt
    from nebula_tpu_torch.core.value import NULL, Date, DateTime, Time
    rng = np.random.default_rng(11)
    n = int(arrs["n"])
    src = rng.choice(np.asarray(seeds), 2 * n_ins)
    dst = rng.integers(0, n, 2 * n_ins)
    _, at = np.unique(src * n + dst, return_index=True)
    once = np.zeros(src.size, bool)
    once[at] = True
    idx = np.nonzero((src != dst) & ~store.base_has(src, dst) & once)[0]
    if idx.size < n_ins:
        raise AssertionError(f"made {idx.size} inserts")
    out = []
    for k, i in enumerate(idx[:n_ins]):
        y = 1950 + k % 40
        props = {"w": k % 100, "f": float(rng.random()),
                 "city": _NAMES[k % len(_NAMES)],
                 "d": Date(y, 1 + k % 12, 1 + k % 28),
                 "d2": Date(y + (k % 3) - 1, 1 + k % 12, 1 + k % 28),
                 "t": DateTime(y, 12, 31, 23, 59, k % 60,
                               int(rng.integers(1_000_000))),
                 "tm": Time(k % 24, k % 60, (7 * k) % 60, k),
                 "g": from_wkt(f"POINT({k % 180}.75 {k % 90 - 45}.125)")}
        for j, name in enumerate(TEMPORAL_TYPES):
            if (k + j) % TEMPORAL_NULL_EVERY == 0:
                props[name] = NULL
        out.append((int(src[i]), int(dst[i]), props))
    return out


def spliced_snapshot(snap, pool_strings, inserts):
    """The written snapshot a full rebuild pins, for GO over out-KNOWS:
    `snap`'s out block with `inserts` (new keys, rank 0) each after the
    base edges of its row whose neighbor is not greater, as
    snapshot_from_arrays orders a row; its words encoded by encode_prop
    against a pool of `pool_strings` (the base pool before the writes)."""
    import numpy as np
    from nebula_tpu_torch.graphstore.csr import (CsrBlock, CsrSnapshot,
                                                 StringPool, encode_prop)
    P, blk = snap.num_parts, snap.block("KNOWS", "out")
    pool = StringPool(list(pool_strings))
    ins = sorted(inserts, key=lambda x: (x[0] % P, x[0] // P, x[1]))
    src = np.asarray([x[0] for x in ins], np.int64)
    dst = np.asarray([x[1] for x in ins], np.int64)
    o, lo = src % P, src // P
    ip = blk.indptr.astype(np.int64)
    pos = np.asarray([ip[a, b] + np.searchsorted(
        blk.nbr[a, ip[a, b]:ip[a, b + 1]], d, "right")
        for a, b, d in zip(o, lo, dst)], np.int64)
    cols = {"nbr": blk.nbr, "rank": blk.rank, **blk.props}
    vals = {"nbr": dst.astype(np.int32), "rank": np.zeros(src.size,
                                                          np.int32)}
    for n, pt in blk.prop_types.items():
        vals[n] = np.asarray([encode_prop(pt, x[2][n], pool) for x in ins],
                             cols[n].dtype)
    ends = ip[:, -1]
    emax = int((ends + np.bincount(o, minlength=P)).max())
    new = {k: np.zeros((P, emax), v.dtype) for k, v in cols.items()}
    for p in range(P):
        sel = o == p
        for k, v in cols.items():
            row = np.insert(v[p, :ends[p]], pos[sel], vals[k][sel])
            new[k][p, :row.size] = row
    add = np.zeros(ip.shape, np.int64)
    np.add.at(add, (o, lo + 1), 1)
    out = CsrBlock(etype="KNOWS", direction="out",
                   indptr=(ip + np.cumsum(add, axis=1)).astype(np.int32),
                   nbr=new.pop("nbr"), rank=new.pop("rank"), props=new,
                   prop_types=dict(blk.prop_types))
    return CsrSnapshot(space=snap.space, epoch=0, num_parts=P,
                       vmax=snap.vmax, num_vertices=snap.num_vertices,
                       blocks={("KNOWS", "out"): out}, pool=pool,
                       dense_to_vid=snap.dense_to_vid)


def timed(fn, runs: int):
    """fn()'s last result and the wall seconds of `runs` calls after one
    warm-up call."""
    lat = []
    for i in range(runs + 1):
        t = time.perf_counter()
        out = fn()
        if i:
            lat.append(time.perf_counter() - t)
    return out, lat


def store_writes(store, host, seeds, seed: int):
    """12c's writes, made from `seed` with numpy, in a random order, as
    calls on the store: ("insert", src, dst, props), ("delete", src,
    dst), ("overwrite", src, dst, {"w": new w}) and ("vertex", vid,
    props).  Deletes and overwrites take distinct live edges of the
    pinned out block; inserts take pairs of distinct persons,
    STORE_WRITES["seed_insert"] of them from a seed; each new person
    gets one edge from a seed."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import _NAMES
    rng = np.random.default_rng(seed)
    blk = host.block("KNOWS", "out")
    P = host.num_parts
    counts = blk.indptr[:, -1].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    n_pick = STORE_WRITES["delete"] + STORE_WRITES["overwrite"]
    flat = rng.choice(int(starts[-1]), n_pick, replace=False)
    part = np.searchsorted(starts, flat, side="right") - 1
    slot = flat - starts[part]
    ops = []
    for i, (p, e) in enumerate(zip(part.tolist(), slot.tolist())):
        local = int(np.searchsorted(blk.indptr[p], e, side="right")) - 1
        src = host.dense_to_vid[local * P + p]
        dst = host.dense_to_vid[int(blk.nbr[p, e])]
        if i < STORE_WRITES["delete"]:
            ops.append(("delete", src, dst))
        else:
            ops.append(("overwrite", src, dst,
                        {"w": int(rng.integers(100))}))
    n = STORE_PERSONS
    m = STORE_WRITES["insert"]
    src = rng.integers(0, n, m)
    src[:STORE_WRITES["seed_insert"]] = rng.choice(
        np.asarray(seeds), STORE_WRITES["seed_insert"])
    dst = rng.integers(0, n, m)
    for a, b in zip(src.tolist(), dst.tolist()):
        if a != b:
            ops.append(("insert", a, b, {
                "w": int(rng.integers(100)), "f": float(rng.random()),
                "city": _NAMES[int(rng.integers(len(_NAMES)))]}))
    new = []
    for k in range(STORE_WRITES["vertex"]):
        vid = n + k
        new.append(("vertex", vid, {"age": int(rng.integers(13, 90)),
                                    "name": _NAMES[k % len(_NAMES)]}))
        new.append(("insert", int(seeds[k % len(seeds)]), vid, {
            "w": int(rng.integers(100)), "f": float(rng.random()),
            "city": _NAMES[k % len(_NAMES)]}))
    ops = [ops[i] for i in rng.permutation(len(ops))]
    return ops + new          # a new person before the edge to it


def apply_store_writes(store, ops, rank: int = 0) -> None:
    for op in ops:
        if op[0] == "insert":
            store.insert_edge(STORE_SPACE, op[1], "KNOWS", op[2], rank,
                              op[3])
        elif op[0] == "delete":
            store.delete_edge(STORE_SPACE, op[1], "KNOWS", op[2], 0)
        elif op[0] == "overwrite":
            store.update_edge(STORE_SPACE, op[1], "KNOWS", op[2], 0, op[3])
        else:
            store.insert_vertex(STORE_SPACE, op[1], "Person", op[2])


def part0_inserts(n: int, seed: int, persons: int = 0):
    """n edge inserts among `persons` persons (STORE_PERSONS by default)
    whose sources all lie in part 0 (vid % 8 == 0): one (block, part) of
    a delta plane takes every row."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import _NAMES
    rng = np.random.default_rng(seed)
    persons = persons or STORE_PERSONS
    src = rng.integers(0, persons // 8, n) * 8
    dst = rng.integers(0, persons, n)
    return [("insert", int(a), int(b), {
        "w": int(rng.integers(100)), "f": float(rng.random()),
        "city": _NAMES[int(rng.integers(len(_NAMES)))]})
        for a, b in zip(src.tolist(), dst.tolist())]


def check_store_mirror(store, host, seed: int) -> dict:
    """12a: the pinned host mirror's KNOWS out block holds exactly the
    store's edges: each part's edge count, and for STORE_CHECKED seeded
    vertices their CSR row (nbr, rank, w) against the store's own
    get_neighbors walk, row for row."""
    import numpy as np
    sd = store.space(STORE_SPACE)
    blk = host.block("KNOWS", "out")
    P = host.num_parts
    per_part = []
    for p in range(P):
        n_store = sum(len(per.get("KNOWS", ())) for per in
                      sd.parts[p].out_edges.values())
        if blk.edges_of_part(p) != n_store:
            raise AssertionError(f"[12a] part {p}: {blk.edges_of_part(p)} "
                                 f"edges pinned, {n_store} in the store")
        per_part.append(n_store)
    rng = np.random.default_rng(seed)
    walked = 0
    for v in rng.choice(STORE_PERSONS, STORE_CHECKED, replace=False):
        rows = list(store.get_neighbors(STORE_SPACE, [int(v)], ["KNOWS"],
                                        "out"))
        d = sd.dense_id(int(v))
        p, li = d % P, d // P
        lo, hi = int(blk.indptr[p, li]), int(blk.indptr[p, li + 1])
        want = ([sd.dense_id(r[3]) for r in rows], [r[2] for r in rows],
                [r[4]["w"] for r in rows])
        got = (blk.nbr[p, lo:hi].tolist(), blk.rank[p, lo:hi].tolist(),
               blk.props["w"][p, lo:hi].tolist())
        if got != want:
            raise AssertionError(f"[12a] vertex {int(v)}: CSR row {got} "
                                 f"vs the store's {want}")
        walked += len(rows)
    return {"edges_per_part": per_part, "vertices_walked": STORE_CHECKED,
            "edges_walked": walked}


def store_walk(store, seeds, steps: int, where_text: str):
    """The host engine's semantics, row at a time and independent of the
    CSR: the frontier's out-edges through the store's get_neighbors,
    deduplicated into the next frontier, and the last hop through its
    storage-side filter (`edge_filter`).  Returns the (dst, w) pairs of
    the last hop, sorted."""
    from nebula_tpu_torch.query.parser import parse_expression
    frontier = sorted(set(seeds))
    for _ in range(steps - 1):
        frontier = sorted({r[3] for r in store.get_neighbors(
            STORE_SPACE, frontier, ["KNOWS"], "out")})
    filt = parse_expression(where_text)
    return sorted((r[3], r[4]["w"]) for r in store.get_neighbors(
        STORE_SPACE, frontier, ["KNOWS"], "out", edge_filter=filt))


def go_pairs(rows):
    """(d, w) pairs of a GO's rows, sorted."""
    import numpy as np
    return sorted(zip(np.asarray(rows.column_array("d")).tolist(),
                      np.asarray(rows.column_array("w")).tolist()))


def metric(name: str):
    from nebula_tpu_torch.utils.stats import stats
    return stats().snapshot().get(name, 0)


def store_go(rt, store, seeds, ns):
    """GO 3 STEPS over out-KNOWS on the store's space from `seeds`,
    unfiltered and WHERE KNOWS.w > ns.w_gt, yielding ns.yields:
    {filter label: (rows, stats)}."""
    return {fl: rt.traverse(store, STORE_SPACE, seeds, ["KNOWS"], "out", 3,
                            edge_filter=filt, yields=ns.yields)
            for fl, filt in (("unfiltered", None),
                             (f"w>{ns.w_gt}", ns.w_filter))}


def same_go(label, got, want, ordered=True, hops=None) -> None:
    """`got`'s rows equal `want`'s (a fresh pin's), in order or as a
    multiset, and its hop_edges `hops` (without a plane, `want`'s)."""
    for fl in want:
        (a, sa), (b, sb) = got[fl], want[fl]
        same = rows_equal(a, b) if ordered else go_pairs(a) == go_pairs(b)
        if not same or sa.hop_edges != (hops or sb.hop_edges):
            raise AssertionError(f"{label} {fl}: {len(a)} rows, "
                                 f"hop_edges {sa.hop_edges}, vs {len(b)} "
                                 f"and {hops or sb.hop_edges}")


def store_rebuilds(seed: int, ns) -> dict:
    """[12d]'s rebuilds, on a store of STORE_REBUILD_PERSONS built as
    [12a]'s (each rebuild is an export of the whole store: the depth is
    cut for the time limit): a batch that overflows one (block, part) of
    the plane re-pins the plane's runtime with an empty plane, and the
    same writes re-pin the runtime split at STORE_SPLIT (a split pin has
    no plane); GO 3 STEPS on each then equals a fresh pin's, the split
    one's as a multiset.  Returns the numbers; raises on any failed
    check."""
    from nebula_tpu_torch.bench.datagen import make_social_graph, pick_seeds
    from nebula_tpu_torch.gpu import GpuRuntime
    t0 = time.perf_counter()
    store = make_social_graph(STORE_REBUILD_PERSONS, STORE_DEGREE, parts=8,
                              seed=STORE_GRAPH_SEED, space=STORE_SPACE)
    out = {"persons": STORE_REBUILD_PERSONS,
           "store_build_s": time.perf_counter() - t0}
    try:
        seeds = pick_seeds(store, STORE_SPACE, STORE_SEEDS, min_degree=3)
        rta = GpuRuntime(delta_max_edges=STORE_DELTA_CAP,
                         delta_compact_watermark=2.0)
        rts, rtf = GpuRuntime(degree_split_threshold=STORE_SPLIT), \
            GpuRuntime()
        before, devs = rta.pin(store, STORE_SPACE), rts.pin(store,
                                                            STORE_SPACE)
        if before.delta is None or devs.num_hubs <= 0:
            raise AssertionError(f"[12d] plane {before.delta}, "
                                 f"{devs.num_hubs} hubs")
        apply_store_writes(store, part0_inserts(
            STORE_OVERFLOW, seed + 1, STORE_REBUILD_PERSONS), rank=2)
        pins0 = metric("tpu_pins")
        t0 = time.perf_counter()
        got = store_go(rta, store, seeds, ns)
        out["overflow_go_s"] = time.perf_counter() - t0
        deva = rta.snapshots[STORE_SPACE]
        if deva is before or not before.retired \
                or metric("tpu_pins") != pins0 + 1 \
                or deva.delta.host.total_edges() != 0:
            raise AssertionError("[12d] the overflow did not rebuild and "
                                 "re-pin")
        t0 = time.perf_counter()
        got_s = store_go(rts, store, seeds, ns)
        out["split_rebuild_go_s"] = time.perf_counter() - t0
        if rts.snapshots[STORE_SPACE] is devs \
                or metric("tpu_pins") != pins0 + 2 \
                or rts.snapshots[STORE_SPACE].num_hubs <= 0:
            raise AssertionError("[12d] the write to the split pin did not "
                                 "rebuild")
        fresh = store_go(rtf, store, seeds, ns)
        same_go("[12d] overflow", got, fresh)
        same_go("[12d] split", got_s, fresh, ordered=False)
        out["rows"] = {fl: len(r) for fl, (r, _) in fresh.items()}
        for rt in (rta, rts, rtf):
            rt.unpin(STORE_SPACE)
    finally:
        store.close()
    return out


def store_phase(K, card: str, repeats: int, seed: int, ns) -> dict:
    """Phase 12: the store path on the card.  Config 4b's store is built
    through the port's GraphStore and pinned by GpuRuntime().pin(store,
    space); GO runs on the unsplit and the split pin, writes go through
    the store's API and fold into the plane, and the runtime rebuilds
    and compacts where the reference does.  Returns the phase's numbers;
    raises on any failed check."""
    import numpy as np
    import torch
    from nebula_tpu_torch.bench.datagen import make_social_graph, pick_seeds
    from nebula_tpu_torch.gpu import GpuRuntime

    out = {}
    t12 = time.perf_counter()
    # 12a. build the store and pin it
    stamp("phase 12a")
    t0 = time.perf_counter()
    store = make_social_graph(STORE_PERSONS, STORE_DEGREE, parts=8,
                              seed=STORE_GRAPH_SEED, space=STORE_SPACE)
    build_s = time.perf_counter() - t0
    rta = GpuRuntime(delta_max_edges=STORE_DELTA_CAP,
                     delta_compact_watermark=2.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b0, pins0 = metric("tpu_snapshot_build_us.sum"), metric("tpu_pins")
    t0 = time.perf_counter()
    deva = rta.pin(store, STORE_SPACE)
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    host = deva.host
    if metric("tpu_pins") != pins0 + 1 or deva.delta is None:
        raise AssertionError("[12a] the pin did not build with a plane")
    mirror = check_store_mirror(store, host, seed)
    out["12a"] = {
        "persons": STORE_PERSONS, "edges": host.block(
            "KNOWS", "out").total_edges(),
        "store_build_s": build_s,
        "build_snapshot_s": (metric("tpu_snapshot_build_us.sum") - b0)
        / 1e6, "pin_s": pin_s, "vmax": host.vmax,
        "hbm_bytes": rta.hbm_bytes(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "mirror": mirror}
    log(f"[12a] {json.dumps(out['12a'])} | {card}")

    # 12b. GO 3 STEPS on the unsplit and the split pin
    stamp("phase 12b")
    seeds = pick_seeds(store, STORE_SPACE, STORE_SEEDS, min_degree=3)
    ns12 = SimpleNamespace(store=store, snap=host, seeds=seeds,
                           yields=ns.yields, w_filter=ns.w_filter,
                           w_gt=ns.w_gt)
    where = f"KNOWS.w > {ns.w_gt}"
    walk = store_walk(store, seeds, 3, where)
    oracle, go = {}, {}
    rts = GpuRuntime(degree_split_threshold=STORE_SPLIT)
    t0 = time.perf_counter()
    devs = rts.pin(store, STORE_SPACE)
    torch.cuda.synchronize()
    split_pin_s = time.perf_counter() - t0
    if devs.num_hubs <= 0:
        raise AssertionError("[12b] the split pin has no hubs")
    for label, rt, split in (("store unsplit", rta, False),
                             ("store split", rts, True)):
        kept = {}
        res, launches = run_go(rt, ns12, repeats, label, K, oracle,
                               keep_rows=kept, space=STORE_SPACE)
        for name in (SPLIT_KERNELS if split else UNSPLIT_KERNELS):
            if launches[name] <= 0:
                raise AssertionError(f"[12b] {label}: kernel {name} never "
                                     f"launched")
        check_hub_route(launches, f"[12b] {label}", split=split)
        rows_w = kept[f"w>{ns.w_gt}"][0]
        if go_pairs(rows_w) != walk:
            raise AssertionError(f"[12b] {label}: WHERE {where} rows differ "
                                 f"from the store's get_neighbors walk")
        n_runs = 2 * (repeats + 1)
        go[label] = {"go3": res, "launches_per_query": {
            k: v / n_runs for k, v in launches.items() if v}}
        log(f"[12b] {label}: {json.dumps(go[label])} | {card}")
    if go["store split"]["go3"]["unfiltered"]["hop_edges"] != \
            go["store unsplit"]["go3"]["unfiltered"]["hop_edges"]:
        raise AssertionError("[12b] split and unsplit hop_edges differ")
    out["12b"] = dict(go, seeds=seeds, hubs=devs.num_hubs,
                      split_threshold=STORE_SPLIT, split_pin_s=split_pin_s,
                      walk_rows=len(walk))
    log(f"[12b] split at {STORE_SPLIT}: H={devs.num_hubs} hubs, pinned "
        f"(built and split) in {split_pin_s:.2f} s")

    def both_go(rt):
        return store_go(rt, store, seeds, ns)

    def bfs_same(label, rt, rt_fresh):
        da, _ = rt.bfs(store, STORE_SPACE, [seeds[0]], ["KNOWS"], "out",
                       BFS_STEPS)
        db, _ = rt_fresh.bfs(store, STORE_SPACE, [seeds[0]], ["KNOWS"],
                             "out", BFS_STEPS)
        w = min(da.shape[1], db.shape[1])
        # a pin with a plane holds the vmax slack; one without none
        if not (np.array_equal(da[:, :w], db[:, :w])
                and (da[:, w:] == -1).all() and (db[:, w:] == -1).all()):
            raise AssertionError(f"{label}: BFS depths differ from a "
                                 f"fresh pin's")
        return int((da >= 0).sum())

    # 12c. ~10,000 writes through the store's API fold into the plane
    stamp("phase 12c")
    ops = store_writes(store, host, seeds, seed)
    t0 = time.perf_counter()
    apply_store_writes(store, ops)
    writes_s = time.perf_counter() - t0
    pins0 = metric("tpu_pins")
    t0 = time.perf_counter()
    if rta.pin(store, STORE_SPACE) is not deva \
            or deva.delta.applied_epoch != store.space(STORE_SPACE).epoch:
        raise AssertionError("[12c] the writes were not folded in place")
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    hd = deva.delta.host
    K.reset_launch_counts()
    got = both_go(rta)
    torch.cuda.synchronize()
    launches_c = counts(K)
    for name in DELTA_GO_KERNELS:
        if launches_c[name] <= 0:
            raise AssertionError(f"[12c] kernel {name} never launched")
    rtf = GpuRuntime()
    t0 = time.perf_counter()
    rtf.pin(store, STORE_SPACE)
    torch.cuda.synchronize()
    fresh_pin_s = time.perf_counter() - t0
    # over a plane hop_edges count the base's tombstoned edges too (the
    # reference's rule, hop.py:145-159)
    same_go("[12c]", got, both_go(rtf), hops=delta_rule_edges(
        host, hd, go_frontiers(rtf.snapshots[STORE_SPACE].host, seeds, 3)))
    reached = bfs_same("[12c]", rta, rtf)
    if metric("tpu_pins") != pins0 + 1:       # rtf's pin only
        raise AssertionError("[12c] the plane's runtime re-pinned")
    out["12c"] = {"writes": len(ops), "kinds": dict(STORE_WRITES),
                  "store_writes_s": writes_s, "apply_s": apply_s,
                  "insert_rows": hd.total_edges(),
                  "tombstones": hd.total_tombs(),
                  "fill_ratio": hd.fill_ratio(),
                  "fresh_pin_s": fresh_pin_s, "bfs_reached": reached,
                  "rows": {fl: len(r) for fl, (r, _) in got.items()},
                  "launches": {k: v for k, v in launches_c.items() if v}}
    log(f"[12c] {json.dumps(out['12c'])} | {card}")

    # 12d. rebuilds: an overflowing batch and a write to the split pin, on
    # a store of their own; then, on this one, a batch past the
    # compaction watermark over 12c's writes
    stamp("phase 12d")
    out["12d"] = store_rebuilds(seed, ns)
    rta.delta_compact_watermark = STORE_COMPACT_WM
    apply_store_writes(store, part0_inserts(STORE_COMPACT_WRITES, seed + 2),
                       rank=3)
    done0, before = metric("tpu_compactions"), deva
    # the apply starts the compaction; a run racing its swap would find
    # its snapshot retired (the reference's callers retry then), so this
    # pin is the only call until the thread is joined
    if rta.pin(store, STORE_SPACE) is not before:
        raise AssertionError("[12d] the writes were not folded in place")
    fill = before.delta.host.fill_ratio()
    t0 = time.perf_counter()
    thread = getattr(before, "_compact_thread", None)
    if thread is None:
        raise AssertionError(f"[12d] no compaction at fill {fill}")
    thread.join(timeout=300)
    join_s = time.perf_counter() - t0
    deva = rta.snapshots[STORE_SPACE]
    if thread.is_alive() or metric("tpu_compactions") != done0 + 1 \
            or deva is before or deva.delta.host.total_edges() \
            or deva.delta.host.total_tombs():
        raise AssertionError("[12d] the compaction did not swap in an empty "
                             "plane")
    same_go("[12d] compaction", both_go(rta), both_go(rtf))
    bfs_same("[12d] compaction", rta, rtf)
    out["12d"].update(overflow_inserts=STORE_OVERFLOW,
                      compact_inserts=STORE_COMPACT_WRITES,
                      compact_fill=fill, compact_join_s=join_s,
                      tpu_pins=metric("tpu_pins"),
                      tpu_compactions=metric("tpu_compactions"))
    out["phase_s"] = time.perf_counter() - t12
    log(f"[12d] {json.dumps(out['12d'])} | {card}")
    log(f"[12] phase 12 took {out['phase_s']:.1f} s")
    rtf.unpin(STORE_SPACE)
    # phase 13 runs nGQL on this store through rta and rts, and unpins
    # them when it ends
    return out, SimpleNamespace(store=store, rta=rta, rts=rts, seeds=seeds)


def open_engine(store, rt, tag: str, space: str = STORE_SPACE):
    """A QueryEngine on `store` (the host engine when `rt` is None) and
    a session that uses `space`."""
    from nebula_tpu_torch.exec.engine import QueryEngine
    eng = QueryEngine(store, tpu_runtime=rt)
    sess = eng.new_session()
    rs = eng.execute(sess, f"USE {space}")
    if rs.error is not None:
        raise AssertionError(f"{tag} USE: {rs.error}")
    return eng, sess


def run_stmt(es, q: str, tag: str):
    """One statement: (result, seconds to the card's idle, last_tpu_stats,
    last_tpu_fallback); an error fails the phase."""
    import torch
    eng, sess = es
    eng.qctx.last_tpu_stats = None
    eng.qctx.last_tpu_fallback = None
    t0 = time.perf_counter()
    rs = eng.execute(sess, q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rs.error is not None:
        raise AssertionError(f"{tag} {q[:80]}...: {rs.error}")
    return rs, dt, eng.qctx.last_tpu_stats, eng.qctx.last_tpu_fallback


def multiset(rs):
    return sorted(map(repr, rs.data.rows))


def counted_launches(K, fn):
    """fn() with the launch counters zeroed just before and read just
    after: (its result, the counts)."""
    import torch
    K.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, counts(K)


def runtime_calls(rt, method: str, fn):
    """fn() with the runtime's `method` recording every call made in it:
    (fn's result, [(args, kwargs), ...]) — the arguments an executor
    hands the runtime, for the bare calls a statement is held to."""
    calls = []
    orig = getattr(rt, method)

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    setattr(rt, method, rec)
    try:
        res = fn()
    finally:
        delattr(rt, method)
    return res, calls


def engine_statements(seeds):
    """Phase 13b's statements: (label, nGQL, runtime)."""
    vids = ", ".join(map(str, seeds))
    c2 = (f"GO 3 STEPS FROM {vids} OVER KNOWS WHERE KNOWS.w > 50 "
          f"YIELD dst(edge) AS d, KNOWS.w AS w")
    return [
        ("config 1", f"GO 2 STEPS FROM {vids} OVER KNOWS "
         f"YIELD dst(edge) AS d", "unsplit"),
        ("config 2", c2, "unsplit"),
        ("unfiltered", f"GO 3 STEPS FROM {vids} OVER KNOWS "
         f"YIELD dst(edge) AS d, KNOWS.w AS w", "unsplit"),
        ("reversely", f"GO 2 STEPS FROM {vids} OVER KNOWS REVERSELY "
         f"YIELD src(edge) AS s", "unsplit"),
        ("config 2 split", c2, "split"),
    ]


def engine_writes(store, seeds, seed: int):
    """Phase 13c's nGQL writes: INSERT EDGE statements of
    ENGINE_INSERT_BATCH rows from the seeds, DELETE EDGE statements of
    100 second-hop edges, and one UPDATE EDGE statement an edge for
    other second-hop edges."""
    import numpy as np
    rng = np.random.default_rng(seed)
    first = sorted({r[3] for r in store.get_neighbors(
        STORE_SPACE, seeds, ["KNOWS"], "out")})
    second = sorted({(r[0], r[3], r[2]) for r in store.get_neighbors(
        STORE_SPACE, first, ["KNOWS"], "out")})
    pick = rng.permutation(len(second))[:ENGINE_DELETES + ENGINE_UPDATES]
    edges = [second[i] for i in pick]
    # city strings the store's pool has not seen: the plane brings them
    cities = ("Ann", "Bob", "Cid", "Dee")
    rows = [f"{seeds[i % len(seeds)]}->{int(rng.integers(STORE_PERSONS))}"
            f"@{ENGINE_RANK}:({int(rng.integers(100))}, "
            f"{float(rng.random())!r}, \"{cities[i % 4]}\")"
            for i in range(ENGINE_INSERTS)]
    stmts = [f"INSERT EDGE KNOWS(w, f, city) VALUES "
             f"{', '.join(rows[i:i + ENGINE_INSERT_BATCH])}"
             for i in range(0, len(rows), ENGINE_INSERT_BATCH)]
    dels = [f"{s}->{d}@{r}" for s, d, r in edges[:ENGINE_DELETES]]
    stmts += [f"DELETE EDGE KNOWS {', '.join(dels[i:i + 100])}"
              for i in range(0, len(dels), 100)]
    stmts += [f"UPDATE EDGE ON KNOWS {s}->{d}@{r} SET w = "
              f"{int(rng.integers(100))}"
              for s, d, r in edges[ENGINE_DELETES:]]
    return stmts, {"inserts": ENGINE_INSERTS, "deletes": len(dels),
                   "updates": len(edges) - len(dels)}


def engine_phase(K, card: str, st12, seed: int) -> tuple:
    """Phase 13: nGQL statements through the port's QueryEngine on phase
    12's store and two of its runtimes, each against a host engine on
    the same store.  Returns (the phase's numbers, the launches of one
    run of each device statement); raises on any failed check."""
    import numpy as np

    out = {}
    t13 = time.perf_counter()
    store, seeds = st12.store, st12.seeds
    rts = {"unsplit": st12.rta, "split": st12.rts}

    # 13a. engines and plans
    stamp("phase 13a")
    engines = {k: open_engine(store, rt, "[13a]") for k, rt in rts.items()}
    host = open_engine(store, None, "[13a]")

    def run(es, q):
        return run_stmt(es, q, "[13]")

    def plan_of(es, q):
        return run(es, "EXPLAIN " + q)[0].data.rows[0][0]

    stmts = engine_statements(seeds)
    for label, q, layout in stmts:
        plan = plan_of(engines[layout], q)
        if plan.count("TpuTraverse") != 1 or "ExpandAll" in plan:
            raise AssertionError(f"[13a] {label}: the plan is not one "
                                 f"TpuTraverse node:\n{plan}")
    log(f"[13a] {len(stmts)} statements plan to one TpuTraverse node "
        f"each, no ExpandAll")

    def bare_args(rt, es, q):
        """The arguments the TpuTraverse executor hands the runtime."""
        _, calls = runtime_calls(rt, "traverse", lambda: run(es, q))
        if len(calls) != 1:
            raise AssertionError(f"[13] {len(calls)} runtime calls")
        return calls[0]

    def statement(tag, label, q, layout, runs):
        """One warm-up (which folds or rebuilds as the pin needs), then
        `runs` timed runs with their launches; rows, fallback and
        launches against the host engine and the bare call."""
        rt, es = rts[layout], engines[layout]
        pins0 = metric("tpu_pins")
        (a, kw) = bare_args(rt, es, q)
        warm_pins = metric("tpu_pins") - pins0
        hits0 = metric("plan_cache_hits")
        lat, dev_s, launches = [], [], None
        for _ in range(runs):
            (rs, dt, st, fb), got = counted_launches(
                K, lambda: run(es, q))
            if st is None or fb is not None:
                raise AssertionError(f"{tag} {label}: stats {st}, "
                                     f"fallback {fb}")
            if launches is not None and got != launches:
                raise AssertionError(f"{tag} {label}: launches {got} then "
                                     f"{launches}")
            launches = got
            lat.append(dt)
            dev_s.append(st.device_s)
        hits = metric("plan_cache_hits") - hits0
        if hits < runs:
            raise AssertionError(f"{tag} {label}: {hits} plan-cache hits "
                                 f"in {runs} runs")
        bare_lat = []
        for _ in range(runs):
            t0 = time.perf_counter()
            (rows_b, _), bare = counted_launches(
                K, lambda: rt.traverse(*a, **kw))
            bare_lat.append(time.perf_counter() - t0)
        if bare != launches:
            raise AssertionError(f"{tag} {label}: the engine launched "
                                 f"{launches}, the bare call {bare}")
        for name in ENGINE_KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{tag} {label}: kernel {name} never "
                                     f"launched")
        if kw.get("edge_filter") is not None \
                and launches.get("predicate_mask", 0) <= 0:
            raise AssertionError(f"{tag} {label}: no predicate_mask")
        check_hub_route(launches, f"{tag} {label}", split=layout == "split")
        launches = {k: v for k, v in launches.items() if v}
        host_lat = []
        for _ in range(ENGINE_HOST_RUNS):
            rs_h, dt, _, _ = run(host, q)
            host_lat.append(dt)
        if multiset(rs) != multiset(rs_h) or len(rows_b) != len(rs_h.data):
            raise AssertionError(f"{tag} {label}: {len(rs.data)} device "
                                 f"rows, {len(rs_h.data)} host rows")
        p50 = float(np.median(lat)) * 1e3
        bare_p50 = float(np.median(bare_lat)) * 1e3
        res = {"rows": len(rs_h.data), "p50_ms": p50,
               "host_p50_ms": float(np.median(host_lat)) * 1e3,
               "bare_p50_ms": bare_p50, "overhead_ms": p50 - bare_p50,
               "device_loop_ms": float(np.median(dev_s)) * 1e3,
               "warmup_pins": warm_pins, "plan_cache_hits": hits,
               "launches": launches}
        log(f"{tag} {label}: {json.dumps(res)} | {card}")
        return res, launches

    # 13b. the reads
    stamp("phase 13b")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    reads = {}
    for label, q, layout in stmts:
        reads[label], launches = statement("[13b]", label, q, layout,
                                           ENGINE_RUNS)
        add(launches)
    if reads["config 2 split"]["warmup_pins"] != 1:
        raise AssertionError("[13b] the stale split pin did not rebuild "
                             "once")
    out["13b"] = reads

    # 13c. nGQL writes fold into the unsplit runtime's plane
    stamp("phase 13c")
    rts["unsplit"].delta_compact_watermark = ENGINE_WATERMARK
    writes, kinds = engine_writes(store, seeds, seed)
    t0 = time.perf_counter()
    for q in writes:
        run(engines["unsplit"], q)
    writes_s = time.perf_counter() - t0
    dev = rts["unsplit"].snapshots[STORE_SPACE]
    pins0 = metric("tpu_pins")
    res, launches = statement("[13c]", "config 2 after the writes",
                              stmts[1][1], "unsplit", 1)
    if metric("tpu_pins") != pins0 or \
            rts["unsplit"].snapshots[STORE_SPACE] is not dev or \
            launches.get("merge_delta", 0) <= 0:
        raise AssertionError("[13c] the writes were not folded into the "
                             "plane")
    add(launches)
    hd = dev.delta.host
    out["13c"] = dict(res, statements=len(writes), writes_s=writes_s,
                      insert_rows=hd.total_edges(),
                      tombstones=hd.total_tombs(),
                      fill_ratio=hd.fill_ratio(), **kinds)
    log(f"[13c] {len(writes)} write statements in {writes_s:.2f} s, "
        f"{json.dumps(kinds)}, the plane at fill {hd.fill_ratio():.4f}")

    # 13d. a filter the rule refuses runs on the host, no kernel launched
    stamp("phase 13d")
    # one step: on a longer GO the rule still fuses the hops below the
    # refused last one, as the reference's does
    q = (f"GO FROM {', '.join(map(str, seeds))} OVER KNOWS WHERE "
         f"upper(KNOWS.city) == \"ADA\" YIELD dst(edge) AS d, KNOWS.w AS w")
    if "TpuTraverse" in plan_of(engines["unsplit"], q):
        raise AssertionError("[13d] the rule fused a refused filter")
    (rs, dt, _, _), launches = counted_launches(
        K, lambda: run(engines["unsplit"], q))
    if any(launches.values()):
        raise AssertionError(f"[13d] kernels launched: {launches}")
    rs_h = run(host, q)[0]
    if multiset(rs) != multiset(rs_h):
        raise AssertionError("[13d] rows differ from the host engine's")
    out["13d"] = {"rows": len(rs_h.data), "ms": dt * 1e3}
    log(f"[13d] GO 1 STEP WHERE upper(KNOWS.city) on the host: "
        f"{json.dumps(out['13d'])} | {card}")

    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t13
    log(f"[13] phase 13 took {out['phase_s']:.1f} s")
    # phase 14 runs MATCH, the paths and the algorithms on this store
    # through the same runtimes, and unpins them when it ends
    return out, total


def match_statements(store, seeds, seed: int):
    """Phase 14's statements: {key: nGQL} and the config-4b seeds."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import pick_seeds
    c4b_seeds = pick_seeds(store, STORE_SPACE, MATCH_SEEDS, min_degree=3)
    v16 = ", ".join(map(str, seeds))
    srcs = seeds[:PATH_SRCS]
    one = sorted({r[3] for r in store.get_neighbors(
        STORE_SPACE, srcs, ["KNOWS"], "out")})
    two = sorted({r[3] for r in store.get_neighbors(
        STORE_SPACE, one, ["KNOWS"], "out")} - set(srcs))
    rng = np.random.default_rng(seed)
    near = [two[i] for i in sorted(rng.permutation(len(two))
                                   [:PATH_DSTS // 2])]
    far = [int(v) for v in rng.choice(STORE_PERSONS, PATH_DSTS - len(near),
                                      replace=False)]
    s_, d_ = ", ".join(map(str, srcs)), ", ".join(map(str, near + far))
    path = f"FROM {s_} TO {d_} OVER KNOWS"
    return {
        "config 4b": f"MATCH (a:Person)-[e:KNOWS*1..{C4B_HOPS}]->(b) WHERE "
                     f"id(a) IN [{', '.join(map(str, c4b_seeds))}] "
                     f"RETURN count(*) AS paths",
        "*1..3": f"MATCH (a:Person)-[e:KNOWS*1..3]->(b) WHERE id(a) IN "
                 f"[{v16}] RETURN id(b) AS b, size(e) AS n",
        # the inline map is the edge filter the device applies as its
        # WHERE mask at every hop
        "*1..3 {city}": f"MATCH (a:Person)-[e:KNOWS*1..3 {{city: \"ada\"}}]"
                        f"->(b) WHERE id(a) IN [{v16}] RETURN id(b) AS b, "
                        f"size(e) AS n",
        # a var-length `e` is a list, so `e.w > 50` holds for no row
        # there; on one hop the optimizer pushes it into the Traverse,
        # where the alias spelling does not compile: the frames come
        # unfiltered and the executor rechecks each edge on the host
        "one hop, e.w > 50": f"MATCH (a:Person)-[e:KNOWS]->(b) WHERE id(a) "
                             f"IN [{v16}] AND e.w > 50 RETURN id(b) AS b, "
                             f"e.w AS w",
        "shortest": f"FIND SHORTEST PATH {path} UPTO {SHORTEST_UPTO} STEPS "
                    f"YIELD path AS p",
        "shortest, w > 50": f"FIND SHORTEST PATH {path} WHERE KNOWS.w > 50 "
                            f"UPTO {SHORTEST_UPTO} STEPS YIELD path AS p",
        "all paths": f"FIND ALL PATH {path} UPTO {ALL_PATH_UPTO} STEPS "
                     f"YIELD path AS p",
        "subgraph": f"GET SUBGRAPH {SUBGRAPH_STEPS} STEPS FROM {v16} OUT "
                    f"KNOWS YIELD VERTICES AS v, EDGES AS e",
    }, c4b_seeds


def match_phase(K, card: str, st12, seed: int) -> tuple:
    """Phase 14: MATCH, config 4b's fused MATCH aggregate, FIND SHORTEST
    and ALL PATH, GET SUBGRAPH and CALL algo.* through the port's
    QueryEngine on phase 12's store as phase 13 left it (its writes
    pending on the unsplit runtime's plane), on that runtime and the one
    split at 64.  Each statement's launches equal those of the bare
    runtime calls its executor made, with their own arguments; its rows
    equal the host engine's, or the oracle's.  Returns (the phase's
    numbers, the launches of one run of each device statement); raises
    on any failed check."""
    import numpy as np
    from nebula_tpu_torch.algo import engine as AE
    from nebula_tpu_torch.bench.datagen import host_trail_paths

    out, total = {}, {}
    t14 = time.perf_counter()
    store, seeds = st12.store, st12.seeds
    rts = {"unsplit": st12.rta, "split": st12.rts}
    engines = {k: open_engine(store, rt, "[14a]") for k, rt in rts.items()}
    host = open_engine(store, None, "[14a]")
    host_res = {}           # the store holds still through this phase

    def host_rows(q):
        if q not in host_res:
            rs, dt, _, _ = run_stmt(host, q, "[14]")
            host_res[q] = rs, dt * 1e3
        return host_res[q]

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def statement(tag, label, layout, q, method, check, kernels=(),
                  runs=MATCH_ENGINE_RUNS):
        """A warm-up that records the runtime calls of `method` the
        executor makes, then `runs` timed runs, launch counters zeroed
        just before each and read just after; the bare calls made again
        as many times; `check(result)` holds the rows."""
        rt, es = rts[layout], engines[layout]
        pins0 = metric("tpu_pins")
        _, calls = runtime_calls(rt, method, lambda: run_stmt(es, q, tag))
        warm_pins = metric("tpu_pins") - pins0
        if not calls:
            raise AssertionError(f"{tag} {label} ({layout}): the runtime "
                                 f"was not asked")
        lat, dev_s, launches = [], [], None
        for _ in range(runs):
            (rs, dt, st, fb), got = counted_launches(
                K, lambda: run_stmt(es, q, tag))
            if st is None or fb is not None:
                raise AssertionError(f"{tag} {label} ({layout}): stats "
                                     f"{st}, fallback {fb}")
            if launches is not None and got != launches:
                raise AssertionError(f"{tag} {label} ({layout}): launches "
                                     f"{got} then {launches}")
            launches = got
            lat.append(dt)
            dev_s.append(st.device_s)
        bare_lat = []
        for _ in range(runs):
            t0 = time.perf_counter()
            _, bare = counted_launches(K, lambda: [
                getattr(rt, method)(*a, **k) for a, k in calls])
            bare_lat.append(time.perf_counter() - t0)
        if bare != launches:
            raise AssertionError(f"{tag} {label} ({layout}): the engine "
                                 f"launched {launches}, the bare calls "
                                 f"{bare}")
        for name in kernels:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{tag} {label} ({layout}): kernel "
                                     f"{name} never launched")
        check_hub_route(launches, f"{tag} {label} ({layout})",
                        split=layout == "split")
        launches = {k: v for k, v in launches.items() if v}
        add(launches)
        p50 = float(np.median(lat)) * 1e3
        bare_p50 = float(np.median(bare_lat)) * 1e3
        res = {"rows": len(rs.data), "p50_ms": p50, "bare_p50_ms": bare_p50,
               "overhead_ms": p50 - bare_p50,
               "device_loop_ms": float(np.median(dev_s)) * 1e3,
               "runtime_calls": len(calls), "warmup_pins": warm_pins,
               "launches": launches}
        res.update(check(rs) or {})
        log(f"{tag} {label} ({layout}): {json.dumps(res)} | {card}")
        return res, calls

    def same_rows(q, ordered):
        """The host engine's rows, in order or as a multiset."""
        def check(rs):
            h, host_ms = host_rows(q)
            a, b = ([repr(r) for r in x.data.rows] for x in (rs, h))
            if (a != b) if ordered else (sorted(a) != sorted(b)):
                raise AssertionError(f"[14] {len(a)} device rows, {len(b)} "
                                     f"host rows: {q[:80]}...")
            if not a:
                raise AssertionError(f"[14] no rows: {q[:80]}...")
            return {"host_ms": host_ms}
        return check

    qs, c4b_seeds = match_statements(store, seeds, seed)

    # 14a. config 4b plans one TpuMatchAgg node
    stamp("phase 14a")
    for layout, es in engines.items():
        plan = run_stmt(es, "EXPLAIN " + qs["config 4b"],
                        "[14a]")[0].data.rows[0][0]
        if plan.count("TpuMatchAgg") != 1 \
                or "Traverse" in plan.replace("TpuMatchAgg", ""):
            raise AssertionError(f"[14a] config 4b ({layout}) is not one "
                                 f"TpuMatchAgg node:\n{plan[:400]}")
    # the single-clause MATCH statements keep their Traverse: the
    # reference's pipeline rule fuses only multi-clause pipelines
    for label in ("*1..3", "*1..3 {city}", "one hop, e.w > 50"):
        plan = run_stmt(engines["unsplit"], "EXPLAIN " + qs[label],
                        "[14a]")[0].data.rows[0][0]
        if "TpuMatchPipeline" in plan or "Traverse" not in plan:
            raise AssertionError(f"[14a] {label}: not the reference's "
                                 f"Traverse plan:\n{plan[:400]}")
    log(f"[14a] config 4b's MATCH *1..{C4B_HOPS} from {len(c4b_seeds)} "
        f"seeds plans to one TpuMatchAgg node on both runtimes; the "
        f"single-clause MATCH statements plan a Traverse, as the "
        f"reference's three rules do")

    res = {}
    # 14b. MATCH's Traverse on the device, unfiltered and with the mask
    stamp("phase 14b")
    for layout in rts:
        for label in ("*1..3", "*1..3 {city}", "one hop, e.w > 50"):
            q = qs[label]
            filt = "city" in label
            r, calls = statement(
                "[14b]", label, layout, q, "traverse_hops",
                same_rows(q, False),
                ENGINE_KERNELS + (("predicate_mask",) if filt else ()))
            if (calls[0][1].get("edge_filter") is not None) != filt:
                raise AssertionError(f"[14b] {label}: edge_filter "
                                     f"{calls[0][1].get('edge_filter')}")
            res[f"{label} ({layout})"] = r
    out["14b"] = {k: v for k, v in res.items()}

    # 14c. config 4b's count(*) against host_trail_paths
    stamp("phase 14c")
    t0 = time.perf_counter()
    # the host engine's own snapshot of the store as it stands: a fresh
    # build_snapshot, which its CALL algo.* statements in 14f reuse
    snap, sd = AE._host_snapshot(host[0].qctx, STORE_SPACE)
    want = host_trail_paths(snap, [sd.dense_id(v) for v in c4b_seeds],
                            C4B_HOPS)
    oracle_s = time.perf_counter() - t0
    del snap

    def trails(rs):
        got = [list(r) for r in rs.data.rows]
        if got != [[want]]:
            raise AssertionError(f"[14c] {got} trails, host_trail_paths "
                                 f"{want}")
        return {"trails": want, "oracle_s": oracle_s}

    c4b = {}
    for layout in rts:
        c4b[layout], _ = statement("[14c]", "config 4b", layout,
                                   qs["config 4b"], "traverse_hops", trails,
                                   ENGINE_KERNELS, runs=C4B_RUNS)
    out["14c"] = c4b

    # 14d. FIND SHORTEST PATH: one BFS a source
    stamp("phase 14d")
    res = {}
    for layout in rts:
        for label in ("shortest", "shortest, w > 50"):
            q = qs[label]
            r, calls = statement("[14d]", label, layout, q, "bfs",
                                 same_rows(q, True),
                                 ("expand", "mark", "bfs_level")
                                 + (("predicate_mask",) if "w" in label
                                    else ()))
            if len(calls) != PATH_SRCS:
                raise AssertionError(f"[14d] {label}: {len(calls)} BFS "
                                     f"runs for {PATH_SRCS} sources")
            res[f"{label} ({layout})"] = r
    out["14d"] = res

    # 14e. FIND ALL PATH and GET SUBGRAPH over traverse_hops frames
    stamp("phase 14e")
    res = {}
    for layout in rts:
        for label in ("all paths", "subgraph"):
            q = qs[label]
            res[f"{label} ({layout})"], _ = statement(
                "[14e]", label, layout, q, "traverse_hops",
                same_rows(q, True), ENGINE_KERNELS)
    out["14e"] = res

    # 14f. CALL algo.* with phase 13c's writes pending on the plane: the
    # first statement re-pins once, then each runs on that snapshot
    stamp("phase 14f")
    rt, es = rts["unsplit"], engines["unsplit"]
    hd = rt.snapshots[STORE_SPACE].delta.host
    pending = hd.total_edges() + hd.total_tombs()
    if not pending:
        raise AssertionError("[14f] the plane holds no writes")
    pins0 = metric("tpu_pins")
    res = {}
    for func, params in ALGO_CALLS:
        params = dict(params, **({"src": seeds[0]} if func == "sssp"
                                 else {}))
        q = f"CALL algo.{func}(" + ", ".join(
            f"{k}={json.dumps(v)}" for k, v in params.items()) + ")"
        (rs, dt, _, _), launches = counted_launches(
            K, lambda: run_stmt(es, q, "[14f]"))
        snap = rt.snapshots[STORE_SPACE].host
        t0 = time.perf_counter()
        (rows_b, info), bare = counted_launches(K, lambda: AE.run_algorithm(
            func, params, snap, store.space(STORE_SPACE), rt=rt))
        bare_ms = (time.perf_counter() - t0) * 1e3
        kname = ALGO_KERNELS[func]
        if launches != bare or launches[kname] != info["iterations"] \
                or info["mode"] != "device":
            raise AssertionError(f"[14f] {func}: the engine launched "
                                 f"{launches}, run_algorithm {bare} in "
                                 f"{info['iterations']} iterations")
        rows = [list(r) for r in rs.data.rows]
        h, host_ms = host_rows(q)
        hrows = [list(r) for r in h.data.rows]
        if rows != rows_b or [r[0] for r in rows] != [r[0] for r in hrows]:
            raise AssertionError(f"[14f] {func}: {len(rows)} rows, "
                                 f"run_algorithm {len(rows_b)}, host "
                                 f"{len(hrows)}")
        err = max((abs(a[1] - b[1]) for a, b in zip(rows, hrows)),
                  default=0.0)
        if err > (PAGERANK_RUN_TOL if func == "pagerank" else 0.0):
            raise AssertionError(f"[14f] {func}: {err} from the host")
        launches = {k: v for k, v in launches.items() if v}
        add(launches)
        res[func] = {"rows": len(rows), "iterations": info["iterations"],
                     "ms": dt * 1e3, "bare_ms": bare_ms, "host_ms": host_ms,
                     "max_abs_err_vs_host": err, "launches": launches}
        log(f"[14f] {q}: {json.dumps(res[func])} | {card}")
    repins = metric("tpu_pins") - pins0
    hd = rt.snapshots[STORE_SPACE].delta.host
    if repins != 1 or hd.total_edges() or hd.total_tombs():
        raise AssertionError(f"[14f] {repins} re-pins with {pending} "
                             f"pending writes")
    out["14f"] = dict(res, pending_writes=pending, repins=repins)

    for rt in rts.values():
        rt.unpin(STORE_SPACE)
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t14
    log(f"[14] phase 14 took {out['phase_s']:.1f} s")
    return out, total


_NUMBERED = re.compile(r"(#|\bn|_)(\d+)\b")


def canon_plan(text: str) -> str:
    """Renumber plan node ids and numbered names in order of first
    appearance, so two engines' EXPLAIN texts compare (a copy of
    tests/test_torch_tck.py's)."""
    seen = {}

    def sub(m):
        key = (m.group(1), m.group(2))
        seen.setdefault(key, len([k for k in seen if k[0] == m.group(1)]))
        return f"{m.group(1)}{seen[key]}"
    return _NUMBERED.sub(sub, text)


def program_digest(ops) -> str:
    """sha256 of a segment program's repr through `canon_plan`."""
    import hashlib
    return hashlib.sha256(canon_plan(repr(ops)).encode()).hexdigest()


def ic_statements():
    """IC5 and IC9 as bench.py:792-814 writes them."""
    return {
        "IC5": (f"MATCH (person:Person)-[:KNOWS*1..2]-(friend:Person) "
                f"WHERE id(person) == {IC_ROOT} AND id(friend) != {IC_ROOT} "
                f"WITH DISTINCT friend "
                f"MATCH (friend)<-[membership:HAS_MEMBER]-(forum:Forum) "
                f"WHERE membership.joinDate > {IC_MIN_DATE} "
                f"WITH DISTINCT friend, forum "
                f"OPTIONAL MATCH (friend)<-[:HAS_CREATOR]-(post:Post)"
                f"<-[:CONTAINER_OF]-(forum) "
                f"WITH forum, count(post) AS postCount "
                f"RETURN forum.Forum.title AS forumName, postCount "
                f"ORDER BY postCount DESC, forumName ASC LIMIT 20"),
        "IC9": (f"MATCH (root:Person)-[:KNOWS*1..2]-(friend:Person) "
                f"WHERE id(root) == {IC_ROOT} AND id(friend) != {IC_ROOT} "
                f"WITH DISTINCT friend "
                f"MATCH (friend)<-[:HAS_CREATOR]-(message) "
                f"WHERE message.creationDate < {IC_MAX_DATE} "
                f"RETURN id(friend) AS fid, id(message) AS mid, "
                f"message.creationDate AS d ORDER BY d DESC, mid ASC "
                f"LIMIT 20"),
    }


def pipeline_programs(PL, fn):
    """fn() with the segment program of every fused pipeline run in it
    recorded: (fn's result, [ops, ...])."""
    progs = []
    orig = PL._Runner.run

    def run(runner, ops):
        progs.append(ops)
        return orig(runner, ops)
    PL._Runner.run = run
    try:
        res = fn()
    finally:
        PL._Runner.run = orig
    return res, progs


def fallbacks() -> int:
    from nebula_tpu_torch.utils.stats import stats
    return sum(v for k, v in stats().snapshot().items()
               if k.startswith("match_pipeline_fallback"))


def ic_writes(arrs, top_forums, seed: int):
    """Phase 15c's nGQL writes, from `seed`: IC_POSTS new Posts (LDBC
    IU6) dated just below IC9's bound, each created by one of the
    root's 1..2-hop friends (HAS_CREATOR) in a forum that friend joined
    after IC5's bound (CONTAINER_OF); IC_UNJOIN such memberships deleted
    (HAS_MEMBER); and the title of IC_RETITLE of IC5's top forums
    rewritten (a tag column).  Returns (statements, counts)."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import _friends_1_2
    rng = np.random.default_rng(seed)
    fr = set(_friends_1_2(arrs, IC_ROOT).tolist())
    qual = {}
    for f, p, d in zip(arrs["mem_f"].tolist(), arrs["mem_p"].tolist(),
                       arrs["mem_d"].tolist()):
        if p in fr and d > IC_MIN_DATE:
            qual.setdefault(p, []).append(f)
    members = sorted(qual)
    f0, v0 = arrs["f0"], arrs["c0"] + arrs["n_comments"]
    posts, creators, containers = [], [], []
    for j in range(IC_POSTS):
        p = members[int(rng.integers(len(members)))]
        f = qual[p][int(rng.integers(len(qual[p])))]
        date = int(rng.integers(IC_MAX_DATE - 100, IC_MAX_DATE))
        posts.append(f'{v0 + j}:({date}, "ic15_{j}")')
        creators.append(f"{v0 + j}->{p}:()")
        containers.append(f"{f0 + f}->{v0 + j}:()")
    stmts = [f"INSERT VERTEX Post(creationDate, content) VALUES "
             f"{', '.join(posts)}",
             f"INSERT EDGE HAS_CREATOR() VALUES {', '.join(creators)}",
             f"INSERT EDGE CONTAINER_OF() VALUES {', '.join(containers)}"]
    pairs = sorted({(f, p) for p, fs in qual.items() for f in fs})
    pick = sorted(rng.permutation(len(pairs))[:IC_UNJOIN].tolist())
    stmts.append("DELETE EDGE HAS_MEMBER " + ", ".join(
        f"{f0 + pairs[i][0]}->{pairs[i][1]}" for i in pick))
    for i, f in enumerate(top_forums[:IC_RETITLE]):
        stmts.append(f'UPDATE VERTEX ON Forum {f} SET title = '
                     f'"retitled{i}"')
    return stmts, {"posts": IC_POSTS, "unjoined": len(pick),
                   "retitled": min(IC_RETITLE, len(top_forums))}


def device_tags_equal_host(dev) -> int:
    """Every pinned tag tensor against the host mirror's column; returns
    the tag tables' bytes.  Raises on a difference."""
    import numpy as np
    nbytes = 0
    for name, t in dev.host.tags.items():
        d = dev.tags[name]
        for col, want in (("present", t.present), *t.props.items()):
            got = (d.present if col == "present" else d.props[col])
            got = got.cpu().numpy()
            if got.shape != want.shape or not np.array_equal(
                    got, want, equal_nan=want.dtype.kind == "f"):
                raise AssertionError(f"[15c] device tag {name}.{col} "
                                     f"differs from the host mirror")
            nbytes += got.nbytes
    return nbytes


def pipeline_phase(K, card: str, persons: int, seed: int) -> tuple:
    """Phase 15: LDBC IC5 and IC9 (bench.py:786-830) through the port's
    QueryEngine, each fused into one TpuMatchPipeline node, on
    make_snb_interactive(persons) with an unsplit runtime (a delta
    plane) and one split at IC_SPLIT, each statement against the numpy
    oracles and a host engine on the same store, then through nGQL
    writes.  Returns (the phase's numbers, the launches of one run of
    each statement); raises on any failed check."""
    import numpy as np
    from nebula_tpu_torch.bench.datagen import (ic5_numpy, ic9_numpy,
                                                make_snb_interactive)
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu import pipeline as PL

    out, total = {}, {}
    t15 = time.perf_counter()
    stamp("phase 15a")
    t0 = time.perf_counter()
    store, arrs = make_snb_interactive(persons, parts=IC_PARTS)
    build_s = time.perf_counter() - t0
    rts = {"unsplit": GpuRuntime(delta_max_edges=STORE_DELTA_CAP),
           "split": GpuRuntime(degree_split_threshold=IC_SPLIT)}
    engines = {k: open_engine(store, rt, "[15a]", IC_SPACE)
               for k, rt in rts.items()}
    host = open_engine(store, None, "[15a]", IC_SPACE)
    qs = ic_statements()
    oracles = {
        "IC5": [tuple(t) for t in ic5_numpy(arrs, IC_ROOT, IC_MIN_DATE)],
        "IC9": [tuple(t) for t in ic9_numpy(arrs, IC_ROOT, IC_MAX_DATE)]}
    out["graph"] = {k: arrs[k] for k in ("n_persons", "n_forums",
                                         "n_posts", "n_comments")}
    out["graph"].update(knows_pairs=len(arrs["know_pairs"]),
                        memberships=int(arrs["mem_f"].size),
                        build_s=build_s)
    log(f"[15a] make_snb_interactive({persons}, parts={IC_PARTS}): "
        f"{json.dumps(out['graph'])}")

    # 15a. each statement plans the reference's one TpuMatchPipeline node
    for layout, es in engines.items():
        for name, q in qs.items():
            plan = canon_plan(run_stmt(es, "EXPLAIN " + q, "[15a]")[0]
                              .data.rows[0][0])
            if plan != IC_PLANS[name]:
                raise AssertionError(f"[15a] {name} ({layout}) plans\n"
                                     f"{plan}\nnot the reference's\n"
                                     f"{IC_PLANS[name]}")
    log("[15a] IC5 and IC9 plan the reference's TpuMatchPipeline node on "
        "both runtimes")

    host_res = {}

    def host_rows(name):
        if name not in host_res:
            rs, dt, _, _ = run_stmt(host, qs[name], "[15]")
            host_res[name] = [repr(r) for r in rs.data.rows], dt * 1e3
        return host_res[name]

    def statement(tag, layout, name, oracle=None, kernels=()):
        """A warm-up that records the segment program and the
        traverse_hops calls of its chains, then IC_RUNS timed runs with
        the launch counters zeroed just before each and read just after,
        the bare calls made again as many times, and one PROFILE."""
        rt, es = rts[layout], engines[layout]
        q = qs[name]
        pins0, avoided0 = metric("tpu_pins"), metric("tpu_repin_avoided")
        (_, calls), progs = pipeline_programs(PL, lambda: runtime_calls(
            rt, "traverse_hops", lambda: run_stmt(es, q, tag)))
        warm = {"pins": metric("tpu_pins") - pins0,
                "repins_avoided": metric("tpu_repin_avoided") - avoided0}
        if len(progs) != 1 \
                or program_digest(progs[0]) != IC_PROGRAMS[name]:
            raise AssertionError(f"{tag} {name} ({layout}): ran "
                                 f"{len(progs)} programs, not the "
                                 f"reference's: {progs[:1]!r}")
        chains = sum(op["op"] == "chain" for op in progs[0])
        if len(calls) != chains:
            raise AssertionError(f"{tag} {name} ({layout}): {len(calls)} "
                                 f"traverse_hops calls for {chains} chains")
        lat, dev_s, launches = [], [], None
        for _ in range(IC_RUNS):
            fused0, fb0 = metric("match_pipeline_fused"), fallbacks()
            (rs, dt, st, fb), got = counted_launches(
                K, lambda: run_stmt(es, q, tag))
            if st is None or fb is not None \
                    or metric("match_pipeline_fused") != fused0 + 1 \
                    or fallbacks() != fb0:
                raise AssertionError(f"{tag} {name} ({layout}): not fused "
                                     f"(stats {st}, fallback {fb})")
            if launches is not None and got != launches:
                raise AssertionError(f"{tag} {name} ({layout}): launches "
                                     f"{got} then {launches}")
            launches = got
            lat.append(dt)
            dev_s.append(st.device_s)
        bare_lat = []
        for _ in range(IC_RUNS):
            t0 = time.perf_counter()
            _, bare = counted_launches(K, lambda: [
                rt.traverse_hops(*a, **k) for a, k in calls])
            bare_lat.append(time.perf_counter() - t0)
        if bare != launches:
            raise AssertionError(f"{tag} {name} ({layout}): the engine "
                                 f"launched {launches}, the bare calls "
                                 f"{bare}")
        for kname in IC_KERNELS + tuple(kernels):
            if launches.get(kname, 0) <= 0:
                raise AssertionError(f"{tag} {name} ({layout}): kernel "
                                     f"{kname} never launched")
        check_hub_route(launches, f"{tag} {name} ({layout})",
                        split=layout == "split")
        rows = [repr(r) for r in rs.data.rows]
        hrows, host_ms = host_rows(name)
        if rows != hrows or len(rows) != 20:
            raise AssertionError(f"{tag} {name} ({layout}): {len(rows)} "
                                 f"rows, the host engine's {len(hrows)}, "
                                 f"not equal in order")
        if oracle is not None and [tuple(r) for r in rs.data.rows] \
                != oracle:
            raise AssertionError(f"{tag} {name} ({layout}): rows differ "
                                 f"from the numpy oracle")
        prof = run_stmt(es, "PROFILE " + q, tag)[0]
        segs = [ln.strip() for ln in (prof.plan_desc or "").splitlines()
                if "segment:" in ln]
        if not segs or not any("segment:result" in ln for ln in segs):
            raise AssertionError(f"{tag} {name} ({layout}): PROFILE shows "
                                 f"no segments")
        launches = {k: v for k, v in launches.items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        p50 = float(np.median(lat)) * 1e3
        res = {"rows": len(rows), "p50_ms": p50,
               "bare_p50_ms": float(np.median(bare_lat)) * 1e3,
               "host_ms": host_ms,
               "device_loop_ms": float(np.median(dev_s)) * 1e3,
               "chains": chains, "hop_edges": list(st.hop_edges),
               "warmup": warm, "launches": launches}
        log(f"{tag} {name} ({layout}): {json.dumps(res)} | {card}")
        for ln in segs:
            log(f"{tag}   {ln}")
        return res, rs

    # 15b. rows against the oracles and the host engine
    stamp("phase 15b")
    res, top = {}, []
    for layout in rts:
        for name in qs:
            r, rs = statement("[15b]", layout, name, oracles[name],
                              ("predicate_mask",) if name == "IC5" else ())
            res[f"{name} ({layout})"] = r
            if name == "IC5":
                top = [arrs["f0"] + int(row[0][len("forum"):])
                       for row in rs.data.rows]
    out["15b"] = res

    # 15c. nGQL writes folded into the plane, then both statements again
    stamp("phase 15c")
    stmts, wfacts = ic_writes(arrs, top, seed)
    t0 = time.perf_counter()
    for q in stmts:
        run_stmt(engines["unsplit"], q, "[15c]")
    write_s = time.perf_counter() - t0
    host_res.clear()
    dev = rts["unsplit"].snapshots[IC_SPACE]
    avoided0 = metric("tpu_repin_avoided")
    res = {}
    for layout in rts:
        for name in qs:
            res[f"{name} ({layout})"], _ = statement(
                "[15c]", layout, name,
                kernels=("merge_delta",) if layout == "unsplit" else ())
    avoided = metric("tpu_repin_avoided") - avoided0
    if avoided != 1 or rts["unsplit"].snapshots[IC_SPACE] is not dev:
        raise AssertionError(f"[15c] {avoided} re-pins avoided; the writes "
                             f"were not folded into the plane once")
    hd = dev.delta.host
    tag_bytes = device_tags_equal_host(dev)
    fresh = open_engine(store, GpuRuntime(), "[15c]", IC_SPACE)
    for name, q in qs.items():
        rs, _, st, fb = run_stmt(fresh, q, "[15c]")
        if st is None or fb is not None \
                or [repr(r) for r in rs.data.rows] != host_rows(name)[0]:
            raise AssertionError(f"[15c] {name}: a fresh pin's rows differ")
    out["15c"] = dict(res, writes=dict(wfacts, statements=len(stmts),
                                       write_s=write_s),
                      repins_avoided=avoided,
                      delta_edges=hd.total_edges(), tombs=hd.total_tombs(),
                      tag_bytes=tag_bytes)
    log(f"[15c] {json.dumps(out['15c']['writes'])}: folded into the plane "
        f"once ({hd.total_edges()} delta edges, {hd.total_tombs()} "
        f"tombstones), rows equal to the host engine's and a fresh "
        f"pin's; {tag_bytes} bytes of device tag tables equal the host "
        f"mirror")
    fresh[0].qctx.tpu_runtime.unpin(IC_SPACE)
    for rt in rts.values():
        rt.unpin(IC_SPACE)
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t15
    log(f"[15] phase 15 took {out['phase_s']:.1f} s")
    return out, total


def cluster_statements(n: int):
    """Phase 16a's load as bench.py:961-980 writes it: the Person
    vertices and the KNOWS edges of `default_rng(CONC_SEED)` (self-loops
    dropped), CONC_BATCH rows an INSERT."""
    import numpy as np
    stmts = []
    for lo in range(0, n, CONC_BATCH):
        vals = ", ".join(f"{v}:({v % 90})"
                         for v in range(lo, min(lo + CONC_BATCH, n)))
        stmts.append(f"INSERT VERTEX Person(age) VALUES {vals}")
    rng = np.random.default_rng(CONC_SEED)
    src = rng.integers(0, n, n * CONC_DEGREE)
    dst = rng.integers(0, n, n * CONC_DEGREE)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    for lo in range(0, src.size, CONC_BATCH):
        vals = ", ".join(f"{s}->{d}:({int(s + d) % 100})" for s, d in zip(
            src[lo:lo + CONC_BATCH].tolist(),
            dst[lo:lo + CONC_BATCH].tolist()))
        stmts.append(f"INSERT EDGE KNOWS(w) VALUES {vals}")
    return stmts, int(src.size), (src, dst)


def conc_stmt(i: int, j: int, n: int) -> str:
    """bench.py's `_conc_stmt` (:982-990): alternating 1-hop GO and
    1-hop MATCH."""
    seed = (i * 131 + j * 17) % n
    if (i + j) % 2:
        return (f"MATCH (a:Person)-[e:KNOWS]->(b) "
                f"WHERE id(a) == {seed} RETURN id(b)")
    return f"GO FROM {seed} OVER KNOWS YIELD dst(edge) AS d"


def plane_statements(seeds, dsts):
    """Phase 16c's statements: test_cluster_device_plane's five
    (tests/unit/test_cluster.py:398-405) from each of the seeds, and a
    FIND SHORTEST PATH."""
    out = []
    for s, t in zip(seeds, dsts):
        out += [
            f"GO 2 STEPS FROM {s} OVER KNOWS YIELD dst(edge) AS d, "
            f"KNOWS.w AS w",
            f"GO FROM {s}, {t} OVER KNOWS WHERE KNOWS.w > 6 "
            f"YIELD dst(edge) AS d",
            f"MATCH (a:Person)-[e:KNOWS*1..2]->(b) WHERE id(a) == {s} "
            f"RETURN id(b), size(e)",
            f"GET SUBGRAPH 2 STEPS FROM {s} OUT KNOWS YIELD VERTICES AS v, "
            f"EDGES AS e",
            f"FIND ALL PATH FROM {s} TO {t} OVER KNOWS UPTO 3 STEPS "
            f"YIELD path AS p",
            f"FIND SHORTEST PATH FROM {s} TO {t} OVER KNOWS UPTO 4 STEPS "
            f"YIELD path AS p"]
    return out


def fused_nodes(plan_desc: str) -> list:
    return sorted(set(re.findall(r"\bTpu\w+", plan_desc or "")))


def timed_method(obj, name: str, sink: list):
    """Wrap obj.<name> on the instance so that every call appends its
    seconds to `sink`."""
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            sink.append(time.perf_counter() - t0)
    setattr(obj, name, wrapped)


def wait_part_leaders(cluster, space: str) -> None:
    """Block until every part of `space` has a Raft leader: with
    CONC_RAFT_MS the first election takes 2-4 s, longer than a
    statement's replica walk waits."""
    mc = cluster.meta_clients[0]
    n, sid = len(mc.parts_of(space)), mc.catalog.spaces[space].space_id
    dl = time.monotonic() + CONC_LEADER_WAIT_S
    while True:
        led = {pid for ss in cluster.storageds
               for (s, pid), part in list(ss.parts.items())
               if s == sid and part.is_leader()}
        if len(led) >= n:
            return
        if time.monotonic() > dl:
            raise AssertionError(f"[16a] {n - len(led)} parts of {space} "
                                 f"elected no leader in "
                                 f"{CONC_LEADER_WAIT_S} s")
        time.sleep(0.05)


def cluster_phase(K, card: str, seed: int) -> tuple:
    """Phase 16: the cluster plane on the card, at bench.py's concurrency
    size (bench.py:938-1063): a LocalCluster of one metad, three
    storageds and one graphd whose GpuRuntime pins the space from the
    storageds' bulk export; the 64-thread GO/MATCH mix, the device-plane
    statements and writes through the client, each held to a host
    QueryEngine on a local store loaded with the same statements.
    Returns (the phase's numbers, the launches of 16b-16d); raises on any
    failed check."""
    import tempfile
    import threading

    import numpy as np
    import torch
    from nebula_tpu_torch.cluster.launcher import LocalCluster
    from nebula_tpu_torch.exec.engine import QueryEngine
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.graphstore.store import GraphStore
    from nebula_tpu_torch.utils.config import get_config
    from nebula_tpu_torch.utils.flight import kernel_ledger
    from nebula_tpu_torch.utils.stats import stats

    out, total = {}, {}
    t16 = time.perf_counter()
    stamp("phase 16")
    stamp("phase 16a")
    n = CONC_PERSONS
    setup = [f"CREATE SPACE {CONC_SPACE}(partition_num=8, "
             f"replica_factor=3, vid_type=INT64)", f"USE {CONC_SPACE}",
             "CREATE TAG Person(age int)", "CREATE EDGE KNOWS(w int)"]
    loads, n_edges, (esrc, edst) = cluster_statements(n)
    host_eng = QueryEngine(GraphStore())
    hs = host_eng.new_session()

    def host(q):
        rs = host_eng.execute(hs, q)
        if rs.error is not None:
            raise AssertionError(f"[16] host {q[:80]}: {rs.error}")
        return rs

    for q in setup + loads:
        host(q)
    rt = GpuRuntime(delta_max_edges=CONC_DELTA_CAP)
    cfg = get_config()
    cfg.set_dynamic("kernel_ledger_capacity", 1 << 16)
    for k, v in CONC_RAFT_MS.items():
        cfg.set_dynamic(k, v)
    cluster = LocalCluster(n_meta=1, n_storage=3, n_graph=1,
                           data_dir=tempfile.mkdtemp(prefix="chip_smoke_"),
                           tpu_runtime=rt)
    try:
        cl = cluster.client()

        def run(q, client=None):
            rs = (client or cl).execute(q)
            if rs.error is not None:
                raise AssertionError(f"[16] {q[:80]}: {rs.error}")
            return rs

        run(setup[0])
        cluster.reconcile_storage()
        wait_part_leaders(cluster, CONC_SPACE)
        for q in setup[1:]:
            run(q)
        t0 = time.perf_counter()
        for q in loads:
            run(q)
        load_s = time.perf_counter() - t0
        store = cluster.graphds[0].store
        export_s, put_s = [], []
        timed_method(store, "build_csr_snapshot", export_s)
        timed_method(rt, "_put_locked", put_s)
        t0 = time.perf_counter()
        warm = cluster.client()
        run(f"USE {CONC_SPACE}", warm)
        run(conc_stmt(0, 0, n), warm)
        run(conc_stmt(0, 1, n), warm)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        dev = rt.snapshots.get(CONC_SPACE)
        if dev is None or len(export_s) != 1 or dev.delta is None:
            raise AssertionError(f"[16a] {len(export_s)} exports; the "
                                 f"space was not pinned from the cluster "
                                 f"with a delta plane")
        out["16a"] = {"persons": n, "edges": n_edges, "insert_statements":
                      len(loads), "load_s": load_s,
                      "export_s": export_s[0], "put_s": put_s[0],
                      "first_statements_s": first_s,
                      "pinned_bytes": rt.hbm_bytes(), "vmax": dev.vmax}
        log(f"[16a] {json.dumps(out['16a'])} | {card}")

        # 16b. the 64-thread mix
        stamp("phase 16b")

        def qwait(snap):
            return sum(v for k, v in snap.items()
                       if k.startswith("tpu_dispatch_queue_us")
                       and k.endswith(".sum"))

        lats, rows, errs = [], {}, []
        lock = threading.Lock()

        def worker(i):
            try:
                c = cluster.client()
                run(f"USE {CONC_SPACE}", c)
                mine = []
                for j in range(CONC_REPS):
                    q = conc_stmt(i, j, n)
                    t0 = time.perf_counter()
                    rs = run(q, c)
                    mine.append((time.perf_counter() - t0, (i, j), q,
                                 sorted(map(repr, rs.data.rows))))
                with lock:
                    for dt, key, q, r in mine:
                        lats.append(dt)
                        rows[key] = (q, r)
            except BaseException as ex:  # noqa: BLE001 — reported below
                errs.append(repr(ex))

        kernel_ledger().clear()
        runs0 = metric("tpu_kernel_runs")
        snap0 = stats().snapshot()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(CONC_THREADS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(CONC_JOIN_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = counts(K)
        if errs or any(t.is_alive() for t in ths):
            raise AssertionError(f"[16b] {len(errs)} threads failed: "
                                 f"{errs[:3]}")
        snap1 = stats().snapshot()
        runs = metric("tpu_kernel_runs") - runs0
        ledger = kernel_ledger().list(limit=1 << 16)
        if len(rows) != CONC_THREADS * CONC_REPS:
            raise AssertionError(f"[16b] {len(rows)} statements answered")
        for key, (q, got) in rows.items():
            if got != sorted(map(repr, host(q).data.rows)):
                raise AssertionError(f"[16b] {q}: rows differ from the "
                                     f"host engine's")
        if runs <= 0 or len(ledger) != runs:
            raise AssertionError(f"[16b] {runs} kernel runs, {len(ledger)} "
                                 f"ledger records")
        for name in CONC_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"[16b] kernel {name} never launched")
        lats.sort()

        def pq(p):
            return lats[min(len(lats) - 1, int(len(lats) * p / 100))]

        queue_us = qwait(snap1) - qwait(snap0)
        walks = sum(v - snap0.get(k, 0) for k, v in snap1.items()
                    if k.startswith("storage_replica_walk_retries"))
        total_us = sum(lats) * 1e6
        out["16b"] = {"threads": CONC_THREADS, "stmts": len(lats),
                      "p50_ms": pq(50) * 1e3, "p95_ms": pq(95) * 1e3,
                      "p99_ms": pq(99) * 1e3, "qps": len(lats) / wall,
                      "wall_s": wall, "queue_wait_us_total": queue_us,
                      "queue_wait_share": queue_us / total_us,
                      "replica_walk_retries": walks,
                      "kernel_runs": runs, "ledger_records": len(ledger),
                      "launches": {k: v for k, v in launches.items() if v}}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[16b] {json.dumps(out['16b'])} | {card}")

        # 16c. the device-plane statements
        stamp("phase 16c")
        rng = np.random.default_rng(seed)
        seeds = [int(x) for x in rng.choice(esrc, CONC_PLANE_SEEDS,
                                            replace=False)]
        dsts = [int(edst[np.flatnonzero(esrc == s)[0]]) for s in seeds]
        plane = plane_statements(seeds, dsts)
        ref_eng = QueryEngine(host_eng.qctx.store, tpu_runtime=GpuRuntime())
        rs_ = ref_eng.new_session()
        ref_eng.execute(rs_, f"USE {CONC_SPACE}")

        def plane_round(tag):
            res = {}
            K.reset_launch_counts()
            runs0 = metric("tpu_kernel_runs")
            for q in plane:
                t0 = time.perf_counter()
                got = sorted(map(repr, run(q).data.rows))
                dt = time.perf_counter() - t0
                if got != sorted(map(repr, host(q).data.rows)):
                    raise AssertionError(f"{tag} {q}: rows differ from the "
                                         f"host engine's")
                res.setdefault(q.split(" ")[0] + " " + q.split(" ")[1],
                               []).append(dt * 1e3)
            torch.cuda.synchronize()
            return res, counts(K), metric("tpu_kernel_runs") - runs0

        plans = {}
        for q in plane:
            want = fused_nodes(ref_eng.execute(rs_, "EXPLAIN " + q)
                               .plan_desc)
            got = fused_nodes(run("PROFILE " + q).plan_desc)
            if got != want or (q.startswith("GO")
                               and "TpuTraverse" not in got):
                raise AssertionError(f"[16c] {q}: PROFILE shows {got}, an "
                                     f"in-process device engine {want}")
            plans[q.split(" ")[0]] = got
        ref_eng.qctx.tpu_runtime.unpin(CONC_SPACE)
        lat_c, launches, runs = plane_round("[16c]")
        for name in PLANE_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"[16c] kernel {name} never launched")
        if launches["mark"] <= runs:
            raise AssertionError(f"[16c] {launches['mark']} mark launches "
                                 f"in {runs} runs: no next frontier marked")
        out["16c"] = {"statements": len(plane), "seeds": seeds,
                      "fused": plans, "kernel_runs": runs,
                      "ms": {k: sorted(v) for k, v in lat_c.items()},
                      "launches": {k: v for k, v in launches.items() if v}}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[16c] {json.dumps(out['16c'])} | {card}")

        # 16d. writes through the client ride the plane
        stamp("phase 16d")
        new_v = n + 1
        writes = [
            f"INSERT EDGE KNOWS(w) VALUES {seeds[0]}->{seeds[1]}:(77), "
            f"{seeds[1]}->{seeds[2]}:(78)",
            f"DELETE EDGE KNOWS {seeds[0]}->{dsts[0]}@0",
            f"INSERT VERTEX Person(age) VALUES {new_v}:(33)",
            f"INSERT EDGE KNOWS(w) VALUES {seeds[0]}->{new_v}:(79), "
            f"{new_v}->{seeds[3]}:(80)"]
        snap_before = rt.snapshots[CONC_SPACE]
        avoided0 = metric("tpu_repin_avoided")
        for q in writes:
            run(q)
            host(q)
        lat_d, launches, runs = plane_round("[16d]")
        avoided = metric("tpu_repin_avoided") - avoided0
        if rt.snapshots[CONC_SPACE] is not snap_before or avoided < 1 \
                or len(export_s) != 1:
            raise AssertionError(f"[16d] the writes did not ride the plane "
                                 f"({avoided} re-pins avoided, "
                                 f"{len(export_s)} exports)")
        if launches["merge_delta"] <= 0:
            raise AssertionError("[16d] merge_delta never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        hd = snap_before.delta.host
        t0 = time.perf_counter()
        rt.pin(store, CONC_SPACE, force=True)
        torch.cuda.synchronize()
        reexport_s = time.perf_counter() - t0
        lat_f, _, _ = plane_round("[16d] re-export")
        out["16d"] = {"writes": len(writes), "repins_avoided": avoided,
                      "delta_edges": hd.total_edges(),
                      "tombs": hd.total_tombs(), "kernel_runs": runs,
                      "reexport_s": reexport_s, "exports": len(export_s),
                      "launches": {k: v for k, v in launches.items() if v}}
        log(f"[16d] {json.dumps(out['16d'])}: folded into the plane, rows "
            f"equal to the host engine's before and after a forced "
            f"re-export | {card}")
        for name in PHASE16_KERNELS:
            if total.get(name, 0) <= 0:
                raise AssertionError(f"[16] kernel {name} never launched")
    finally:
        cluster.stop()
        with cfg.lock:
            for k in ("kernel_ledger_capacity", *CONC_RAFT_MS):
                cfg.dynamic_layer.pop(k, None)
    rt.unpin(CONC_SPACE)
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t16
    log(f"[16] phase 16 took {out['phase_s']:.1f} s | {card}")
    return out, total


def pg_runtime(K, pg_mesh, rt8, ns, want_rows, want_go, want_depths):
    """Phase 10g's second half: a GpuRuntime over the process-group mesh
    `pg_mesh` (the split north star pinned again on it, as 10a's rt8
    pins it) runs 10a's filtered GO, MATCH's every-hop frames of the same
    seeds (*1..3 WHERE w > 50) and 10b's BFS; rows, hop_edges and
    exchange_bytes equal 10a's, the frames the in-process mesh's, the
    depths 10b's.  Returns the numbers."""
    import numpy as np
    import torch
    from nebula_tpu_torch.gpu import GpuRuntime
    t0 = time.perf_counter()
    rtp = GpuRuntime(mesh=pg_mesh,
                     degree_split_threshold=ns.split_threshold)
    rtp.pin_prebuilt(ns.snap)
    torch.cuda.synchronize()
    out = {"pin_s": time.perf_counter() - t0,
           "pinned_bytes": rtp.hbm_bytes(), "in_process": False}
    K.reset_launch_counts()
    rows, st = rtp.traverse(ns.store, "ns", ns.seeds, ["KNOWS"], "out", 3,
                            edge_filter=ns.w_filter, yields=ns.yields)
    torch.cuda.synchronize()
    go_launches = counts(K)
    if not rows_equal(rows, want_rows) \
            or st.hop_edges != want_go["hop_edges"] \
            or st.exchange_bytes != want_go["exchange_bytes"]:
        raise AssertionError(f"[10g] the group runtime's GO: {len(rows)} "
                             f"rows, hop_edges {st.hop_edges}, "
                             f"{st.exchange_bytes} bytes vs 10a's")
    out["go"] = {"rows": len(rows), "hop_edges": st.hop_edges,
                 "exchange_bytes": st.exchange_bytes, "e_cap": st.e_cap,
                 "device_ms": st.device_s * 1e3,
                 "launches": {k: v for k, v in go_launches.items() if v}}
    args = (ns.store, "ns", ns.seeds, ["KNOWS"], "out", 3)
    frames, fst = rtp.traverse_hops(*args, edge_filter=ns.w_filter)
    want_f, wst = rt8.traverse_hops(*args, edge_filter=ns.w_filter)
    if not frames_equal(frames, want_f) or fst.hop_edges != wst.hop_edges \
            or fst.exchange_bytes != wst.exchange_bytes:
        raise AssertionError("[10g] the group runtime's frames differ from "
                             "the in-process mesh's")
    out["match"] = {"frame_edges": [f.n for f in frames],
                    "hop_edges": fst.hop_edges,
                    "device_ms": fst.device_s * 1e3}
    dist, bst = rtp.bfs(ns.store, "ns", [ns.seeds[0]], ["KNOWS"], "out",
                        BFS_STEPS)
    P = ns.snap.num_parts
    vv = np.arange(len(ns.snap.dense_to_vid))
    if not np.array_equal(dist[vv % P, vv // P], want_depths):
        raise AssertionError("[10g] the group runtime's depths differ from "
                             "10b's")
    out["bfs"] = {"hop_edges": bst.hop_edges,
                  "exchange_bytes": bst.exchange_bytes,
                  "device_ms": bst.device_s * 1e3}
    rtp.unpin("ns")
    return out


def grid_phase(K, ns, lrt, bfs_depths, card: str) -> dict:
    """Phase 10h: the two-axis grid on the one card.  The north star
    laid out at 4 parts (10a's snapshot has 8; `halve_parts`), split
    once as `lrt` (the main path's runtime) splits, and pinned through
    GpuRuntime(mesh=make_mesh2(2, 4)) (a 2 x 4 grid, every slot on
    cuda:0, the rows sharing each part's one copy), on make_mesh(4) and
    on the one device.  GO 3 STEPS WHERE w > 50: rows equal the local runtime's,
    hop_edges and exchange_bytes make_mesh(4)'s; [8b]'s 8 lanes as one
    batch over the two rows, each lane's rows its solo run's; config 5's
    BFS, depths the local runtime's (and phase 6's).  Logs the launches a
    run, each loop's device time and the pinned bytes against the
    one-axis mesh's.  Returns the numbers."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    from nebula_tpu_torch.bench.datagen import SnapshotStore
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu.device import make_mesh, make_mesh2, \
        mesh_lanes, mesh_parts
    from nebula_tpu_torch.gpu.hop import a2a_payload_bytes
    from nebula_tpu_torch.graphstore.csr import degree_split
    from nebula_tpu_torch.utils.workload import live_registry
    stamp("phase 10h")
    t10 = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    # snapshot_from_arrays(ns.arrs, parts=GRID_PARTS)'s layout, from the
    # north star's 8 parts (tests/test_torch_mesh2.py holds them equal)
    snap4 = ns.snap
    while snap4.num_parts > GRID_PARTS:
        snap4 = halve_parts(snap4)
    edges = {k: int(b.indptr[:, -1].sum()) for k, b in snap4.blocks.items()}
    if snap4.num_parts != GRID_PARTS or set(edges.values()) != {ns.n_edges}:
        raise AssertionError(f"[10h] laid {snap4.num_parts} parts, {edges}")
    ns4 = SimpleNamespace(snap=snap4, store=SnapshotStore(snap4))
    out["layout_s"] = time.perf_counter() - t0
    grid = make_mesh2(GRID_LANES, GRID_PARTS)
    slots = {d for r in grid.rows for d in r.devices}
    if (mesh_lanes(grid), mesh_parts(grid)) != (GRID_LANES, GRID_PARTS) \
            or len(slots) != 1:
        raise AssertionError(f"[10h] make_mesh2 laid {grid}")
    thr = lrt.degree_split_threshold
    rts, alloc = {}, {}
    t0 = time.perf_counter()
    # split once, as each runtime's pin would split it
    split4 = degree_split(snap4, thr) if thr > 0 else snap4
    for name, kw in (("grid", {"mesh": grid}),
                     ("axis", {"mesh": make_mesh(GRID_PARTS)}),
                     ("local", {})):
        rts[name] = GpuRuntime(degree_split_threshold=thr, **kw)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        rts[name].pin_prebuilt(split4)
        torch.cuda.synchronize()
        alloc[name] = torch.cuda.memory_allocated() - a0
    out["pin_s"] = time.perf_counter() - t0
    devg = rts["grid"].snapshots["ns"]
    shared = all(a is b for a, b in zip(devg.slot_shards[:GRID_PARTS],
                                        devg.slot_shards[GRID_PARTS:]))
    hbm = {k: rt.hbm_bytes() for k, rt in rts.items()}
    # a copy a row would allocate twice make_mesh(4)'s bytes; the
    # allocator's own rounding moves the two by a few KB
    if not shared or hbm["grid"] != hbm["axis"] \
            or alloc["grid"] > 1.5 * alloc["axis"]:
        raise AssertionError(f"[10h] the rows do not share their copies: "
                             f"hbm_bytes {hbm}, allocated {alloc}")
    out["pin"] = {"hbm_bytes": hbm, "allocated_by_pin": alloc,
                  "rows_share_copies": shared, "hubs": devg.num_hubs,
                  "vmax": snap4.vmax}
    log(f"[10h] make_mesh2({GRID_LANES}, {GRID_PARTS}) on one card: "
        f"{json.dumps(out['pin'])} | {card}")

    # GO 3 STEPS WHERE w > 50: a warm-up each, then GRID_RUNS rounds of
    # one run each, so that a slow moment of the host falls on every
    # runtime alike; each sample is kept beside the gen-2 collections
    # Python's garbage collector made during it and the segments the
    # caching allocator took from the card (device_s is the host's clock
    # around a synchronised loop)
    import gc

    def events():
        return (gc.get_stats()[2]["collections"],
                torch.cuda.memory_stats().get("segment.all.allocated", 0))
    t0 = time.perf_counter()
    calls = {name: go_call(rt, ns4.store, 3, ns.w_filter, ns.yields)
             for name, rt in rts.items()}
    for call in calls.values():
        call(ns.seeds)                           # warm-up
    torch.cuda.synchronize()
    go = {name: [None, None, {}, [], []] for name in rts}
    for _ in range(GRID_RUNS):
        for name, call in calls.items():
            g = go[name]
            K.reset_launch_counts()
            e0 = events()
            g[0], g[1] = call(ns.seeds)
            g[4].append([b - a for a, b in zip(e0, events())])
            g[3].append(g[1].device_s * 1e3)
            for k, v in counts(K).items():
                g[2][k] = g[2].get(k, 0) + v
    torch.cuda.synchronize()
    go = {name: (rows, st, {k: v / GRID_RUNS for k, v in launch.items()
                            if v}, ms, ev)
          for name, (rows, st, launch, ms, ev) in go.items()}
    rows_g, st_g, launch_g, _, _ = go["grid"]
    want_x = 2 * a2a_payload_bytes(GRID_PARTS, snap4.vmax)
    if not rows_equal(rows_g, go["local"][0]) \
            or (st_g.hop_edges, st_g.frontier_sizes) != \
            (go["local"][1].hop_edges, go["local"][1].frontier_sizes) \
            or st_g.hop_edges != go["axis"][1].hop_edges \
            or st_g.exchange_bytes != go["axis"][1].exchange_bytes \
            or st_g.exchange_bytes != want_x:
        raise AssertionError(f"[10h] GO on the grid: {len(rows_g)} rows, "
                             f"hop_edges {st_g.hop_edges}, "
                             f"{st_g.exchange_bytes} bytes")
    if launch_g != go["axis"][2]:
        raise AssertionError(f"[10h] a solo GO on the grid launched "
                             f"{launch_g}, on make_mesh(4) {go['axis'][2]}")
    out["go"] = {"rows": len(rows_g), "hop_edges": st_g.hop_edges,
                 "exchange_bytes": st_g.exchange_bytes,
                 "e_cap": st_g.e_cap, "launches_per_run": launch_g,
                 "device_loop_ms": {k: float(np.median(v[3]))
                                    for k, v in go.items()},
                 "device_loop_min_ms": {k: min(v[3]) for k, v in go.items()},
                 "device_loop_samples_ms": {k: v[3] for k, v in go.items()},
                 "gen2_collections_and_segments": {k: v[4]
                                                   for k, v in go.items()},
                 "samples": GRID_RUNS}
    log(f"[10h] GO 3 STEPS w>{ns.w_gt}: {json.dumps(out['go'])} | {card}")
    del go, rows_g
    out["go_s"] = time.perf_counter() - t0

    # [8b]'s eight statements as one batch over the two lane rows
    t0 = time.perf_counter()
    add_company()
    try:
        out["batch"], _ = run_batch(
            "10h", go_call(rts["grid"], ns4.store, 3, ns.w_filter,
                           ns.yields),
            [ns.seeds[2 * i:2 * i + 2] for i in range(8)], 3, K,
            rows=GRID_LANES)
    finally:
        for qid in (-1, -2):
            live_registry().deregister(qid)

    out["batch_s"] = time.perf_counter() - t0

    # config 5's BFS on lane row 0 of the grid
    t0 = time.perf_counter()
    d_g, st_b, res_b, bl = run_bfs_path(rts["grid"], ns4, ns.seeds[0],
                                        "grid 2 x 4", K, tag="[10h]")
    d_l, _, res_l, _ = run_bfs_path(rts["local"], ns4, ns.seeds[0],
                                    "local, 4 parts", K, tag="[10h]")
    if not np.array_equal(d_g, d_l) or not np.array_equal(d_g, bfs_depths):
        raise AssertionError("[10h] the grid's depths differ from the "
                             "local runtime's")
    if st_b.exchange_bytes != BFS_STEPS * a2a_payload_bytes(
            GRID_PARTS, snap4.vmax):
        raise AssertionError(f"[10h] BFS exchange_bytes "
                             f"{st_b.exchange_bytes}")
    out["bfs"] = {"hop_edges": st_b.hop_edges,
                  "exchange_bytes": st_b.exchange_bytes,
                  "device_loop_ms": res_b["device_p50_ms"],
                  "local_device_loop_ms": res_l["device_p50_ms"],
                  "launches_per_run": res_b["launches_per_run"]}
    log(f"[10h] BFS: {json.dumps(out['bfs'])} | {card}")
    for rt in rts.values():
        rt.unpin("ns")
    out["bfs_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t10
    steps = {k: round(out[k + "_s"], 2)
             for k in ("layout", "pin", "go", "batch", "bfs")}
    log(f"[10h] phase 10h took {out['phase_s']:.1f} s (seconds a step: "
        f"{json.dumps(steps)}) | {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--split", type=int, default=2048,
                    help="degree-split threshold of path 3b (0 skips it)")
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of phase 7's write batch")
    ap.add_argument("--ic-persons", type=int, default=IC_PERSONS,
                    help="persons of phase 15's LDBC SNB interactive "
                         "slice")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from nebula_tpu_torch.algo import engine as AE
    from nebula_tpu_torch.algo import kernels as AK
    from nebula_tpu_torch.bench.datagen import host_final_hop, north_star
    from nebula_tpu_torch.core import expr as E
    from nebula_tpu_torch.core.value import NULL
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu import exprjit as X
    from nebula_tpu_torch.gpu import kernels as K
    from nebula_tpu_torch.gpu.hop import new_frontier
    from nebula_tpu_torch.graphstore.csr import INT_NULL, degree_split
    from nebula_tpu_torch.graphstore.schema import PropType

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    path, build_s, report = K.build()
    log(f"[2] built {path.name} in {build_s:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("    " + line.strip())
    for line in ptxas_lines(report, ("predicate_kernel",
                                     "merge_delta_kernel", "relax_kernel",
                                     "prologue_kernel", "finish_kernel",
                                     "bfs_probe_kernel",
                                     "bfs_level_kernel", "pack_bits_kernel",
                                     "unpack_or_kernel",
                                     "owned_hub_bits_kernel",
                                     "fill_hub_columns_kernel")):
        log(f"[2] ptxas {line}")

    # -- 3a. the north-star GO, unsplit ------------------------------------
    stamp("phase 3a")
    t0 = time.perf_counter()
    ns = north_star(args.persons, split_threshold=args.split)
    log(f"[3] graph: {args.persons} persons, {ns.n_edges} KNOWS edges,"
        f" built in {time.perf_counter() - t0:.1f} s")
    rt = GpuRuntime()
    t0 = time.perf_counter()
    rt.pin_prebuilt(ns.snap)
    torch.cuda.synchronize()
    log(f"[3a] unsplit: pinned {rt.hbm_bytes()} bytes in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    oracle = {}
    rows_u = {}
    res_u, launches_u = run_go(rt, ns, args.repeats, "unsplit", K, oracle,
                               keep_rows=rows_u)
    peak_u = torch.cuda.max_memory_allocated()
    for name in UNSPLIT_KERNELS:
        if launches_u[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"unsplit path")
    check_hub_route(launches_u, "unsplit GO", split=False)
    results = {"unsplit": res_u}
    launches = launches_u
    # the main path's last rows and stats per filter (3b's, or 3a's with
    # --split 0), which phase 10's mesh must reproduce
    main_rows = dict(rows_u)

    # -- 3b. the north-star GO, degree-split as bench.py runs it -----------
    stamp("phase 3b")
    rts = None
    if args.split > 0:
        t0 = time.perf_counter()
        hubs_direct = degree_split(ns.snap, args.split).hub_dense
        split_s = time.perf_counter() - t0
        rts = GpuRuntime(degree_split_threshold=ns.split_threshold)
        t0 = time.perf_counter()
        rts.pin_prebuilt(ns.snap)
        torch.cuda.synchronize()
        pin_s = time.perf_counter() - t0
        dev_s = rts.snapshots["ns"]
        H = dev_s.num_hubs
        if H == 0 or H != (0 if hubs_direct is None else len(hubs_direct)):
            raise AssertionError(f"split pinned {H} hubs")
        log(f"[3b] split at {args.split}: H={H} hubs, degree_split "
            f"{split_s:.2f} s, pin_prebuilt (split included) {pin_s:.2f} s,"
            f" pinned {rts.hbm_bytes()} bytes, hub ids "
            f"{dev_s.host.hub_dense[:8].tolist()}...")
        torch.cuda.reset_peak_memory_stats()
        res_s, launches = run_go(rts, ns, args.repeats, "split", K, oracle,
                                 keep_rows=main_rows)
        peak_s = torch.cuda.max_memory_allocated()
        for name in SPLIT_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on "
                                     f"the split path")
        check_hub_route(launches, "split GO", split=True)
        for flabel, r in res_s.items():
            if r["hop_edges"] != res_u[flabel]["hop_edges"]:
                raise AssertionError(
                    f"split {flabel}: hop_edges {r['hop_edges']} vs "
                    f"unsplit {res_u[flabel]['hop_edges']}")
        results["split"] = res_s
        log(f"    e_cap per hop: unsplit {res_u['unfiltered']['e_cap']}, "
            f"split {res_s['unfiltered']['e_cap']}; max_memory_allocated "
            f"unsplit {peak_u}, split {peak_s}")

    # -- 4. kernels against their plain versions at the path's shapes ----
    stamp("phase 4")
    reps = 20
    rows_out = []
    extra = []

    def record(name, got, want, ms, plain_ms, lib_ms, nbytes, ops,
               into=rows_out, note="", counts=None, err=None,
               ops_per_s=INT32_OPS_PER_S, tag="[4]"):
        if err is None:
            err = max_abs_err(got, want)
        b_ms, b_by = bound(nbytes, ops, ops_per_s)
        src_path, replaces = ROUTE_SOURCES[name]
        into.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces,
            "launches": (launches if counts is None else counts)[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        log(f"{tag} {name}{note}: {json.dumps(into[-1])}")

    def hop_inputs(dev, seeds=None):
        """Frontier buffers entering hops 1-3 (hub columns filled) and
        the hop-2 dst ids, from the plain versions, from `seeds` (the
        north star's by default)."""
        blk = dev.blocks[("KNOWS", "out")]
        P, vmax = dev.num_parts, dev.vmax
        seeds = ns.seeds if seeds is None else seeds
        ids = torch.tensor(sorted(set(seeds)), dtype=torch.int32,
                           device=dev.device)
        buf = new_frontier(dev)
        K.mark_plain(ids, P, vmax, out=buf[:, :vmax])
        bufs, dsts = [], []
        for hop in range(3):
            if dev.num_hubs:
                K.extend_hubs_plain(buf, dev.hub_owner, dev.hub_local, vmax)
            bufs.append(buf)
            if hop == 2:
                break
            dst = K.expand_plain(blk.indptr, blk.nbr, blk.rank, buf,
                                 dev.hub_dense)[1]
            dsts.append(dst)
            buf = new_frontier(dev)
            K.mark_plain(dst, P, vmax, out=buf[:, :vmax])
        return blk, ids, bufs, dsts

    per_hop = {}
    layouts = [("unsplit", rt.snapshots["ns"])]
    if rts is not None:
        layouts.append(("split", rts.snapshots["ns"]))
    inputs = {}
    for lname, dev in layouts:
        blk, ids, bufs, dsts = hop_inputs(dev)
        inputs[lname] = (blk, ids, bufs, dsts)
        P, H = dev.num_parts, dev.num_hubs
        hd = dev.hub_dense
        # split: the owner route on the buffer as the loop leaves it (hub
        # columns zero), against the tail route over the filled buffer
        hubs = (dev.hub_owner, dev.hub_local) if H else None
        okw = dict(zip(("hub_owner", "hub_local"), hubs)) if H else {}
        for hop, f in enumerate(bufs, 1):
            a = (blk.indptr, blk.nbr, blk.rank,
                 zero_tail(f, dev.vmax) if H else f, hd)
            got = K.expand(*a, **okw)
            want = K.expand_plain(blk.indptr, blk.nbr, blk.rank, f, hd)
            max_abs_err(got, want)
            tot, EB = int(want[4].sum()), want[0].shape[1]
            ms = cuda_ms(lambda a=a: K.expand(*a, **okw), reps)
            nbytes = expand_bytes(P, f.shape[1], H, tot, EB, bool(H))
            b_ms, _ = bound(nbytes, P * f.shape[1] * 3 + tot)
            per_hop[f"{lname} hop {hop}"] = {
                "ms": ms, "edges": tot, "EB": EB, "bound_ms": b_ms}
            log(f"[4] expand {lname} hop {hop}"
                f"{' (hub owners)' if H else ''}: "
                f"{json.dumps(per_hop[f'{lname} hop {hop}'])}")
            if hop == 3:
                main = lname == layouts[-1][0]
                record("expand", got, want, ms,
                       cuda_ms(lambda a=a: K.expand_plain(*a, **okw), reps),
                       cuda_ms(lib_expand_for(blk, a[3], hubs), reps),
                       nbytes, P * f.shape[1] * 3 + tot,
                       into=rows_out if main else extra,
                       note=f" ({lname} hop 3)",
                       counts=launches if main else launches_u)

    # the main path's layout: split when it ran, else unsplit
    lname, dev = layouts[-1]
    blk, ids, bufs, dsts = inputs[lname]
    P, vmax, H = dev.num_parts, dev.vmax, dev.num_hubs

    # mark at hop 2 (the largest mark of the path), into the frontier
    # buffer's first vmax columns, with a keep mask, and the seed call
    dst2 = dsts[1]
    n2 = dst2.numel()
    got, want = [], []
    for keep in (None, (dst2 % 3) == 0):
        got.append(K.mark(dst2, P, vmax, keep=keep,
                          out=new_frontier(dev)[:, :vmax]))
        want.append(K.mark_plain(dst2, P, vmax, keep=keep,
                                 out=new_frontier(dev)[:, :vmax]))
    got.append(K.mark(ids, P, vmax))
    want.append(K.mark_plain(ids, P, vmax))

    def lib_mark(d=dst2):
        out = torch.zeros((P, vmax), dtype=torch.bool, device=d.device)
        dl = d.view(-1).long()
        dl = dl[dl >= 0]
        out.index_put_((dl % P, dl // P), torch.ones((), dtype=torch.bool,
                                                     device=d.device))
        return out

    record("mark", got, want,
           cuda_ms(lambda: K.mark(dst2, P, vmax,
                                  out=new_frontier(dev)[:, :vmax]), reps),
           cuda_ms(lambda: K.mark_plain(dst2, P, vmax,
                                        out=new_frontier(dev)[:, :vmax]),
                   reps),
           cuda_ms(lib_mark, reps), 4 * n2 + P * (vmax + H), 3 * n2)
    mark_paths(K, "[4]", f"hop 2, {n2} slots",
               lambda p: K.mark(dst2, P, vmax,
                                out=new_frontier(dev)[:, :vmax], path=p),
               want[0], K.mark_path(n2, P, vmax), reps)

    # K6, the seed bitmap as _seed_frontier builds it: a fresh frontier
    # buffer (its zero fill) and the 16 seed ids marked into it
    def lib_seed():
        out = new_frontier(dev)
        il = ids.long()
        out.index_put_((il % P, il // P),
                       torch.ones((), dtype=torch.bool, device=ids.device))
        return out

    k6 = {"ms": cuda_ms(lambda: K.mark(ids, P, vmax,
                                       out=new_frontier(dev)[:, :vmax]),
                        reps),
          "plain_ms": cuda_ms(lambda: K.mark_plain(
              ids, P, vmax, out=new_frontier(dev)[:, :vmax]), reps),
          "library_ms": cuda_ms(lib_seed, reps)}
    k6["bound_ms"], k6["bound_by"] = bound(4 * ids.numel() + P * (vmax + H),
                                           3 * ids.numel())
    log(f"[4] mark (K6 seed bitmap, {ids.numel()} seeds, with the zero "
        f"fill): {json.dumps(k6)}")
    main_rt = rts if rts is not None else rt
    k7go = loop_bound(K, lambda: main_rt.traverse(
        ns.store, "ns", ns.seeds, ["KNOWS"], "out", 3,
        edge_filter=ns.w_filter, yields=ns.yields))
    k7go = {"device_loop_ms": results[lname][f"w>{ns.w_gt}"][
        "device_p50_ms"], "bound_ms": sum(k7go.values()),
        "bound_parts_ms": k7go}
    log(f"[4] K7 GO loop ({lname}, w > {ns.w_gt}): {json.dumps(k7go)}")

    # K8, folded into expand's scan: the fused pass at split hop 3 (its
    # library formulation the hub gather, then the expansion) beside the
    # parent's pair in turns (fused, pair, pair, fused) — the hub bits
    # by their library gather (one gather and one broadcast assignment),
    # then the scan reading them from the tail columns
    if H:
        f3 = bufs[2]
        okw = dict(hub_owner=dev.hub_owner, hub_local=dev.hub_local)
        a3z = (blk.indptr, blk.nbr, blk.rank, zero_tail(f3, vmax),
               dev.hub_dense)
        ft = f3.clone()
        at = (blk.indptr, blk.nbr, blk.rank, ft, dev.hub_dense)
        own_l, loc_l = dev.hub_owner.long(), dev.hub_local.long()

        def lib_hubs():
            ft[:, vmax:] = ft[own_l, loc_l][None, :]
            return ft

        def parent_pair():
            lib_hubs()
            return K.expand(*at)

        want = K.expand_plain(blk.indptr, blk.nbr, blk.rank, f3,
                              dev.hub_dense)
        got = K.expand(*a3z, **okw)
        max_abs_err(parent_pair(), want)
        turns = [cuda_ms(lambda: K.expand(*a3z, **okw), reps),
                 cuda_ms(parent_pair, reps), cuda_ms(parent_pair, reps),
                 cuda_ms(lambda: K.expand(*a3z, **okw), reps)]
        tot3, EB3 = int(want[4].sum()), want[0].shape[1]
        record("extend_hubs (fused into expand)", got, want,
               (turns[0] + turns[3]) / 2,
               cuda_ms(lambda: K.expand_plain(*a3z, **okw), reps),
               cuda_ms(lib_expand_for(blk, a3z[3], (dev.hub_owner,
                                                    dev.hub_local)), reps),
               expand_bytes(P, vmax + H, H, tot3, EB3, True),
               P * (vmax + H) * 3 + tot3,
               counts={"extend_hubs (fused into expand)":
                       launches[HUB_ROUTE]},
               note=f" (split hop 3, {H} hubs: the owner route)")
        k8 = {"fused_ms": [turns[0], turns[3]],
              "parent_pair_ms": [turns[1], turns[2]],
              "parent_gather_ms": cuda_ms(lib_hubs, reps),
              "tail_scan_ms": cuda_ms(lambda: K.expand(*at), reps),
              "fused_launches_per_go3": launches[HUB_ROUTE]
              / (2 * (args.repeats + 1)),
              "hub_column_passes": launches["owned_hub_bits"]
              + launches["fill_hub_columns"]}
        log(f"[4] K8 fused vs the parent's pair (split hop 3, in turns): "
            f"{json.dumps(k8)}")

    # predicate_mask at the filtered hop 3: w > 50 (the main path's
    # program) and eleven more over nullable columns made from a seed
    f3 = bufs[2]
    a3 = (blk.indptr, blk.nbr, blk.rank, f3, dev.hub_dense)
    src, dst, rk, eidx, total = K.expand_plain(*a3)
    EB3 = src.shape[1]
    tot3 = int(total.sum())
    gen = torch.Generator(device=rt.device)
    gen.manual_seed(7)
    w, fcol, city = blk.props["w"], blk.props["f"], blk.props["city"]

    def nulls(frac=0.1):
        return torch.rand(w.shape, generator=gen, device=w.device) < frac

    cols = {"w": w, "f": fcol, "city": city,
            "wn": torch.where(nulls(), INT_NULL, w - 50),
            "fn": torch.where(nulls(), float("nan"), fcol - 0.5),
            "bn": torch.where(nulls(), INT_NULL, w % 2),
            "cn": torch.where(nulls(), INT_NULL, city)}
    types = {"w": PropType.INT64, "f": PropType.DOUBLE,
             "city": PropType.STRING, "wn": PropType.INT64,
             "fn": PropType.DOUBLE, "bn": PropType.BOOL,
             "cn": PropType.STRING}
    got, want, kept = [], [], {}
    base = n_insns = None
    for pname, expr in predicates(E, NULL).items():
        prog, _ = X.compile_predicate(expr, types, dev.pool,
                                      vid_to_dense=ns.store.space(
                                          "ns").dense_id,
                                      device=rt.device)
        pa = (prog, src, dst, rk, eidx, total,
              [cols[n] for n in prog.columns])
        got.append(K.predicate_mask(*pa))
        want.append(K.predicate_mask_plain(*pa))
        kept[pname] = int(want[-1].sum())
        if base is None:
            base, n_insns = pa, len(prog.code)
    log(f"    predicates checked at split hop 3 ({P}x{EB3} slots, "
        f"{tot3} valid), kept slots: {json.dumps(kept)}")
    record("predicate_mask", got, want,
           cuda_ms(lambda: K.predicate_mask(*base), reps),
           cuda_ms(lambda: K.predicate_mask_plain(*base), reps),
           None, tot3 * (4 + 8) + P * EB3 + 4 * P,
           tot3 * n_insns)
    predicate_paths(K, "[4]", f"w > 50 at split hop 3, {P}x{EB3} slots",
                    base, want[0], reps)

    # compact_capture at the filtered hop 3 with the w yield column (the
    # main path's call), then with four columns of both word types
    keep = got[0]
    cargs = (src, dst, rk, eidx, keep, [w])
    got, want = [], []
    for ycols in (cargs[5], [w, fcol, city, w]):
        for out, fn in ((got, K.compact_capture),
                        (want, K.compact_capture_plain)):
            r = fn(*cargs[:5], ycols, extent=total)
            out.extend([*r[:4], *r[4], r[5]])
    n_kept = int(want[-1].sum())

    def lib_compact(a=cargs):
        pi, si = a[4].nonzero(as_tuple=True)
        flat = pi * EB3 + si
        outs = [t.view(-1).index_select(0, flat) for t in a[:4]]
        outs.append(a[5][0][pi, a[3][pi, si].long()])
        return outs

    record("compact_capture", got, want,
           cuda_ms(lambda: K.compact_capture(*cargs, extent=total), reps),
           cuda_ms(lambda: K.compact_capture_plain(*cargs, extent=total),
                   reps),
           cuda_ms(lib_compact, reps),
           compact_bytes(P * EB3, tot3, n_kept, 1, P), 2 * tot3)

    # the edge cases of the two scan kernels, bit for bit
    edge_cases(K, AK, rt.device)

    # -- 5. the algo plane --------------------------------------------------
    stamp("phase 5")
    algo, algo_launches = run_algo(rt, ns, K, AE, AK)
    algo["suite"] = run_algo_suite(rt, min(args.persons, SUITE_PERSONS))
    for func, (params, kname) in ALGO_RUNS.items():
        checks = algo[func].pop("check_args")
        plain = getattr(AK, kname + "_plain")
        kern = getattr(AK, kname)
        errs = []
        for label, cargs in checks:
            got, want = kern(*cargs), plain(*cargs)
            if kname == "pagerank_step":
                err = pagerank_step_err(label, cargs, got, want)
            else:
                err = max_abs_err(got, want)
            errs.append(err)
        # timed at the middle iteration's inputs (the last checked)
        mid_args = checks[-1][1]
        nbytes, ops, rate, lib = algo_work(kname, mid_args)
        rname = kname
        if func in RELAX_RUNS:
            rname = f"{kname} ({AK.relax_route(mid_args[0].numel())})"
        record(rname, None, None,
               cuda_ms(lambda: kern(*mid_args), reps),
               cuda_ms(lambda: plain(*mid_args), reps), cuda_ms(lib, reps),
               nbytes, ops, counts=algo_launches, err=max(errs),
               ops_per_s=rate, tag="[5c]",
               note=f" ({func}, iterations {[lb for lb, _ in checks]})")
        if func in RELAX_RUNS:
            relax_timings(AK, func, kname, checks[-1][0], mid_args,
                          algo[func].pop("all_args"), rows_out[-1], reps)
        if kname == "pagerank_step":
            # a yardstick only: the rank gather alone, one index_select
            # of the 8 MB rank array at the same shape (the port never
            # calls it); its own bytes are the indices and the output
            rank_m, idx = mid_args[0], mid_args[1].long()
            floor = {"ms": cuda_ms(lambda: rank_m.index_select(0, idx),
                                   reps),
                     "bound_ms": bound(16 * idx.numel()
                                       + 8 * rank_m.numel(), 0)[0],
                     "kernel_ms": rows_out[-1]["ms"],
                     "kernel_bound_ms": rows_out[-1]["bound_ms"]}
            log(f"[5c] pagerank_step gather floor (rank.index_select(0, "
                f"esrc.long()), {idx.numel()} edges): {json.dumps(floor)}")

    # 5d. WCC and SSSP past the staged capacity: the global route's rows
    stamp("phase 5d")
    algo["global"], launches_g, mids_g, snap_g = run_algo_global(rt, K, AE,
                                                                 AK)
    for func in RELAX_RUNS:
        kname = ALGO_RUNS[func][1]
        kern, plain = getattr(AK, kname), getattr(AK, kname + "_plain")
        mid, ga = mids_g[func]
        err = max_abs_err(kern(*ga), plain(*ga))
        nbytes, ops, rate, lib = algo_work(kname, ga)
        record(f"{kname} (global)", None, None,
               cuda_ms(lambda: kern(*ga), reps),
               cuda_ms(lambda: plain(*ga), reps), cuda_ms(lib, reps),
               nbytes, ops, counts=launches_g, err=err, ops_per_s=rate,
               tag="[5d]", note=f" ({func}, iteration {mid}, "
               f"{ga[0].numel()} slots, {ga[2].numel()} edges)")
    del mids_g

    # -- 6. the device BFS of FIND SHORTEST PATH (bench.py config 5) -------
    stamp("phase 6")
    from nebula_tpu_torch.algo import frontier as FR
    from nebula_tpu_torch.bench.datagen import host_bfs
    from nebula_tpu_torch.gpu import bfs as GB
    seed = ns.seeds[0]
    t0 = time.perf_counter()
    want = host_bfs(ns.snap, [seed], BFS_STEPS)
    bfs_depths = want                       # phase 10b's oracle too
    host_bfs_s = time.perf_counter() - t0
    bu_levels = [lv for lv, b in enumerate(bfs_branches(want, BFS_STEPS), 1)
                 if b]
    if not bu_levels:
        raise AssertionError("no level of the BFS goes bottom-up")
    want_edges = bfs_level_edges(ns.snap, want, BFS_STEPS)
    bfs = {"seed": seed, "host_bfs_s": host_bfs_s,
           "bottom_up_levels": bu_levels, "level_edges_numpy": want_edges}
    log(f"[6] BFS from vertex {seed}, {BFS_STEPS} levels: {json.dumps(bfs)}")
    bfs_paths = [("unsplit", rt)] + ([("split", rts)] if rts is not None
                                     else [])
    bfs_launches = {}
    for blabel, brt in bfs_paths:
        d, st, res, bl = run_bfs_path(brt, ns, seed, blabel, K)
        if not np.array_equal(d, want):
            raise AssertionError(f"BFS {blabel}: dist differs from host_bfs")
        if st.hop_edges != want_edges:
            raise AssertionError(f"BFS {blabel}: hop_edges {st.hop_edges} vs "
                                 f"{want_edges} for the switch's branches")
        for name in BFS_KERNELS:
            if bl[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{blabel} BFS path")
        check_hub_route(bl, f"BFS {blabel}", split=brt is rts)
        check_probe_routes(bl, blabel, "staged")
        bfs[blabel], bfs_launches[blabel] = res, bl
    # the main BFS path: split as bench.py runs it, when it ran
    mlabel, mrt = bfs_paths[-1]
    fw = f"{mlabel} w>{ns.w_gt}"
    want_f = host_bfs_where(ns.snap, [seed], BFS_STEPS, ns.w_gt)
    d, st, res, bl = run_bfs_path(mrt, ns, seed, fw, K, filt=ns.w_filter)
    if not np.array_equal(d, want_f):
        raise AssertionError(f"BFS {fw}: dist differs from the numpy oracle")
    if st.hop_edges != bfs_level_edges(ns.snap, want_f, BFS_STEPS):
        raise AssertionError(f"BFS {fw}: hop_edges {st.hop_edges}")
    for name in BFS_KERNELS + ("predicate_mask",):
        if bl[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"filtered BFS path")
    check_hub_route(bl, f"BFS {fw}", split=mrt is rts)
    check_probe_routes(bl, fw, "staged")
    bfs[fw] = dict(res, bottom_up_levels=[
        lv for lv, b in enumerate(bfs_branches(want_f, BFS_STEPS), 1) if b])
    bfs_launches[fw] = bl

    # 6c. each new kernel against its plain version on the inputs of every
    # level of the main path, unfiltered and filtered
    calls = capture_bfs_calls(mrt, ns.store, "ns", seed, FR, GB)
    calls_f = capture_bfs_calls(mrt, ns.store, "ns", seed, FR, GB,
                                filt=ns.w_filter)
    bfs_err = max(check_bfs_calls(K, calls), check_bfs_calls(K, calls_f))
    k11 = loop_bound(K, lambda: mrt.bfs(ns.store, "ns", [seed], ["KNOWS"],
                                        "out", BFS_STEPS))
    k11 = {"device_loop_ms": bfs[mlabel]["device_p50_ms"],
           "bound_ms": sum(k11.values()), "bound_parts_ms": k11}
    log(f"[6c] K11 BFS loop ({mlabel}): {json.dumps(k11)}")
    log(f"[6c] bfs_probe checked at {len(calls['bfs_probe'])} + "
        f"{len(calls_f['bfs_probe'])} bottom-up calls (its words equal "
        f"pack_bits of the frontier), bfs_level at "
        f"{len(calls['bfs_level'])} + {len(calls_f['bfs_level'])} levels "
        f"(level 0 included): equal")
    for run, rcalls in ((mlabel, calls), (fw, calls_f)):
        log(f"[6c] K11 kernels whole run ({run}, every level's inputs): "
            f"{json.dumps(bfs_whole_run(K, rcalls, reps))}")

    # timed at the widest bottom-up probe of the unfiltered run, and at
    # the level update after it, each call on a fresh copy of that
    # level's depth array and candidates, so that every call writes the
    # level's new vertices as the main path does
    pa = max(calls["bfs_probe"], key=lambda a: int(a[3].sum()))
    pm, paths, floor = probe_measure(K, pa, reps)
    rname = f"bfs_probe ({paths['chosen']})"
    record(rname, None, None, pm["ms"], pm["plain_ms"], pm["lib_ms"],
           pm["nbytes"], pm["ops"], counts=bfs_launches[mlabel],
           err=bfs_err, tag="[6c]", note=f" ({mlabel}, widest bottom-up "
           f"level: {pm['slots']} slots, {pm['members']} on the frontier, "
           f"{pm['reached']} reached)")
    log(f"[6c] probe paths ({mlabel}, widest bottom-up level): "
        f"{json.dumps(paths)}")
    floor.update(kernel_ms=rows_out[-1]["ms"],
                 kernel_bound_ms=rows_out[-1]["bound_ms"])
    log(f"[6c] bfs_probe gather floor (the frontier's bytes at every valid "
        f"slot's neighbour, one index_select): {json.dumps(floor)}")
    la = calls["bfs_level"][[a[2] for a in calls["bfs_level"]].index(
        bu_levels[0])]
    lm = level_measure(K, la, reps)
    record("bfs_level", None, None, lm["ms"], lm["plain_ms"], lm["lib_ms"],
           lm["nbytes"], lm["ops"], counts=bfs_launches[mlabel],
           err=bfs_err, tag="[6c]", note=f" ({mlabel}, level {la[2]}, "
           f"{lm['slots']} slots, {lm['fresh']} fresh)")

    # expand at every level's inputs of both runs (split: the owner
    # route, against the tail route over the buffer extend_hubs_plain
    # fills), timed at the widest (level 2, bottom-up over the reverse
    # blocks on the split path) against its plain version
    n_owner = 0
    for ca, ckw in calls["expand"] + calls_f["expand"]:
        if ckw.get("hub_owner") is None:
            continue
        tkw = {k: v for k, v in ckw.items()
               if k not in ("hub_owner", "hub_local")}
        filled = K.extend_hubs_plain(ca[3].clone(), ckw["hub_owner"],
                                     ckw["hub_local"],
                                     ca[3].shape[-1] - ca[4].numel())
        max_abs_err(K.expand(*ca, **ckw),
                    K.expand_plain(*ca[:3], filled, *ca[4:], **tkw))
        n_owner += 1
    if (mrt is rts) != (n_owner == len(calls["expand"])
                        + len(calls_f["expand"])):
        raise AssertionError(f"[6c] {n_owner} of the BFS's expands took "
                             f"the owner route")
    log(f"[6c] expand (hub owners) at {n_owner} levels of the two runs: "
        f"equal to the tail route over extend_hubs_plain's buffer")
    ea, ekw = max(calls["expand"],
                  key=lambda c: int(K.expand_plain(*c[0], **c[1])[4].sum()))
    got, want_e = K.expand(*ea, **ekw), K.expand_plain(*ea, **ekw)
    etot, eEB = int(want_e[4].sum()), want_e[0].shape[-1]
    ef = ea[3]
    eH = 0 if ea[4] is None else int(ea[4].numel())
    ehubs = (None if ekw.get("hub_owner") is None
             else (ekw["hub_owner"], ekw["hub_local"]))
    record("expand (bfs)", got, want_e,
           cuda_ms(lambda: K.expand(*ea, **ekw), reps),
           cuda_ms(lambda: K.expand_plain(*ea, **ekw), reps),
           cuda_ms(lib_expand_for(SimpleNamespace(
               indptr=ea[0], nbr=ea[1], rank=ea[2]), ef, ehubs), reps),
           expand_bytes(ef.shape[-2], ef.shape[-1], eH, etot, eEB,
                        ehubs is not None),
           ef.shape[-2] * ef.shape[-1] * 3 + etot,
           counts={"expand (bfs)": bfs_launches[mlabel]["expand"]},
           tag="[6c]", note=f" ({mlabel}, widest level: {etot} slots, "
                f"{ef.shape[-2]} x {eEB})")

    # 6d. the BFS past the staged route's capacity: phase 5d's graph
    # (GLOBAL_PERSONS persons in 8 parts), config 5's BFS from vertex 0;
    # its frontier's words do not fit a block's shared memory, so every
    # bottom-up probe takes the global route
    stamp("phase 6d")
    from nebula_tpu_torch.bench.datagen import SnapshotStore
    gns = SimpleNamespace(snap=snap_g, store=SnapshotStore(snap_g))
    rtg = GpuRuntime()
    rtg.pin_prebuilt(snap_g)
    want_g = host_bfs(snap_g, [0], BFS_STEPS)
    glabel = f"{GLOBAL_PERSONS} persons"
    d, st, res, bl_g = run_bfs_path(rtg, gns, 0, glabel, K, tag="[6d]",
                                    space="g")
    if not np.array_equal(d, want_g):
        raise AssertionError(f"BFS {glabel}: dist differs from host_bfs")
    if st.hop_edges != bfs_level_edges(snap_g, want_g, BFS_STEPS):
        raise AssertionError(f"BFS {glabel}: hop_edges {st.hop_edges}")
    if K.probe_route(snap_g.num_parts, snap_g.vmax) != "global":
        raise AssertionError(f"[6d] ({snap_g.num_parts}, {snap_g.vmax}) "
                             f"stages")
    for name in BFS_KERNELS:
        if bl_g[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{glabel} BFS path")
    check_probe_routes(bl_g, glabel, "global")
    bfs[glabel] = dict(res, bottom_up_levels=[
        lv for lv, b in enumerate(bfs_branches(want_g, BFS_STEPS), 1) if b])
    calls_g = capture_bfs_calls(rtg, gns.store, "g", 0, FR, GB)
    err_g = check_bfs_calls(K, calls_g)
    log(f"[6d] K11 kernels whole run ({glabel}, every level's inputs): "
        f"{json.dumps(bfs_whole_run(K, calls_g, reps))}")
    pa = max(calls_g["bfs_probe"], key=lambda a: int(a[3].sum()))
    pm, paths, floor = probe_measure(K, pa, reps)
    record(f"bfs_probe ({paths['chosen']})", None, None, pm["ms"],
           pm["plain_ms"], pm["lib_ms"], pm["nbytes"], pm["ops"],
           counts=bl_g, err=err_g, tag="[6d]", note=f" ({glabel}, widest "
           f"bottom-up level: {pm['slots']} slots, {pm['members']} on the "
           f"frontier, {pm['reached']} reached)")
    log(f"[6d] probe paths ({glabel}, widest bottom-up level): "
        f"{json.dumps(paths)}")
    floor.update(kernel_ms=rows_out[-1]["ms"],
                 kernel_bound_ms=rows_out[-1]["bound_ms"])
    log(f"[6d] bfs_probe gather floor: {json.dumps(floor)}")
    rtg.unpin("g")
    del rtg, gns, snap_g, calls_g, pa
    torch.cuda.empty_cache()

    # -- 7. the delta plane: GO and the BFS through pending writes --------
    stamp("phase 7")
    from nebula_tpu_torch.bench.datagen import (SnapshotStore,
                                                host_csr_traverse,
                                                snapshot_from_arrays)
    delta = {"writes": dict(WRITES, seed=args.seed, cap=DELTA_CAP)}
    rtd = GpuRuntime(delta_max_edges=DELTA_CAP)
    dstore = SnapshotStore(ns.snap, ns.arrs)
    dstore.delta_watch("ns")
    # the same writes logged into a second store for phase 10c's mesh (a
    # delta log has one consumer)
    dstore8 = SnapshotStore(ns.snap, ns.arrs)
    dstore8.delta_watch("ns")
    t0 = time.perf_counter()
    rtd.pin_prebuilt(ns.snap)
    torch.cuda.synchronize()
    devd = rtd.snapshots["ns"]
    if devd.delta is None:
        raise AssertionError("no delta plane armed")
    delta["pin_s"] = time.perf_counter() - t0
    delta["hbm_bytes_before"] = rtd.hbm_bytes()
    delta["plane_bytes"] = devd.delta.last_put_bytes
    p50_before, go_before = time_go(rtd, dstore, ns, min(args.repeats,
                                                         DELTA_REPEATS))
    bfs_before = time_bfs(rtd, dstore, 0)[0]
    t0 = time.perf_counter()
    ops = write_batch(dstore, ns.arrs, ns.seeds, args.seed)
    delta["make_writes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_writes(dstore, ops)
    delta["store_writes_s"] = time.perf_counter() - t0
    apply_writes(dstore8, ops)
    # 7a. one pin folds the whole batch in
    t0 = time.perf_counter()
    if rtd.pin(dstore, "ns") is not devd:
        raise AssertionError("the writes re-pinned the snapshot")
    torch.cuda.synchronize()
    hd = devd.delta.host
    delta.update(apply_s=time.perf_counter() - t0,
                 bytes_put=devd.delta.last_put_bytes,
                 hbm_bytes_after=rtd.hbm_bytes(),
                 applied_epoch=devd.delta.applied_epoch,
                 insert_rows=hd.total_edges(), tombstones=hd.total_tombs(),
                 fill_ratio=hd.fill_ratio())
    if devd.delta.applied_epoch != dstore.space("ns").epoch \
            or dstore.delta_records("ns")[0]:
        raise AssertionError("the apply left writes behind")
    log(f"[7a] {len(ops)} writes applied: {json.dumps(delta)}")
    t0 = time.perf_counter()
    rebuilt = snapshot_from_arrays(dstore.mutated_arrays(), parts=8,
                                   space="ns")
    rebuild_s = time.perf_counter() - t0
    rtf = GpuRuntime()
    t0 = time.perf_counter()
    rtf.pin_prebuilt(rebuilt)
    torch.cuda.synchronize()
    delta.update(rebuild_snapshot_s=rebuild_s,
                 rebuild_pin_s=time.perf_counter() - t0)
    fstore = SnapshotStore(rebuilt)

    # 7b. GO through the pending writes
    K.reset_launch_counts()
    p50_after, go_last = time_go(rtd, dstore, ns, min(args.repeats,
                                                      DELTA_REPEATS))
    torch.cuda.synchronize()
    launches_d = K.launch_counts()
    for name in DELTA_GO_KERNELS:
        if launches_d[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"delta GO path")
    want_hops = delta_rule_edges(ns.snap, hd,
                                 go_frontiers(rebuilt, ns.seeds, 3))
    go_d = {}
    for flabel, filt, w_gt in (("unfiltered", None, None),
                               (f"w>{ns.w_gt}", ns.w_filter, ns.w_gt)):
        rows, st = go_last[flabel]
        fresh, _ = rtf.traverse(fstore, "ns", ns.seeds, ["KNOWS"], "out", 3,
                                edge_filter=filt, yields=ns.yields)
        d = np.asarray(rows.column_array("d"), np.int64)
        w = np.asarray(rows.column_array("w"), np.int64)
        if not (np.array_equal(d, np.asarray(fresh.column_array("d"),
                                             np.int64))
                and np.array_equal(w, np.asarray(fresh.column_array("w"),
                                                 np.int64))):
            raise AssertionError(f"delta GO {flabel}: rows differ, in "
                                 f"order, from the rebuilt snapshot's")
        _t, kept, want_d, want_w = host_csr_traverse(
            rebuilt, ns.seeds, 3, w_gt=w_gt, materialize=True)
        if len(rows) != kept or not same_multiset([d, w],
                                                  [want_d, want_w]):
            raise AssertionError(f"delta GO {flabel}: rows differ from "
                                 f"host_csr_traverse on the rebuild")
        if st.hop_edges != want_hops:
            raise AssertionError(f"delta GO {flabel}: hop_edges "
                                 f"{st.hop_edges} vs {want_hops}")
        go_d[flabel] = {"rows": len(rows), "hop_edges": st.hop_edges,
                        "e_cap": st.e_cap,
                        "p50_ms_no_writes": p50_before[flabel],
                        "p50_ms_writes_pending": p50_after[flabel]}
        # the last timed run's phases, without writes and with them
        for tag, (_r, s0) in (("no_writes", go_before[flabel]),
                              ("writes_pending", (rows, st))):
            go_d[flabel].update({f"device_ms_{tag}": s0.device_s * 1e3,
                                 f"fetch_ms_{tag}": s0.fetch_s * 1e3,
                                 f"mat_ms_{tag}": s0.mat_s * 1e3})
        log(f"[7b] delta GO 3 STEPS {flabel}: {json.dumps(go_d[flabel])}")
    log(f"    delta GO launches over "
        f"{2 * (min(args.repeats, DELTA_REPEATS) + 1)} queries: "
        f"{launches_d}")
    delta["go"] = go_d

    # 7c. config 5's BFS from vertex 0, every level top-down
    K.reset_launch_counts()
    bfs_after, dist_d, st_d = time_bfs(rtd, dstore, 0)
    torch.cuda.synchronize()
    bl_d = K.launch_counts()
    vv = np.arange(len(ns.snap.dense_to_vid))
    dd_ = dist_d[vv % 8, vv // 8]
    want_bfs = host_bfs(rebuilt, [0], BFS_STEPS)
    if not np.array_equal(dd_, want_bfs):
        raise AssertionError("delta BFS: dist differs from host_bfs on the "
                             "rebuilt snapshot")
    want_lv = delta_rule_edges(ns.snap, hd, [
        np.nonzero(want_bfs == lv)[0] for lv in range(BFS_STEPS)])
    if st_d.hop_edges != want_lv:
        raise AssertionError(f"delta BFS: hop_edges {st_d.hop_edges} vs "
                             f"{want_lv}")
    for name in DELTA_BFS_KERNELS:
        if bl_d[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"delta BFS path")
    if bl_d["bfs_probe"]:
        raise AssertionError("a bottom-up level ran with a plane armed")
    delta["bfs"] = {"hop_edges": st_d.hop_edges,
                    "reached": int((dd_ >= 0).sum()),
                    "p50_ms_no_writes": bfs_before,
                    "p50_ms_writes_pending": bfs_after,
                    "launches_per_run": {k: v / BFS_RUNS
                                         for k, v in bl_d.items() if v}}
    log(f"[7c] delta BFS from 0: {json.dumps(delta['bfs'])}")

    # 7d. the kernels of the delta path against their plain versions at
    # hop 3's shapes; the slots come from the plain versions
    bk = ("KNOWS", "out")
    blk = devd.blocks[bk]
    dl = rtd._grab_delta(devd, [bk], {"w"})[1][0]
    P, vmax, emax = devd.num_parts, devd.vmax, blk.nbr.shape[1]
    Dcap, Tcap = dl["d_src"].shape[1], dl["d_tomb"].shape[1]
    dargs = (dl["d_src"], dl["d_dst"], dl["d_rank"], dl["d_valid"],
             dl["d_tomb"], emax)
    fbm = new_frontier(devd)
    K.mark_plain(torch.tensor(sorted(set(ns.seeds)), dtype=torch.int32,
                              device=rtd.device), P, vmax, out=fbm)
    for _hop in range(2):
        sl = K.expand_plain(blk.indptr, blk.nbr, blk.rank, fbm, None, Dcap)
        K.merge_delta_plain(*sl, fbm, *dargs)
        fbm = new_frontier(devd)
        K.mark_plain(sl[1], P, vmax, out=fbm)
    delta_f3 = fbm                       # 10c's slots merge from it too
    a3 = (blk.indptr, blk.nbr, blk.rank, fbm, None, Dcap)
    base3 = K.expand_plain(*a3)
    err_e = max_abs_err(K.expand(*a3), base3)
    gs = [t.clone() for t in base3[:4]]
    ws = [t.clone() for t in base3[:4]]
    total3 = base3[4]
    gv, gt = K.merge_delta(*gs, total3, fbm, *dargs)
    wv, wt = K.merge_delta_plain(*ws, total3, fbm, *dargs)
    err_m = max_abs_err([gv, gt, *gs], [wv, wt, *ws])
    EB3 = gs[0].shape[1] - Dcap
    prog, _ = X.compile_predicate(ns.w_filter, blk.prop_types, devd.pool,
                                  vid_to_dense=dstore.space("ns").dense_id,
                                  device=rtd.device)
    pa = (prog, *ws, wv, [blk.props["w"]], [dl["d_props"]["w"]])
    keep_k, keep_p = K.predicate_mask(*pa), K.predicate_mask_plain(*pa)
    err_p = max_abs_err([keep_k], [keep_p])
    ca = (*ws, keep_p, [blk.props["w"]], [dl["d_props"]["w"]])
    ck, cp = K.compact_capture(*ca), K.compact_capture_plain(*ca)
    err_c = max_abs_err([*ck[:4], *ck[4], ck[5]], [*cp[:4], *cp[4], cp[5]])
    n_valid = int((torch.arange(EB3, device=rtd.device)
                   < total3[:, None]).sum())
    hits = n_valid - int(wv[:, :EB3].sum())
    active = int(wv[:, EB3:].sum())
    pid = torch.arange(P, dtype=torch.int32, device=rtd.device)[:, None]
    col = torch.arange(EB3, dtype=torch.int32, device=rtd.device)

    def lib_merge(s=ws):
        # the reference's formulation: searchsorted + gather + cat
        e = s[3][:, :EB3].contiguous()
        pos = torch.searchsorted(dl["d_tomb"], e).clamp_(max=Tcap - 1)
        vb = (col < total3[:, None]) \
            & (torch.gather(dl["d_tomb"], 1, pos) != e)
        act = dl["d_valid"] & torch.gather(
            fbm, 1, dl["d_src"].clamp(0, vmax - 1).long())
        return (torch.cat([vb, act], 1),
                torch.cat([s[0][:, :EB3],
                           torch.where(act, dl["d_src"] * P + pid, -1)], 1),
                torch.cat([s[1][:, :EB3],
                           torch.where(act, dl["d_dst"], -1)], 1),
                torch.cat([s[2][:, :EB3],
                           torch.where(act, dl["d_rank"], 0)], 1),
                total3 + act.sum(1, dtype=torch.int32))

    def noop():
        pass

    log(f"[7d] at hop 3: {P}x({EB3}+{Dcap}) slots, {n_valid} valid, "
        f"{hits} tombstoned, {active} delta rows active; expand "
        f"(tail), predicate_mask and compact_capture (delta halves) equal "
        f"to their plain versions (max abs err {max(err_e, err_p, err_c)})")
    # bytes: eidx of the valid slots, the valid byte of every slot, dst at
    # the hits; per delta row 13 bytes read, 17 written and its frontier
    # byte; the tombstone rows once; total in and out.  Operations: about
    # log2(Tcap) + 1 probes per valid slot
    probes = max(int(Tcap).bit_length(), 1)
    record("merge_delta", None, None,
           cuda_ms_fresh(lambda: K.merge_delta(*gs, total3, fbm, *dargs),
                         noop, reps),
           cuda_ms_fresh(lambda: K.merge_delta_plain(*ws, total3, fbm,
                                                     *dargs), noop, reps),
           cuda_ms_fresh(lib_merge, noop, reps),
           4 * n_valid + P * EB3 + 4 * hits + P * Dcap * (13 + 17 + 1)
           + 4 * P * Tcap + 8 * P,
           n_valid * probes + 4 * P * Dcap,
           counts=launches_d, err=err_m, tag="[7d]",
           note=f" (delta GO hop 3: {n_valid} valid slots, {hits} "
                f"tombstoned, {active} of {P * Dcap} delta rows active)")

    # -- 8. multi-lane batched GO (bench.py config batching) --------------
    stamp("phase 8")
    from nebula_tpu_torch.gpu.hop import new_frontier as nf
    add_company()
    brt = rts if rts is not None else rt
    blabel = "split" if rts is not None else "unsplit"
    seeds = ns.seeds
    dst_only = [(E.FunctionCall("dst", [E.EdgeExpr()]), "d")]
    batch = {"snapshot": blabel}
    batch["8a"], _ = run_batch(
        "8a", go_call(brt, ns.store, 1, None, dst_only),
        [[x] for x in seeds], 1, K)
    batch["8b"], launches_b = run_batch(
        "8b", go_call(brt, ns.store, 3, ns.w_filter, ns.yields),
        [seeds[2 * i:2 * i + 2] for i in range(8)], 3, K)
    batch["8c"], launches_c = run_batch(
        "8c", go_call(rtd, dstore, 3, ns.w_filter, ns.yields),
        [seeds[4 * i:4 * i + 4] for i in range(4)], 3, K)
    for name in SPLIT_KERNELS if rts is not None else UNSPLIT_KERNELS:
        if launches_b[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 f"batched main path")
    check_hub_route(launches_b, "[8b]", split=rts is not None)
    if launches_c["merge_delta"] <= 0:
        raise AssertionError("merge_delta never launched in the batched "
                             "delta path")
    lane_counts = {k + " (lanes)": v for k, v in launches_b.items()}
    lane_counts["merge_delta (lanes)"] = launches_c["merge_delta"]
    lane_counts["extend_hubs (fused into expand, lanes)"] = launches_b[
        HUB_ROUTE]

    # 8d. each lane-widened kernel against its plain version at 8b's lane
    # shapes (merge_delta at 8c's); inputs from the plain versions
    stamp("phase 8d")
    bdev = brt.snapshots["ns"]
    lane8 = [seeds[2 * i:2 * i + 2] for i in range(8)]
    ids8, bufs8, dsts8 = lane_frontiers(K, bdev, lane8, 3)
    blk = bdev.blocks[("KNOWS", "out")]
    P, vmax, H = bdev.num_parts, bdev.vmax, bdev.num_hubs
    L = len(lane8)
    R = L * P
    emax = blk.nbr.shape[1]
    lreps = 10
    k10 = {}

    def lrec(name, got, want, ms, plain_ms, lib_ms, nbytes, ops, note):
        record(name + " (lanes)", got, want, ms, plain_ms, lib_ms, nbytes,
               ops, counts=lane_counts, tag="[8d]", note=note)
        k10[name] = k10.get(name, 0.0) + rows_out[-1]["bound_ms"]

    # expand at each hop (timed, with its bound, at hop 3); split: the
    # owner route on the lane stack as the loop leaves it (hub columns
    # zero), against the tail route over the stack extend_hubs_plain fills
    hubs8 = (bdev.hub_owner, bdev.hub_local) if H else None
    okw8 = dict(zip(("hub_owner", "hub_local"), hubs8)) if H else {}
    for hop, f in enumerate(bufs8, 1):
        a = (blk.indptr, blk.nbr, blk.rank, zero_tail(f, vmax) if H else f,
             bdev.hub_dense)
        got = K.expand(*a, **okw8)
        want = K.expand_plain(blk.indptr, blk.nbr, blk.rank, f,
                              bdev.hub_dense)
        err = max_abs_err(got, want)
        tot, EB = int(want[4].sum()), want[0].shape[-1]
        union = int(K.expand_plain(blk.indptr, blk.nbr, blk.rank, f.any(0),
                                   bdev.hub_dense)[4].sum())
        # the lanes' frontiers (their ownership columns with the owner
        # tables, every column without) read once
        front = R * vmax + 8 * H if H else R * f.shape[-1]
        nbytes = (P * (f.shape[-1] + 1) * 4 + front + 8 * union
                  + 16 * R * EB + 4 * R + 4 * H)
        ops = R * f.shape[-1] * 3 + tot
        if hop < 3:
            b_ms, _ = bound(nbytes, ops)
            k10["expand"] = k10.get("expand", 0.0) + b_ms
            log(f"[8d] expand (lanes) hop {hop}: {R}x{EB} slots, {tot} "
                f"valid ({union} distinct edges), equal (max abs err "
                f"{err})")
            continue
        x3 = (nbytes, ops)
        lrec("expand", got, want,
             cuda_ms(lambda a=a: K.expand(*a, **okw8), lreps),
             cuda_ms(lambda a=a: K.expand_plain(*a, **okw8), lreps),
             cuda_ms(lib_expand_for(blk, a[3], hubs8), lreps), nbytes,
             ops, f" (hop 3: {L} lanes x {P} parts x {EB} slots, {tot} "
                  f"valid, {union} distinct edges)")

    # mark: the lane seed build (K6) and hop 2's slots
    for hop, d in ((0, ids8), (2, dsts8[1])):
        got = K.mark(d, P, vmax, out=nf(bdev, L)[..., :vmax])
        want = K.mark_plain(d, P, vmax, out=nf(bdev, L)[..., :vmax])
        n_ids = d.numel()
        nbytes, ops = 4 * n_ids + R * (vmax + H), 3 * n_ids
        if hop == 0:
            b_ms, _ = bound(nbytes, ops)
            k10["mark"] = k10.get("mark", 0.0) + b_ms
            log(f"[8d] mark (lanes) seeds: {tuple(d.shape)} ids, equal "
                f"(max abs err {max_abs_err([got], [want])})")
            continue
        dl_ = d.reshape(L, -1).long()
        lane_i = torch.arange(L, device=d.device)[:, None].expand_as(dl_)
        sel = dl_ >= 0
        li, dv = lane_i[sel], dl_[sel]
        one = torch.ones((), dtype=torch.bool, device=d.device)

        def lib_mark(li=li, dv=dv):
            out = torch.zeros((L, P, vmax), dtype=torch.bool,
                              device=dv.device)
            return out.index_put_((li, dv % P, dv // P), one)

        lrec("mark", [got], [want],
             cuda_ms(lambda d=d: K.mark(d, P, vmax,
                                        out=nf(bdev, L)[..., :vmax]), lreps),
             cuda_ms(lambda d=d: K.mark_plain(d, P, vmax,
                                              out=nf(bdev, L)[..., :vmax]),
                     lreps),
             cuda_ms(lib_mark, lreps), nbytes, ops,
             f" (hop 2: {n_ids} slots into {L} lanes, with the zero fill)")
        mark_paths(K, "[8d]", f"hop 2, {n_ids} slots into {L} lanes",
                   lambda p, d=d: K.mark(d, P, vmax,
                                         out=nf(bdev, L)[..., :vmax],
                                         path=p),
                   want, K.mark_path(n_ids // L, P, vmax), lreps)
        # hop 1's mark, for the K10 bound
        b_ms, _ = bound(4 * dsts8[0].numel() + R * (vmax + H),
                        3 * dsts8[0].numel())
        k10["mark"] += b_ms

    # K8 in the lanes, folded into expand's scan: each lane's hub bits
    # from its own owner rows, the fused pass at hop 3 (the expand lanes
    # row's launch) held against the tail route over the filled stack,
    # beside the parent's hub gather over the stack
    if H:
        f3 = bufs8[2]
        a3z = (blk.indptr, blk.nbr, blk.rank, zero_tail(f3, vmax),
               bdev.hub_dense)
        ft8 = f3.clone()
        own8, loc8 = bdev.hub_owner.long(), bdev.hub_local.long()

        def lib_hubs8():
            # one gather and one broadcast assignment, indices ready
            ft8[..., vmax:] = ft8[:, own8, loc8][:, None, :]
            return ft8

        want = K.expand_plain(blk.indptr, blk.nbr, blk.rank, f3,
                              bdev.hub_dense)
        record("extend_hubs (fused into expand, lanes)",
               K.expand(*a3z, **okw8), want,
               cuda_ms(lambda: K.expand(*a3z, **okw8), lreps),
               cuda_ms(lambda: K.expand_plain(*a3z, **okw8), lreps),
               cuda_ms(lib_expand_for(blk, a3z[3], hubs8), lreps), *x3,
               counts=lane_counts, tag="[8d]",
               note=f" (hop 3: {L} lanes x {P} parts, {H} hubs: the "
                    f"owner route)")
        log(f"[8d] K8 (lanes): the parent's library gather over the "
            f"stack {cuda_ms(lib_hubs8, lreps)} ms")

    # predicate_mask and compact_capture at the filtered hop 3
    a3 = (blk.indptr, blk.nbr, blk.rank, bufs8[2], bdev.hub_dense)
    src, dst, rk, eidx, total = K.expand_plain(*a3)
    EB3 = src.shape[-1]
    tot3 = int(total.sum())
    valid3 = torch.arange(EB3, device=src.device) < total[..., None]
    union3 = distinct_edges(eidx, valid3)
    prog, _ = X.compile_predicate(ns.w_filter, blk.prop_types, bdev.pool,
                                  vid_to_dense=ns.store.space("ns").dense_id,
                                  device=brt.device)
    pa = (prog, src, dst, rk, eidx, total, [blk.props["w"]])
    keep_k, keep_p = K.predicate_mask(*pa), K.predicate_mask_plain(*pa)
    lrec("predicate_mask", [keep_k], [keep_p],
         cuda_ms(lambda: K.predicate_mask(*pa), lreps),
         cuda_ms(lambda: K.predicate_mask_plain(*pa), lreps), None,
         4 * tot3 + 8 * union3 + R * EB3 + 4 * R, tot3 * len(prog.code),
         f" (w > 50 at hop 3: {R}x{EB3} slots, {tot3} valid, {union3} "
         f"distinct edges)")
    predicate_paths(K, "[8d]", f"w > 50 at hop 3, {R}x{EB3} slots", pa,
                    keep_p, lreps)
    ca = (src, dst, rk, eidx, keep_p, [blk.props["w"]])
    ck = K.compact_capture(*ca, extent=total)
    cp = K.compact_capture_plain(*ca, extent=total)
    n_kept = int(keep_p.sum())
    kept_union = distinct_edges(eidx, keep_p)
    wcol8 = blk.props["w"]

    def lib_compact8():
        pi, si = keep_p.view(R, EB3).nonzero(as_tuple=True)
        flat = pi * EB3 + si
        outs = [t.reshape(-1).index_select(0, flat)
                for t in (src, dst, rk, eidx)]
        outs.append(wcol8[pi % P, outs[3].long()])
        return outs

    lrec("compact_capture", [*ck[:4], *ck[4], ck[5]],
         [*cp[:4], *cp[4], cp[5]],
         cuda_ms(lambda: K.compact_capture(*ca, extent=total), lreps),
         cuda_ms(lambda: K.compact_capture_plain(*ca, extent=total), lreps),
         cuda_ms(lib_compact8, lreps),
         compact_bytes(R * EB3, tot3, kept_union, 1, R), 2 * tot3,
         f" (hop 3: {R}x{EB3} slots, {n_kept} kept, {kept_union} distinct "
         f"edges gathered)")

    # merge_delta at 8c's hop 3 (4 lanes on the delta-armed snapshot)
    lane4 = [seeds[4 * i:4 * i + 4] for i in range(4)]
    dblk = devd.blocks[("KNOWS", "out")]
    dl = rtd._grab_delta(devd, [("KNOWS", "out")], {"w"})[1][0]
    Dcap, Tcap = dl["d_src"].shape[1], dl["d_tomb"].shape[1]
    _ids4, bufs4, _ = lane_frontiers(K, devd, lane4, 3, dl=dl, extra=Dcap)
    f4 = bufs4[2][..., :devd.vmax]
    base4 = K.expand_plain(dblk.indptr, dblk.nbr, dblk.rank, bufs4[2], None,
                           Dcap)
    dargs = (dl["d_src"], dl["d_dst"], dl["d_rank"], dl["d_valid"],
             dl["d_tomb"], dblk.nbr.shape[1])
    gs = [t.clone() for t in base4[:4]]
    ws = [t.clone() for t in base4[:4]]
    gv, gt = K.merge_delta(*gs, base4[4], f4, *dargs)
    wv, wt = K.merge_delta_plain(*ws, base4[4], f4, *dargs)
    L4, R4 = len(lane4), len(lane4) * devd.num_parts
    EB4 = gs[0].shape[-1] - Dcap
    n_valid = int((torch.arange(EB4, device=rtd.device)
                   < base4[4][..., None]).sum())
    hits = n_valid - int(wv[..., :EB4].sum())
    active = int(wv[..., EB4:].sum())
    probes = max(int(Tcap).bit_length(), 1)
    dP = devd.num_parts
    pq4 = torch.arange(R4, device=rtd.device) % dP
    col4 = torch.arange(EB4, device=rtd.device)
    f4r = f4.reshape(R4, -1)
    vmax4 = f4r.shape[1]

    def lib_merge4(s=[t.view(R4, -1) for t in ws]):
        # phase 7d's searchsorted + gather + cat, each lane row q reading
        # the delta rows of part q mod P
        e = s[3][:, :EB4].contiguous()
        tomb = dl["d_tomb"][pq4]
        pos = torch.searchsorted(tomb, e).clamp_(max=Tcap - 1)
        vb = (col4 < base4[4].view(R4, 1)) \
            & (torch.gather(tomb, 1, pos) != e)
        ds = dl["d_src"][pq4]
        act = dl["d_valid"][pq4] & torch.gather(
            f4r, 1, ds.clamp(0, vmax4 - 1).long())
        return (torch.cat([vb, act], 1),
                torch.cat([s[0][:, :EB4],
                           torch.where(act, ds * dP + pq4[:, None], -1)], 1),
                torch.cat([s[1][:, :EB4],
                           torch.where(act, dl["d_dst"][pq4], -1)], 1),
                torch.cat([s[2][:, :EB4],
                           torch.where(act, dl["d_rank"][pq4], 0)], 1),
                base4[4].view(R4) + act.sum(1, dtype=torch.int32))

    lrec("merge_delta", [gv, gt, *gs], [wv, wt, *ws],
         cuda_ms_fresh(lambda: K.merge_delta(*gs, base4[4], f4, *dargs),
                       noop, lreps),
         cuda_ms_fresh(lambda: K.merge_delta_plain(*ws, base4[4], f4,
                                                   *dargs), noop, lreps),
         cuda_ms_fresh(lib_merge4, noop, lreps),
         4 * n_valid + R4 * EB4 + 4 * hits + dP * Dcap * 13
         + R4 * Dcap * (17 + 1) + 4 * dP * Tcap + 8 * R4,
         n_valid * probes + 4 * R4 * Dcap,
         f" (8c hop 3: {L4} lanes x {dP} parts x ({EB4}+{Dcap}) slots, "
         f"{n_valid} valid, {hits} tombstoned, {active} delta rows active)")
    batch["k10"] = {
        "device_loop_ms": batch["8b"]["batch_device_s"] * 1e3,
        "solo_device_loops_ms": batch["8b"]["solo_device_s_sum"] * 1e3,
        "launches_per_batch": kernel_launches(launches_b),
        # the sum of the lane-widened kernels' bounds at 8b's shapes: every
        # expand (the hub bits read in its scan) and mark of the loop,
        # predicate and compact at hop 3 (merge_delta is 8c's, not in 8b's
        # loop)
        "bound_ms": sum(v for k, v in k10.items() if k != "merge_delta"),
        "bound_parts_ms": k10}
    log(f"[8] K10 lanes loop at 8b: {json.dumps(batch['k10'])}")
    from nebula_tpu_torch.utils.workload import live_registry
    for qid in (-1, -2):
        live_registry().deregister(qid)

    # -- 9. MATCH: the every-hop capture (bench.py config 4b) -------------
    stamp("phase 9a")
    from nebula_tpu_torch.bench.datagen import (host_hop_edges,
                                                host_trail_paths,
                                                make_social_arrays,
                                                unique_keys)
    match = {}
    # 9a. config 4b's graph: make_social_graph's draws (uniform sources,
    # 15% Zipf(1.6) destinations) with one edge per (src, dst) key, the
    # last drawn, as the store's overwrite keeps it
    t0 = time.perf_counter()
    persons9 = min(args.persons, MATCH_PERSONS)
    arrs9 = unique_keys(make_social_arrays(persons9, MATCH_DEGREE,
                                           seed=MATCH_GRAPH_SEED,
                                           src_hot_frac=0.0))
    snap9 = snapshot_from_arrays(arrs9, parts=8, space="twb")
    store9 = SnapshotStore(snap9)
    deg9 = np.bincount(arrs9["src"], minlength=int(arrs9["n"]))
    seeds9 = np.flatnonzero(deg9 >= 3)[:MATCH_SEEDS].tolist()
    rt9 = GpuRuntime()
    rt9.pin_prebuilt(snap9)
    torch.cuda.synchronize()
    match["9a"] = {"persons": persons9, "edges": int(arrs9["src"].size),
                   "seeds": len(seeds9), "setup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    want_trails = host_trail_paths(snap9, seeds9, MATCH_HOPS)
    match["9a"]["host_trail_paths_s"] = time.perf_counter() - t0
    frames9, st9, l9a, p50_9a, trails9 = run_match(
        rt9, store9, "twb", seeds9, MATCH_HOPS, None, 3, K)
    if trails9 != want_trails:
        raise AssertionError(f"[9a] {trails9} trails from the frames, "
                             f"host_trail_paths {want_trails}")
    check_frames("9a", frames9, host_hop_edges(snap9, seeds9, MATCH_HOPS))
    want_l = {"expand": MATCH_HOPS, "compact_capture": MATCH_HOPS,
              "mark": MATCH_HOPS}        # MATCH_HOPS - 1 hops + the seeds
    if {k: v for k, v in l9a.items() if v} != want_l:
        raise AssertionError(f"[9a] launches {l9a}, want {want_l}")
    match["9a"].update(trails=trails9, frame_edges=[f.n for f in frames9],
                       hop_edges=st9.hop_edges, e_cap=st9.e_cap,
                       launches={k: v for k, v in l9a.items() if v},
                       p50_s=p50_9a)
    log(f"[9a] {json.dumps(match['9a'])}")
    del frames9

    # 9b. the north star (split at --split as bench.py runs it), MATCH
    # *1..3 WHERE KNOWS.w > 50 from the 16 seeds, then unfiltered
    stamp("phase 9b")
    mrt = rts if rts is not None else rt
    mlabel = "split" if rts is not None else "unsplit"
    mdev = mrt.snapshots["ns"]
    # no trail assembly here: from vertex 0's 535,121 out-edges the walks
    # number hundreds of millions by hop 3 (9a assembles)
    frames9b, st9b, launches9, p50_9b, _ = run_match(
        mrt, ns.store, "ns", ns.seeds, 3, ns.w_filter, 3, K, assemble=False)
    check_frames("9b", frames9b, host_hop_edges(ns.snap, ns.seeds, 3,
                                                w_gt=ns.w_gt))
    want_l = {"expand": 3, "predicate_mask": 3, "compact_capture": 3,
              "mark": 3}
    if mdev.num_hubs:
        want_l[HUB_ROUTE] = 3
    if {k: v for k, v in launches9.items() if v} != want_l:
        raise AssertionError(f"[9b] launches {launches9}, want {want_l}")
    match["9b"] = {"snapshot": mlabel, "filter": f"w > {ns.w_gt}",
                   "frame_edges": [f.n for f in frames9b],
                   "hop_edges": st9b.hop_edges,
                   "frontier_sizes": st9b.frontier_sizes, "e_cap": st9b.e_cap,
                   "launches": {k: v for k, v in launches9.items() if v},
                   "p50_s": p50_9b}
    del frames9b
    t0 = time.perf_counter()
    frames_u, st_u = mrt.traverse_hops(ns.store, "ns", ns.seeds, ["KNOWS"],
                                       "out", 3)
    go_hop_edges = results[mlabel]["unfiltered"]["hop_edges"]
    if st_u.hop_edges != go_hop_edges:
        raise AssertionError(f"[9b] unfiltered hop_edges {st_u.hop_edges} "
                             f"vs GO 3 STEPS {go_hop_edges}")
    match["9b"]["unfiltered"] = {
        "hop_edges": st_u.hop_edges, "frame_edges": [f.n for f in frames_u],
        "total_s": time.perf_counter() - t0, "device_s": st_u.device_s,
        "fetch_s": st_u.fetch_s, "mat_s": st_u.mat_s}
    del frames_u
    log(f"[9b] {json.dumps(match['9b'])}")

    # 9c. eight concurrent MATCH expansions over 9a's graph share one run
    stamp("phase 9c")
    add_company()
    match["9c"], _ = run_batch(
        "9c", lambda sd: rt9.traverse_hops(store9, "twb", sd, ["KNOWS"],
                                           "out", MATCH_HOPS),
        [seeds9[224 * i:224 * (i + 1)] for i in range(8)], MATCH_HOPS, K,
        same=frames_equal, size=lambda fr: sum(f.n for f in fr))
    for qid in (-1, -2):
        live_registry().deregister(qid)

    # 9d. the kernels the every-hop mode runs at new shapes, against their
    # plain versions at 9b's: predicate_mask and compact_capture at the
    # narrow hops 1 and 2, mark with the predicate's keep at hop 2
    stamp("phase 9d")
    mblk = mdev.blocks[("KNOWS", "out")]
    P, vmax, H = mdev.num_parts, mdev.vmax, mdev.num_hubs
    prog9, _ = X.compile_predicate(ns.w_filter, mblk.prop_types, mdev.pool,
                                   vid_to_dense=ns.store.space(
                                       "ns").dense_id, device=mrt.device)
    ids9, hops9 = match_inputs(K, mdev, ns.seeds, prog9, 3)
    sizes = [int(b[:, :vmax].sum()) for b, _, _ in hops9]
    if sizes != st9b.frontier_sizes:
        raise AssertionError(f"[9d] plain frontiers {sizes} vs 9b's "
                             f"{st9b.frontier_sizes}")
    mcounts = {k + " (match)": v for k, v in launches9.items()}
    wcol = [mblk.props["w"]]
    k7 = {}                      # the every-hop loop's bounds at 9b

    def mrec(name, got, want, ms, plain_ms, lib_ms, nbytes, ops, note):
        record(name + " (match)", got, want, ms, plain_ms, lib_ms, nbytes,
               ops, counts=mcounts, tag="[9d]", note=note)

    got, want = [], []
    for h in (0, 1):
        _, sl, keep = hops9[h]
        got.append(K.predicate_mask(prog9, *sl[:4], sl[4], wcol))
        want.append(keep)
    for h, (f, sl, keep) in enumerate(hops9):
        EB, tot = sl[0].shape[1], int(sl[4].sum())
        n_kept = int(keep.sum())
        if H:
            # the owner route on the buffer as the loop leaves it, against
            # the tail route over the buffer extend_hubs_plain filled
            max_abs_err(K.expand(mblk.indptr, mblk.nbr, mblk.rank,
                                 zero_tail(f, vmax), mdev.hub_dense,
                                 hub_owner=mdev.hub_owner,
                                 hub_local=mdev.hub_local), sl)
            log(f"[9d] expand (hub owners) at hop {h + 1}: {P}x{EB} slots, "
                f"{tot} valid, equal to the tail route over "
                f"extend_hubs_plain's buffer")
        k7.setdefault("expand", 0.0)
        k7["expand"] += bound(expand_bytes(P, f.shape[1], H, tot, EB,
                                           bool(H)),
                              P * f.shape[1] * 3 + tot)[0]
        pred_cost = (tot * (4 + 8) + P * EB + 4 * P, tot * len(prog9.code))
        comp_cost = (compact_bytes(P * EB, tot, n_kept, 0, P), 2 * tot)
        k7["predicate_mask"] = k7.get("predicate_mask", 0.0) \
            + bound(*pred_cost)[0]
        k7["compact_capture"] = k7.get("compact_capture", 0.0) \
            + bound(*comp_cost)[0]
        # hops 1 and 2 mark their kept dsts (ids and keep read); the
        # seed build marks the 16 seed ids
        n_ids, id_bytes = (sl[1].numel(), 5) if h < 2 \
            else (ids9.numel(), 4)
        k7["mark"] = k7.get("mark", 0.0) + bound(
            id_bytes * n_ids + P * (vmax + H), 3 * n_ids)[0]
        if h == 1:
            pa = (prog9, *sl[:4], sl[4], wcol)
            mrec("predicate_mask", got, want,
                 cuda_ms(lambda: K.predicate_mask(*pa), reps),
                 cuda_ms(lambda: K.predicate_mask_plain(*pa), reps), None,
                 *pred_cost, f" (w > 50, hops 1 and 2; timed at hop 2: "
                             f"{P}x{EB} slots, {tot} valid, {n_kept} kept)")
            predicate_paths(K, "[9d]", f"w > 50 at hop 2, {P}x{EB} slots",
                            pa, keep, reps)
    got, want = [], []
    for h in (0, 1):
        _, sl, keep = hops9[h]
        for out, fn in ((got, K.compact_capture),
                        (want, K.compact_capture_plain)):
            r = fn(*sl[:4], keep, [], extent=sl[4])
            out.extend([*r[:4], r[5]])
    _, sl2, keep2 = hops9[1]
    EB2, tot2, kept2 = sl2[0].shape[1], int(sl2[4].sum()), int(keep2.sum())
    ca = (*sl2[:4], keep2, [])

    def lib_compact_m():
        pi, si = keep2.nonzero(as_tuple=True)
        flat = pi * EB2 + si
        return [t.view(-1).index_select(0, flat) for t in sl2[:4]]

    mrec("compact_capture", got, want,
         cuda_ms(lambda: K.compact_capture(*ca, extent=sl2[4]), reps),
         cuda_ms(lambda: K.compact_capture_plain(*ca, extent=sl2[4]), reps),
         cuda_ms(lib_compact_m, reps),
         compact_bytes(P * EB2, tot2, kept2, 0, P), 2 * tot2,
         f" (no yield column, hops 1 and 2; timed at hop 2: {P}x{EB2} "
         f"slots, {tot2} valid, {kept2} kept)")
    dst2 = sl2[1]
    got = K.mark(dst2, P, vmax, keep=keep2, out=new_frontier(mdev)[:, :vmax])
    want = K.mark_plain(dst2, P, vmax, keep=keep2,
                        out=new_frontier(mdev)[:, :vmax])
    if not torch.equal(want, hops9[2][0][:, :vmax]):
        raise AssertionError("[9d] hop 2's kept marks are not hop 3's "
                             "frontier")
    kd = dst2[keep2].long()
    one = torch.ones((), dtype=torch.bool, device=dst2.device)

    def lib_mark_m():
        out = torch.zeros((P, vmax), dtype=torch.bool, device=kd.device)
        return out.index_put_((kd % P, kd // P), one)

    n2 = dst2.numel()
    mrec("mark", [got], [want],
         cuda_ms(lambda: K.mark(dst2, P, vmax, keep=keep2,
                                out=new_frontier(mdev)[:, :vmax]), reps),
         cuda_ms(lambda: K.mark_plain(dst2, P, vmax, keep=keep2,
                                      out=new_frontier(mdev)[:, :vmax]),
                 reps),
         cuda_ms(lib_mark_m, reps), 5 * n2 + P * (vmax + H), 3 * n2,
         f" (keep = w > 50 at hop 2: {n2} slots, {kd.numel()} kept, with "
         f"the zero fill)")
    mark_paths(K, "[9d]", f"keep at hop 2, {n2} slots",
               lambda p: K.mark(dst2, P, vmax, keep=keep2,
                                out=new_frontier(mdev)[:, :vmax], path=p),
               want, K.mark_path(n2, P, vmax), reps)
    match["k7_every_hop"] = {
        "device_loop_ms": p50_9b["device_s"] * 1e3,
        "launches_per_run": kernel_launches(launches9),
        "bound_ms": sum(k7.values()), "bound_parts_ms": k7}
    log(f"[9] K7 every-hop loop at 9b: {json.dumps(match['k7_every_hop'])}")
    del hops9

    # -- 10. the sharded mesh: GO, the BFS, writes, MATCH, batching -------
    stamp("phase 10a")
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from nebula_tpu_torch.gpu.bfs import bfs_exchange_bytes
    from nebula_tpu_torch.gpu.device import make_mesh
    from nebula_tpu_torch.gpu.hop import (a2a_payload_bytes,
                                          exchange_marks_lanes,
                                          extend_fbm_sharded_lanes,
                                          new_group_marks,
                                          run_hops_sharded,
                                          seed_slot_frontiers)
    from nebula_tpu_torch.gpu.mesh import process_group_mesh
    mesh = {}
    # 10a. the main path's snapshot (split at --split when it ran) pinned
    # slot by slot on make_mesh(8): every slot on the one card
    lrt = rts if rts is not None else rt
    mlabel = "split" if rts is not None else "unsplit"
    ldev = lrt.snapshots["ns"]
    mesh8 = make_mesh(MESH_SLOTS)
    rt8 = GpuRuntime(mesh=mesh8, degree_split_threshold=ns.split_threshold)
    t0 = time.perf_counter()
    dev8 = rt8.pin_prebuilt(ns.snap)
    torch.cuda.synchronize()
    pin8_s = time.perf_counter() - t0
    H = dev8.num_hubs
    host8 = dev8.host
    per = dev8.shard_hbm_bytes()
    for sh in dev8.shards:
        # only part p's rows (and the hub tables) are on slot p
        mine = 4 + 12 * H + sum(
            getattr(b, n)[sh.part].nbytes
            for b in host8.blocks.values() for n in ("indptr", "nbr", "rank"))
        mine += sum(c[sh.part].nbytes for b in host8.blocks.values()
                    for c in b.props.values())
        if per[sh.part] != mine or sh.device != mesh8.devices[0]:
            raise AssertionError(f"[10a] slot {sh.part} holds {per[sh.part]}"
                                 f" bytes on {sh.device}, its part {mine}")
    # each slot keeps its own copy of the (H,) hub tables
    if sum(per.values()) != ldev.hbm_bytes() + (MESH_SLOTS - 1) * 12 * H:
        raise AssertionError(f"[10a] slots hold {sum(per.values())} bytes,"
                             f" the local pin {ldev.hbm_bytes()} with "
                             f"{H} hubs")
    mesh["10a"] = {"snapshot": mlabel, "slots": MESH_SLOTS,
                   "devices": sorted({str(d) for d in mesh8.devices}),
                   "pin_s": pin8_s, "hubs": H,
                   "slot_bytes": [per[p] for p in sorted(per)],
                   "local_pin_bytes": ldev.hbm_bytes()}
    want_x = 2 * a2a_payload_bytes(MESH_SLOTS, dev8.vmax)
    mesh_rows = {}
    K.reset_launch_counts()
    for flabel, filt in (("unfiltered", None),
                         (f"w>{ns.w_gt}", ns.w_filter)):
        ph = {k: [] for k in ("total_s", "device_s", "fetch_s", "mat_s")}
        for i in range(MESH_RUNS + 1):          # the first is warm-up
            t = time.perf_counter()
            rows, st = rt8.traverse(ns.store, "ns", ns.seeds, ["KNOWS"],
                                    "out", 3, edge_filter=filt,
                                    yields=ns.yields)
            total = time.perf_counter() - t
            if i:
                for k, v in (("total_s", total), ("device_s", st.device_s),
                             ("fetch_s", st.fetch_s), ("mat_s", st.mat_s)):
                    ph[k].append(v)
        want_rows, want_st = main_rows[flabel]
        if not rows_equal(rows, want_rows):
            raise AssertionError(f"[10a] {flabel}: rows differ, in order, "
                                 f"from phase 3's {mlabel} rows")
        if (st.hop_edges, st.frontier_sizes) != (want_st.hop_edges,
                                                 want_st.frontier_sizes):
            raise AssertionError(f"[10a] {flabel}: hop_edges "
                                 f"{st.hop_edges} frontier_sizes "
                                 f"{st.frontier_sizes} vs {mlabel}'s")
        if st.exchange_bytes != want_x or st.shards != MESH_SLOTS:
            raise AssertionError(f"[10a] {flabel}: exchange_bytes "
                                 f"{st.exchange_bytes} vs {want_x}")
        mesh_rows[flabel] = rows
        mesh["10a"][flabel] = {
            "rows": len(rows), "hop_edges": st.hop_edges,
            "frontier_sizes": st.frontier_sizes, "e_cap": st.e_cap,
            "local_e_cap": want_st.e_cap,
            "exchange_bytes": st.exchange_bytes,
            **{k.replace("_s", "_p50_ms"): float(np.median(v)) * 1e3
               for k, v in ph.items()},
            "local_p50_ms": results[mlabel][flabel]["p50_ms"],
            "local_device_p50_ms": results[mlabel][flabel]["device_p50_ms"],
            "samples": MESH_RUNS}
        log(f"[10a] mesh x{MESH_SLOTS} GO 3 STEPS {flabel}: "
            f"{json.dumps(mesh['10a'][flabel])}")
    torch.cuda.synchronize()
    launches10 = counts(K)
    # K16's pair fills the slots' hub columns, which expand reads: a slot
    # holds no owner row, so no expand takes the owner route
    if launches10[HUB_ROUTE]:
        raise AssertionError(f"[10a] {launches10[HUB_ROUTE]} owner-route "
                             f"expands on the mesh")
    for name in UNSPLIT_KERNELS + MESH_KERNELS + (
            MESH_HUB_KERNELS if H else ()):
        if launches10[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"mesh GO path")
    # the card's eight slots are one slot group, and each exchange kernel
    # runs once a group a step: a GO-3 query packs and unpacks twice and
    # extends the hub columns three times
    if len(mesh8.groups) != 1:
        raise AssertionError(f"[10a] {len(mesh8.groups)} slot groups on one "
                             f"card")
    n_go = 2 * (MESH_RUNS + 1)
    want10 = {"pack_bits": 2 * n_go, "unpack_or": 2 * n_go,
              "owned_hub_bits": 3 * n_go if H else 0,
              "fill_hub_columns": 3 * n_go if H else 0}
    if {k: launches10[k] for k in want10} != want10:
        raise AssertionError(f"[10a] exchange launches "
                             f"{ {k: launches10[k] for k in want10} } over "
                             f"{n_go} queries, want {want10}")
    mesh["10a"]["launches"] = {k: v for k, v in launches10.items() if v}
    log(f"[10a] pin and launches over {2 * (MESH_RUNS + 1)} queries: "
        + json.dumps({k: v for k, v in mesh["10a"].items()
                      if not isinstance(v, dict) or k == "launches"}))

    # 10b. config 5's BFS on the mesh: top-down at every level
    stamp("phase 10b")
    d8, st8, res8, bl8 = run_bfs_path(rt8, ns, ns.seeds[0],
                                      f"mesh x{MESH_SLOTS} {mlabel}", K,
                                      tag="[10b]")
    if not np.array_equal(d8, bfs_depths):
        raise AssertionError("[10b] depths differ from host_bfs (and "
                             "phase 6's)")
    want_lv = bfs_level_edges(ns.snap, bfs_depths, BFS_STEPS, switch=False)
    if st8.hop_edges != want_lv:
        raise AssertionError(f"[10b] hop_edges {st8.hop_edges} vs the "
                             f"top-down count {want_lv}")
    k17b = loop_bound(K, lambda: rt8.bfs(ns.store, "ns", [ns.seeds[0]],
                                         ["KNOWS"], "out", BFS_STEPS))
    k17b = {"device_loop_ms": res8["device_p50_ms"],
            "bound_ms": sum(k17b.values()), "bound_parts_ms": k17b}
    log(f"[10b] K17 BFS loop: {json.dumps(k17b)}")
    want_bx = bfs_exchange_bytes(MESH_SLOTS, dev8.vmax, BFS_STEPS)
    if st8.exchange_bytes != want_bx:
        raise AssertionError(f"[10b] exchange_bytes {st8.exchange_bytes} "
                             f"vs {want_bx}")
    for name in MESH_KERNELS + ("expand", "mark", "bfs_level"):
        if bl8[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"mesh BFS path")
    # one exchange and (split) one hub extension a level, each kernel once
    # for the one group
    want10b = {k: (BFS_STEPS * BFS_RUNS
                   if k in MESH_KERNELS or H else 0)
               for k in MESH_KERNELS + MESH_HUB_KERNELS}
    if {k: bl8[k] for k in want10b} != want10b:
        raise AssertionError(f"[10b] exchange launches "
                             f"{ {k: bl8[k] for k in want10b} } over "
                             f"{BFS_RUNS} runs, want {want10b}")
    if bl8["bfs_probe"]:
        raise AssertionError("[10b] a bottom-up level ran on the mesh")
    mesh["10b"] = dict(res8, exchange_bytes=st8.exchange_bytes,
                       local_p50_ms=bfs[mlabel]["p50_ms"])

    # 10c. GO through phase 7's 40,000 pending writes on an 8-slot pin of
    # the unsplit delta-armed snapshot (the writes' twin log)
    stamp("phase 10c")
    rt8d = GpuRuntime(mesh=make_mesh(MESH_SLOTS), delta_max_edges=DELTA_CAP)
    dev8d = rt8d.pin_prebuilt(ns.snap)
    t0 = time.perf_counter()
    if rt8d.pin(dstore8, "ns") is not dev8d or dev8d.delta is None:
        raise AssertionError("[10c] the writes re-pinned the mesh snapshot")
    torch.cuda.synchronize()
    mesh["10c"] = {"apply_s": time.perf_counter() - t0,
                   "bytes_put": dev8d.delta.last_put_bytes,
                   "insert_rows": dev8d.delta.host.total_edges()}
    K.reset_launch_counts()
    for flabel, filt in (("unfiltered", None),
                         (f"w>{ns.w_gt}", ns.w_filter)):
        lat = []
        for _ in range(DELTA_REPEATS + 1):
            t = time.perf_counter()
            rows, st = rt8d.traverse(dstore8, "ns", ns.seeds, ["KNOWS"],
                                     "out", 3, edge_filter=filt,
                                     yields=ns.yields)
            lat.append(time.perf_counter() - t)
        want_rows, want_st = go_last[flabel]
        if not rows_equal(rows, want_rows) \
                or st.hop_edges != want_st.hop_edges:
            raise AssertionError(f"[10c] {flabel}: rows or hop_edges differ "
                                 f"from phase 7's")
        mesh["10c"][flabel] = {"rows": len(rows), "hop_edges": st.hop_edges,
                               "p50_ms": float(np.median(lat[1:])) * 1e3,
                               "device_ms": st.device_s * 1e3,
                               "local_p50_ms": p50_after[flabel]}
    torch.cuda.synchronize()
    l10c = K.launch_counts()
    for name in MESH_KERNELS + ("merge_delta",):
        if l10c[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"mesh delta path")
    mesh["10c"]["launches"] = {k: v for k, v in l10c.items() if v}
    log(f"[10c] {json.dumps(mesh['10c'])}")

    # merge_delta (mesh): every slot's merge at hop 3 — 7d's frontier
    # row, the slot's own delta rows, parts = 8 and pid = p — against its
    # plain version, and the slot's merged slots against row p of the
    # local merge; timed at the slot with the most merged slots
    bk8 = ("KNOWS", "out")
    m8 = []
    err_m8 = 0.0
    blk7 = devd.blocks[bk8]
    dl7 = rtd._grab_delta(devd, [bk8], {"w"})[1][0]
    loc3 = K.expand_plain(blk7.indptr, blk7.nbr, blk7.rank, delta_f3, None,
                          dl7["d_src"].shape[1])
    loc_v, loc_t = K.merge_delta_plain(
        *loc3, delta_f3, dl7["d_src"], dl7["d_dst"], dl7["d_rank"],
        dl7["d_valid"], dl7["d_tomb"], blk7.nbr.shape[1])

    def slot_rows(cols, keep):
        # the kept (src, dst, rank, eidx) slots
        return [c[keep].cpu().numpy() for c in cols]
    for sh, dls in zip(dev8d.shards, rt8d._grab_delta(dev8d, [bk8],
                                                      {"w"})[1]):
        b8, d8l, q = sh.blocks[bk8], dls[0], sh.part
        f8 = delta_f3[q:q + 1][None]
        dc8 = d8l["d_src"].shape[1]
        da8 = (d8l["d_src"], d8l["d_dst"], d8l["d_rank"], d8l["d_valid"],
               d8l["d_tomb"], b8.nbr.shape[1])
        base8 = K.expand_plain(b8.indptr, b8.nbr, b8.rank, f8, None, dc8,
                               parts=MESH_SLOTS, pid=q)
        g8 = [t.clone() for t in base8[:4]]
        w8 = [t.clone() for t in base8[:4]]
        gvt = K.merge_delta(*g8, base8[4], f8, *da8, parts=MESH_SLOTS,
                            pid=q)
        wvt = K.merge_delta_plain(*w8, base8[4], f8, *da8,
                                  parts=MESH_SLOTS, pid=q)
        err_m8 = max(err_m8, max_abs_err([*gvt, *g8], [*wvt, *w8]))
        if int(wvt[1]) != int(loc_t[q]) or not same_multiset(
                slot_rows([t[0, 0] for t in w8], wvt[0][0, 0]),
                slot_rows([t[q] for t in loc3[:4]], loc_v[q])):
            raise AssertionError(f"[10c] slot {q}'s merged slots are not "
                                 f"row {q} of the local merge")
        m8.append((int(wvt[1]), q, f8, base8, g8, w8, da8, dc8, wvt[0]))
    tot8, q, f8, base8, g8, w8, da8, dc8, wv8 = max(m8, key=lambda m: m[0])
    del m8
    EB8 = base8[0].shape[-1] - dc8
    nv8 = int(base8[4])
    hits8 = nv8 - int(wv8[..., :EB8].sum())
    act8 = int(wv8[..., EB8:].sum())
    T8 = da8[4].shape[1]
    col8 = torch.arange(EB8, dtype=torch.int32, device=f8.device)

    def lib_merge8(s=[t[0] for t in w8], tq=base8[4][0], fq=f8[0],
                   d=[t for t in da8[:5]]):
        # 7d's formulation on the slot's row, its ids from the part offset
        e = s[3][:, :EB8].contiguous()
        pos = torch.searchsorted(d[4], e).clamp_(max=T8 - 1)
        vb = (col8 < tq[:, None]) & (torch.gather(d[4], 1, pos) != e)
        act = d[3] & torch.gather(fq, 1, d[0].clamp(0, fq.shape[1] - 1)
                                  .long())
        return (torch.cat([vb, act], 1),
                torch.cat([s[0][:, :EB8],
                           torch.where(act, d[0] * MESH_SLOTS + q, -1)], 1),
                torch.cat([s[1][:, :EB8], torch.where(act, d[1], -1)], 1),
                torch.cat([s[2][:, :EB8], torch.where(act, d[2], 0)], 1),
                tq + act.sum(1, dtype=torch.int32))

    record("merge_delta (mesh)", None, None,
           cuda_ms_fresh(lambda: K.merge_delta(
               *g8, base8[4], f8, *da8, parts=MESH_SLOTS, pid=q), noop, reps),
           cuda_ms_fresh(lambda: K.merge_delta_plain(
               *w8, base8[4], f8, *da8, parts=MESH_SLOTS, pid=q), noop, reps),
           cuda_ms_fresh(lib_merge8, noop, reps),
           4 * nv8 + EB8 + 4 * hits8 + dc8 * (13 + 17 + 1) + 4 * T8 + 8,
           nv8 * max(int(T8).bit_length(), 1) + 4 * dc8,
           counts={"merge_delta (mesh)": l10c["merge_delta"]}, err=err_m8,
           tag="[10c]",
           note=f" (every slot at hop 3, equal to the local merge's row; "
                f"timed at slot {q}: {nv8} valid slots, {hits8} "
                f"tombstoned, {act8} of {dc8} delta rows active, "
                f"{tot8} merged)")
    del rt8d, dev8d, g8, w8, base8, loc3, loc_v

    # 10d. config 4b's MATCH on an 8-slot mesh
    stamp("phase 10d")
    rt9m = GpuRuntime(mesh=make_mesh(MESH_SLOTS))
    rt9m.pin_prebuilt(snap9)
    frames_m, st_m, l10d, p50_10d, trails_m = run_match(
        rt9m, store9, "twb", seeds9, MATCH_HOPS, None, MESH_RUNS, K)
    if trails_m != want_trails:
        raise AssertionError(f"[10d] {trails_m} trails, host_trail_paths "
                             f"{want_trails}")
    for name in MESH_KERNELS:
        if l10d[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"mesh MATCH path")
    mesh["10d"] = {"trails": trails_m, "hop_edges": st_m.hop_edges,
                   "exchange_bytes": st_m.exchange_bytes, "p50_s": p50_10d,
                   "local_p50_s": match["9a"]["p50_s"],
                   "launches": {k: v for k, v in l10d.items() if v}}
    log(f"[10d] {json.dumps(mesh['10d'])}")
    del frames_m, rt9m

    # 10e. eight concurrent GO 3 STEPS WHERE w > 50 on 10a's mesh
    stamp("phase 10e")
    add_company()
    mesh["10e"], _ = run_batch(
        "10e", go_call(rt8, ns.store, 3, ns.w_filter, ns.yields),
        [ns.seeds[2 * i:2 * i + 2] for i in range(8)], 3, K)
    for qid in (-1, -2):
        live_registry().deregister(qid)

    # 10f. K15 and K16 over the slot group — all eight slots on the one
    # card, one launch of each kernel — against their plain versions at
    # 10a's hop-2 shapes: every slot's (1, 8, vmax) marks of hop 2 in the
    # group's (8, 1, 8, vmax) matrix, their words, what each slot receives
    # (a view of the words, no copy), and the hub bits of the frontier
    # entering hop 2
    stamp("phase 10f")
    P, vmax = MESH_SLOTS, dev8.vmax
    W = -(-vmax // 32)
    _blk, _ids, bufs_l, dsts_l = hop_inputs(ldev)
    dev0 = mesh8.devices[0]

    def group_buf():
        return torch.zeros((P, 1, 1, vmax + H), dtype=torch.bool,
                           device=dev0)

    marks_g = new_group_marks([group_buf()], P, vmax)[0]
    for p in range(P):
        K.mark_plain(dsts_l[1][p:p + 1][None], P, vmax, out=marks_g[p])
    words = K.pack_bits_plain(marks_g)
    err_pack = max_abs_err([K.pack_bits(marks_g)], [words])
    recv = mesh8.transport.all_to_all(mesh8, [words])[0]
    if recv.untyped_storage().data_ptr() != \
            words.untyped_storage().data_ptr():
        raise AssertionError("[10f] the in-process transport copied the "
                             "group's words")
    got_u, want_u = group_buf(), group_buf()
    K.unpack_or(recv, vmax, got_u[:, :, 0, :vmax])
    K.unpack_or_plain(recv, vmax, want_u[:, :, 0, :vmax])
    for p in range(P):
        if not torch.equal(want_u[p, 0, 0, :vmax], bufs_l[2][p, :vmax]):
            raise AssertionError(f"[10f] slot {p}'s exchanged frontier is "
                                 f"not hop 3's")
    err_unpack = max_abs_err([got_u], [want_u])
    shifts = torch.arange(32, dtype=torch.int32, device=dev0)
    u_t = group_buf()

    def lib_pack():
        x = torch.nn.functional.pad(marks_g.to(torch.int32),
                                    (0, W * 32 - vmax))
        return (x.view(P, 1, P, W, 32) << shifts).sum(-1, dtype=torch.int32)

    def lib_unpack():
        bits = ((recv[..., None] >> shifts) & 1).amax(2)
        u_t[:, :, 0, :vmax] = bits.view(P, 1, W * 32)[..., :vmax].bool()
        return u_t

    if not torch.equal(lib_pack(), words) \
            or not torch.equal(lib_unpack(), want_u):
        raise AssertionError("[10f] a library formulation differs")
    n_set = int(marks_g.sum())
    record("pack_bits", None, None,
           cuda_ms(lambda: K.pack_bits(marks_g), reps),
           cuda_ms(lambda: K.pack_bits_plain(marks_g), reps),
           cuda_ms(lib_pack, reps), P * P * vmax + 4 * P * P * W,
           P * P * vmax, counts=launches10, err=err_pack, tag="[10f]",
           note=f" (hop 2, the group's ({P}, 1, {P}, {vmax}) marks, {n_set}"
                f" set, -> ({P}, 1, {P}, {W}) words; one launch a hop)")
    record("unpack_or", None, None,
           cuda_ms(lambda: K.unpack_or(recv, vmax, u_t[:, :, 0, :vmax]),
                   reps),
           cuda_ms(lambda: K.unpack_or_plain(recv, vmax,
                                             u_t[:, :, 0, :vmax]), reps),
           cuda_ms(lib_unpack, reps), 4 * P * P * W + P * vmax, P * P * W,
           counts=launches10, err=err_unpack, tag="[10f]",
           note=f" (hop 2, the group's ({P}, 1, {P}, {W}) received words, "
                f"a permuted view, -> {P} x {vmax} columns)")
    exchange_ms = cuda_ms(lambda: exchange_marks_lanes(
        mesh8, [marks_g], [u_t[:, :, 0, :vmax]]), reps)
    mesh["10f"] = {"groups": len(mesh8.groups), "transport_copy_bytes": 0,
                   "exchange_ms": exchange_ms,
                   "exchange_bytes": P * P * W * 4}
    log(f"[10f] the transport (in-process, one group of {P} slots on one "
        f"card): no copy within a group, each slot's received words a "
        f"permuted view of the group's {P * P * W * 4} bytes of words; one "
        f"whole exchange_marks_lanes (pack_bits, all_to_all, unpack_or): "
        f"{exchange_ms:.4f} ms")
    if H:
        sh0 = dev8.shards[0]
        fb_g = group_buf()
        fb_g[:, 0, 0, :vmax] = bufs_l[1][:, :vmax]
        owned = K.owned_hub_bits_plain(fb_g, sh0.part, sh0.hub_owner,
                                       sh0.hub_local)
        err_own = max_abs_err([K.owned_hub_bits(
            fb_g, sh0.part, sh0.hub_owner, sh0.hub_local)], [owned])
        got_f, want_f = fb_g.clone(), fb_g.clone()
        K.fill_hub_columns(got_f, owned)
        K.fill_hub_columns_plain(want_f, owned)
        for p in range(P):
            if not torch.equal(want_f[p, 0, 0], bufs_l[1][p]):
                raise AssertionError(f"[10f] slot {p}'s hub columns differ "
                                     f"from extend_hubs_plain's")
        err_fill = max_abs_err([got_f], [want_f])
        fb_t = fb_g.clone()
        own_l, loc_l = sh0.hub_owner.long(), sh0.hub_local.long()

        def lib_owned():
            # every hub's owner is a slot of the one group
            return fb_g[own_l, :, 0, loc_l].T.to(torch.int32)

        def lib_fill():
            fb_t[..., 0, vmax:] = owned > 0
            return fb_t

        if not torch.equal(lib_owned(), owned):
            raise AssertionError("[10f] the owned-bits gather differs")
        record("owned_hub_bits", None, None,
               cuda_ms(lambda: K.owned_hub_bits(fb_g, sh0.part, sh0.hub_owner,
                                                sh0.hub_local), reps),
               cuda_ms(lambda: K.owned_hub_bits_plain(
                   fb_g, sh0.part, sh0.hub_owner, sh0.hub_local), reps),
               cuda_ms(lib_owned, reps), 8 * H + H + 4 * H, H,
               counts=launches10, err=err_own, tag="[10f]",
               note=f" (hop 2, {H} hubs over the group's {P} slots)")
        record("fill_hub_columns", None, None,
               cuda_ms(lambda: K.fill_hub_columns(fb_t, owned), reps),
               cuda_ms(lambda: K.fill_hub_columns_plain(fb_t, owned), reps),
               cuda_ms(lib_fill, reps), 4 * H + P * H, P * H,
               counts=launches10, err=err_fill, tag="[10f]",
               note=f" (hop 2, {H} hub columns of each of {P} slots)")
        hub_ms = cuda_ms(lambda: extend_fbm_sharded_lanes(
            mesh8, dev8.shards, [fb_t]), reps)
        mesh["10f"]["hub_extension_ms"] = hub_ms
        log(f"[10f] one whole extend_fbm_sharded_lanes (owned_hub_bits, "
            f"the sum, fill_hub_columns) over {P} slots and {H} hubs: "
            f"{hub_ms:.4f} ms")
    # back to back, the rows above time the wrappers' host work as much as
    # the kernels; a span around each call with no host gap in it times
    # the device alone
    dev_ms = {"pack_bits": cuda_ms_fresh(lambda: K.pack_bits(marks_g), noop,
                                         reps),
              "unpack_or": cuda_ms_fresh(lambda: K.unpack_or(
                  recv, vmax, u_t[:, :, 0, :vmax]), noop, reps)}
    if H:
        dev_ms["owned_hub_bits"] = cuda_ms_fresh(lambda: K.owned_hub_bits(
            fb_g, sh0.part, sh0.hub_owner, sh0.hub_local), noop, reps)
        dev_ms["fill_hub_columns"] = cuda_ms_fresh(
            lambda: K.fill_hub_columns(fb_t, owned), noop, reps)
    mesh["10f"]["device_ms"] = dev_ms
    log(f"[10f] the group kernels' device time a launch (a span around each "
        f"call, no host gap in it): {json.dumps(dev_ms)}")
    # the hop kernels at a slot's shapes (one part's CSR row, parts = 8,
    # pid = p), for every slot: expand and mark into the slot's (1, 8,
    # vmax) mark matrix at hop 2, expand, predicate_mask and
    # compact_capture at the filtered hop 3, each against its plain
    # version, the expansion against row p of the local one; each timed
    # at the slot with the most edges
    sd8 = ns.store.space("ns")
    prog8 = rt8._compile_filter(dev8, sd8, [("KNOWS", "out")], ns.w_filter)
    blk8 = ldev.blocks[("KNOWS", "out")]
    mcount = {k + " (mesh)": v for k, v in launches10.items()}
    err8 = dict.fromkeys(("expand", "mark", "predicate_mask",
                          "compact_capture"), 0.0)
    big = {}
    for hop in (1, 2):
        loc = K.expand_plain(blk8.indptr, blk8.nbr, blk8.rank, bufs_l[hop],
                             ldev.hub_dense)
        for sh in dev8.shards:
            b8, q = sh.blocks[("KNOWS", "out")], sh.part
            a8 = (b8.indptr, b8.nbr, b8.rank, bufs_l[hop][q:q + 1][None],
                  sh.hub_dense)
            want = K.expand_plain(*a8, parts=P, pid=q)
            err8["expand"] = max(err8["expand"], max_abs_err(
                K.expand(*a8, parts=P, pid=q), want))
            eb = want[0].shape[-1]
            if int(want[4]) != int(loc[4][q]) or not all(
                    torch.equal(w[0, 0], lc[q, :eb])
                    for w, lc in zip(want[:4], loc[:4])):
                raise AssertionError(f"[10f] slot {q}'s hop {hop + 1} "
                                     f"slots are not row {q} of the "
                                     f"local expansion")
            if hop == 1:
                got_m, want_m = (
                    fn(want[1], P, vmax, out=torch.zeros(
                        (1, P, vmax), dtype=torch.bool, device=dev0))
                    for fn in (K.mark, K.mark_plain))
                err8["mark"] = max(err8["mark"],
                                   max_abs_err([got_m], [want_m]))
                if not torch.equal(want_m, marks_g[q]):
                    raise AssertionError(f"[10f] slot {q}'s hop-2 mark "
                                         f"matrix is not its marks")
                extra8 = ()
            else:
                pa8 = (prog8, *want[:4], want[4], [b8.props["w"]])
                keep8 = K.predicate_mask_plain(*pa8)
                err8["predicate_mask"] = max(err8["predicate_mask"],
                                             max_abs_err(
                    [K.predicate_mask(*pa8)], [keep8]))
                ca8 = (*want[:4], keep8, [b8.props["w"]])
                cg = K.compact_capture(*ca8, extent=want[4])
                cw = K.compact_capture_plain(*ca8, extent=want[4])
                err8["compact_capture"] = max(err8["compact_capture"],
                                              max_abs_err(
                    [*cg[:4], *cg[4], cg[5]], [*cw[:4], *cw[4], cw[5]]))
                extra8 = (pa8, ca8, int(keep8.sum()))
            if hop not in big or int(want[4]) > big[hop][0]:
                big[hop] = (int(want[4]), q, a8, b8, want, extra8)
        del loc

    def mrec8(name, ms, plain_ms, lib_ms, nbytes, ops, note):
        record(name + " (mesh)", None, None, ms, plain_ms, lib_ms, nbytes,
               ops, counts=mcount, err=err8[name], tag="[10f]",
               note=f" (every slot; timed at {note})")

    tot, q, a8, b8, sl8, _ = big[1]
    rows8, eb8 = a8[3].shape[-1], sl8[0].shape[-1]
    mrec8("expand",
          cuda_ms(lambda: K.expand(*a8, parts=P, pid=q), reps),
          cuda_ms(lambda: K.expand_plain(*a8, parts=P, pid=q), reps),
          cuda_ms(lib_expand_for(b8, a8[3]), reps),
          expand_bytes(1, rows8, H, tot, eb8), rows8 * 3 + tot,
          f"hop 2, slot {q}: {rows8} rows, {tot} edges")
    d8 = sl8[1]
    one8 = torch.ones((), dtype=torch.bool, device=dev0)

    def lib_mark8():
        out = torch.zeros((1, P, vmax), dtype=torch.bool, device=dev0)
        dl8 = d8.view(-1).long()
        dl8 = dl8[dl8 >= 0]
        return out.index_put_((torch.zeros_like(dl8), dl8 % P, dl8 // P),
                              one8)

    def mark8(fn):
        return lambda: fn(d8, P, vmax, out=torch.zeros(
            (1, P, vmax), dtype=torch.bool, device=dev0))

    mrec8("mark", cuda_ms(mark8(K.mark), reps),
          cuda_ms(mark8(K.mark_plain), reps), cuda_ms(lib_mark8, reps),
          4 * d8.numel() + P * vmax, 3 * d8.numel(),
          f"hop 2, slot {q}: {d8.numel()} ids into (1, {P}, {vmax}), with "
          f"the zero fill")
    mark_paths(K, "[10f]", f"slot {q}, {d8.numel()} ids",
               lambda p: K.mark(d8, P, vmax, out=torch.zeros(
                   (1, P, vmax), dtype=torch.bool, device=dev0), path=p),
               mark8(K.mark_plain)(), K.mark_path(d8.numel(), P, vmax),
               reps)
    tot, q, a8, b8, sl8, (pa8, ca8, kept8) = big[2]
    eb8 = sl8[0].shape[-1]
    mrec8("predicate_mask",
          cuda_ms(lambda: K.predicate_mask(*pa8), reps),
          cuda_ms(lambda: K.predicate_mask_plain(*pa8), reps), None,
          12 * tot + eb8 + 4, tot * len(prog8.code),
          f"hop 3, slot {q}: {eb8} slots, {tot} valid, {kept8} kept")
    predicate_paths(K, "[10f]", f"w > 50 at hop 3, slot {q}, {eb8} slots",
                    pa8, K.predicate_mask_plain(*pa8), reps)

    def lib_compact8(a=ca8):
        si = a[4][0, 0].nonzero().view(-1)
        outs = [t[0, 0].index_select(0, si) for t in a[:4]]
        outs.append(a[5][0][0, a[3][0, 0, si].long()])
        return outs

    mrec8("compact_capture",
          cuda_ms(lambda: K.compact_capture(*ca8, extent=sl8[4]), reps),
          cuda_ms(lambda: K.compact_capture_plain(*ca8, extent=sl8[4]),
                  reps),
          cuda_ms(lib_compact8, reps),
          compact_bytes(eb8, tot, kept8, 1, 1), 2 * tot,
          f"hop 3, slot {q}: {eb8} slots, {tot} valid, {kept8} kept, the "
          f"w yield column")
    del big, sl8, pa8, ca8

    # K17's bound at 10a's filtered query: every slot's kernels' byte
    # bounds (the formulas of phases 4 and 9d, one slot at a time: a slot
    # is one part's row of the local layout) summed over the hops, with
    # the two exchanges' pack and unpack
    k17 = {}

    def add17(name, nbytes, ops):
        k17[name] = k17.get(name, 0.0) + bound(nbytes, ops)[0]

    for hop, f in enumerate(bufs_l):
        sl = K.expand_plain(blk8.indptr, blk8.nbr, blk8.rank, f,
                            ldev.hub_dense)
        tots = [int(t) for t in sl[4].tolist()]
        kept = (K.predicate_mask_plain(prog8, *sl[:4], sl[4],
                                       [blk8.props["w"]]).sum(1).tolist()
                if hop == 2 else None)
        if H:
            # one launch each a hop over the group of eight
            add17("owned_hub_bits", 13 * H, H)
            add17("fill_hub_columns", 4 * H + P * H, P * H)
        for p, tot in enumerate(tots):
            add17("expand", expand_bytes(1, f.shape[-1], H, tot, tot),
                  f.shape[-1] * 3 + tot)
            if hop < 2:
                add17("mark", 4 * tot + P * vmax, 3 * tot)
                add17("pack_bits", P * vmax + 4 * P * W, P * vmax)
                add17("unpack_or", 4 * P * W + vmax, P * W)
            else:
                add17("predicate_mask", 13 * tot + 4,
                      tot * len(prog8.code))
                add17("compact_capture",
                      compact_bytes(tot, tot, int(kept[p]), 1, 1), 2 * tot)
        del sl
    mesh["k17"] = {"device_loop_ms": mesh["10a"][f"w>{ns.w_gt}"][
        "device_p50_ms"], "local_device_loop_ms": results[mlabel][
        f"w>{ns.w_gt}"]["device_p50_ms"],
        "bound_ms": sum(k17.values()), "bound_parts_ms": k17,
        "launches_per_go3": {k: v / (2 * (MESH_RUNS + 1))
                             for k, v in launches10.items() if v},
        "launches_per_bfs": res8["launches_per_run"]}
    log(f"[10] K17 mesh loop: {json.dumps(mesh['k17'])}")

    # 10g. 10a's filtered GO once more through the process-group
    # transport: a one-rank NCCL group holding all eight slots; then a
    # GpuRuntime over that same mesh serves GO, MATCH's every-hop
    # frames and the BFS (its gathers across the ranks and reductions
    # run as one-rank collectives).  NCCL refuses two ranks on one
    # device, so on this one-card machine the group has one rank; two
    # ranks are held on the CPU over gloo (tests/test_torch_mesh2.py)
    stamp("phase 10g")
    torch.cuda.set_device(dev0)
    store_dir = tempfile.mkdtemp(prefix="nccl_store_")
    dist.init_process_group("nccl", init_method=f"file://{store_dir}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        pg_mesh = process_group_mesh(MESH_SLOTS, dev0)
        fl = f"w>{ns.w_gt}"
        bks = [("KNOWS", "out")]
        dense = sorted({sd8.dense_id(v) for v in ns.seeds})
        t0 = time.perf_counter()
        res_pg = run_hops_sharded(
            pg_mesh, dev8.shards, rt8._run_blocks(dev8, bks),
            seed_slot_frontiers(dev8, [dense]), 3, pred=prog8,
            yield_cols=("w",))
        caps = [rt8._fetch_cap(c, None)[0] for c in res_pg["cap"]]
        pg_s = time.perf_counter() - t0
        rows = rt8._materialize_yields(ns.store, "ns", dev8, bks, caps,
                                       ns.yields)
        if not rows_equal(rows, mesh_rows[fl]):
            raise AssertionError("[10g] the NCCL group's rows differ from "
                                 "10a's")
        pg_edges = [int(x) for x in res_pg["hop_edges"][0].sum(0).tolist()]
        if pg_edges != mesh["10a"][fl]["hop_edges"] \
                or pg_mesh.transport.sent_bytes != want_x:
            raise AssertionError(f"[10g] hop_edges {pg_edges}, "
                                 f"{pg_mesh.transport.sent_bytes} bytes "
                                 f"sent")
        mesh["10g"] = {"backend": dist.get_backend(), "world_size": 1,
                       "slots": MESH_SLOTS, "rows": len(rows),
                       "hop_edges": pg_edges,
                       "sent_bytes": pg_mesh.transport.sent_bytes,
                       "device_and_fetch_s": pg_s}
        log(f"[10g] {json.dumps(mesh['10g'])}")
        mesh["10g"]["runtime"] = pg_runtime(
            K, pg_mesh, rt8, ns, mesh_rows[fl], mesh["10a"][fl],
            bfs_depths)
        log(f"[10g] GpuRuntime over the group: "
            f"{json.dumps(mesh['10g']['runtime'])} | {card}")
    finally:
        dist.destroy_process_group()
    del mesh_rows, rows, caps, res_pg

    # 10h. the two-axis grid on the one card
    mesh["10h"] = grid_phase(K, ns, rts if rts is not None else rt,
                             bfs_depths, card)

    # -- 11. temporal and geography props ----------------------------------
    # 11a. the north star's recipe at TEMPORAL_PERSONS with DATE,
    # DATETIME, TIME and GEOGRAPHY columns, pinned as the main path lays
    # it out (split at --split)
    stamp("phase 11a")
    t11 = time.perf_counter()
    temporal = {"persons": min(args.persons, TEMPORAL_PERSONS)}
    ns11 = north_star(temporal["persons"], split_threshold=args.split)
    temporal["graph_s"] = time.perf_counter() - t11
    t0 = time.perf_counter()
    tsnap = temporal_snapshot(ns11.snap)
    temporal["columns_s"] = time.perf_counter() - t0
    ttypes = tsnap.block("KNOWS", "out").prop_types
    tstore = SnapshotStore(tsnap)
    trt = GpuRuntime(degree_split_threshold=ns11.split_threshold)
    t0 = time.perf_counter()
    trt.pin_prebuilt(tsnap)
    torch.cuda.synchronize()
    temporal["pin_s"] = time.perf_counter() - t0
    temporal["pinned_bytes"] = trt.hbm_bytes()
    temporal["device_free_bytes"] = torch.cuda.mem_get_info()[0]
    tdev = trt.snapshots["ns"]
    tlabel = "split" if tdev.num_hubs else "unsplit"
    tyields = [(E.EdgeProp("KNOWS", n), n) for n in TEMPORAL_YIELDS]
    twhere = E.Binary("<", E.EdgeProp("KNOWS", "d"),
                      E.EdgeProp("KNOWS", "d2"))
    deg = np.diff(tsnap.block("KNOWS", "out").indptr, axis=1).T.reshape(-1)
    seeds64 = np.flatnonzero(deg[:len(tsnap.dense_to_vid)] > 0
                             )[-TEMPORAL_SEEDS:].tolist()
    log(f"[11a] {json.dumps(temporal)}; {tlabel}, {tdev.num_hubs} hubs; "
        f"GO 1 STEP and MATCH seeds: the last {len(seeds64)} persons with "
        f"out-edges")

    # 11b. GO 3 STEPS from the north-star seeds YIELD d, t, tm, g WHERE
    # KNOWS.d < KNOWS.d2 (the predicate program on two DATE columns), GO
    # 1 STEP with the yields and with Edge rows, traverse_hops over 2 hops
    stamp("phase 11b")
    K.reset_launch_counts()
    (rows11, st11), lat = timed(lambda: trt.traverse(
        tstore, "ns", ns11.seeds, ["KNOWS"], "out", 3, edge_filter=twhere,
        yields=tyields), TEMPORAL_RUNS)
    torch.cuda.synchronize()
    launches11 = counts(K)
    for name in (SPLIT_KERNELS if tdev.num_hubs else UNSPLIT_KERNELS):
        if launches11[name] <= 0:
            raise AssertionError(f"[11b] kernel {name} never launched")
    total, want_w, _ = final_words(tsnap, ns11.seeds, 3, TEMPORAL_YIELDS,
                                   where=True)
    # the unfiltered GO's hop_edges and rows, by the numpy walk
    walked = [host_final_hop(tsnap, ns11.seeds, k)[0] for k in (1, 2, 3)]
    hops = [b - a for a, b in zip([0] + walked, walked)]
    go3 = {"hop_edges": hops, "rows": hops[-1]}
    if st11.edges_traversed() != total or st11.hop_edges != go3["hop_edges"]:
        raise AssertionError(f"[11b] edges {st11.edges_traversed()} vs "
                             f"{total}, hop_edges {st11.hop_edges}")
    secs = check_decoded("11b GO 3 STEPS", rows11, want_w, ttypes,
                         tsnap.pool)
    per = {n: sec / max(len(rows11), 1) for n, sec in secs.items()}
    decode = {n: {"s": secs[n], "us_per_value": per[n] * 1e6,
                  "projected_s_at_unfiltered_rows": per[n] * go3["rows"]}
              for n in secs}
    temporal["go3_where_d_lt_d2"] = {
        "rows": len(rows11), "final_hop_edges": go3["rows"],
        "hop_edges": st11.hop_edges, "p50_ms": float(np.median(lat)) * 1e3,
        "runs_ms": [x * 1e3 for x in lat], "device_ms": st11.device_s * 1e3,
        "fetch_ms": st11.fetch_s * 1e3, "mat_ms": st11.mat_s * 1e3,
        "host_decode": decode,
        "launches": {k: v for k, v in launches11.items() if v}}
    log(f"[11b] GO 3 STEPS WHERE d < d2 YIELD d, t, tm, g: "
        f"{json.dumps(temporal['go3_where_d_lt_d2'])} | {card}")
    del rows11
    (rows1, st1), lat = timed(lambda: trt.traverse(
        tstore, "ns", seeds64, ["KNOWS"], "out", 1, yields=tyields),
        TEMPORAL_RUNS)
    total1, want1, _ = final_words(tsnap, seeds64, 1, TEMPORAL_YIELDS,
                                   where=False)
    if st1.edges_traversed() != total1:
        raise AssertionError("[11b] GO 1 STEP edges differ")
    check_decoded("11b GO 1 STEP", rows1, want1, ttypes, tsnap.pool)
    (erows, _), elat = timed(lambda: trt.traverse(
        tstore, "ns", seeds64, ["KNOWS"], "out", 1), TEMPORAL_RUNS)
    tblk, P11 = tsnap.block("KNOWS", "out"), tsnap.num_parts
    if len(erows) != total1 or not all(
            edge_props_ok(tblk, P11, tsnap.pool, r[1]) for r in erows):
        raise AssertionError("[11b] Edge rows differ from the oracle")
    (frames11, fst), flat = timed(lambda: trt.traverse_hops(
        tstore, "ns", seeds64, ["KNOWS"], "out", 2), TEMPORAL_RUNS)
    check_frames("11b", frames11, host_hop_edges(tsnap, seeds64, 2))
    rng11 = np.random.default_rng(5)
    for f in frames11:
        idx = rng11.choice(f.n, min(f.n, TEMPORAL_SAMPLE), replace=False)
        if not all(edge_props_ok(tblk, P11, tsnap.pool, e)
                   for e in f.decode(np.sort(idx))):
            raise AssertionError("[11b] a frame's Edge differs from the "
                                 "oracle")
    temporal["go1"] = {"rows": len(rows1), "p50_ms": float(np.median(lat))
                       * 1e3, "mat_ms": st1.mat_s * 1e3}
    temporal["go1_edge_rows"] = {"rows": len(erows),
                                 "p50_ms": float(np.median(elat)) * 1e3}
    temporal["match_2_hops"] = {"frame_edges": [f.n for f in frames11],
                                "p50_ms": float(np.median(flat)) * 1e3,
                                "decoded_a_hop": TEMPORAL_SAMPLE}
    log(f"[11b] GO 1 STEP YIELD d, t, tm, g: {json.dumps(temporal['go1'])};"
        f" Edge rows: {json.dumps(temporal['go1_edge_rows'])}; "
        f"traverse_hops 2: {json.dumps(temporal['match_2_hops'])} | {card}")
    del rows1, erows, frames11

    # the predicate program on the temporal columns against its plain
    # version at the filtered hop 3's slots
    tprog, _ = X.compile_predicate(twhere, dict(ttypes), tdev.pool,
                                   device=rt.device)
    tblk_d = tdev.blocks[("KNOWS", "out")]
    _, _, tbufs, _ = hop_inputs(tdev, ns11.seeds)
    tsl = K.expand_plain(tblk_d.indptr, tblk_d.nbr, tblk_d.rank, tbufs[2],
                         tdev.hub_dense)
    tpa = (tprog, *tsl, [tblk_d.props[n] for n in tprog.columns])
    tot_t = int(tsl[4].sum())

    def d_lt_d2_torch():
        e = tsl[3].long()
        d, d2 = (tblk_d.props[n].gather(-1, e) for n in ("d", "d2"))
        return (torch.arange(e.shape[-1], device=e.device)
                < tsl[4][..., None]) & (d != INT_NULL) & (d2 != INT_NULL) \
            & (d < d2)

    want_t = K.predicate_mask_plain(*tpa)
    if not torch.equal(d_lt_d2_torch(), want_t):
        raise AssertionError("[11b] d < d2 in torch differs")
    record("predicate_mask (temporal)", [K.predicate_mask(*tpa)], [want_t],
           cuda_ms(lambda: K.predicate_mask(*tpa), reps),
           cuda_ms(lambda: K.predicate_mask_plain(*tpa), reps),
           cuda_ms(d_lt_d2_torch, reps),
           tot_t * (4 + 2 * 8) + tsl[0].numel() + 4 * P11,
           tot_t * len(tprog.code), tag="[11b]",
           counts={"predicate_mask (temporal)":
                   launches11["predicate_mask"]},
           note=f" (d < d2 at {tlabel} hop 3, {len(tprog.code)} "
                f"instructions, {tot_t} valid slots)")
    del tsl, tpa, tbufs, want_t
    trt.unpin("ns")

    # 11c. 1,000 inserts from the seeds carrying every column's type
    # through the delta plane; GO 3 STEPS then equals a fresh pin's
    stamp("phase 11c")
    wstore = SnapshotStore(tsnap, ns11.arrs, extra=ttypes)
    wstore.delta_watch("ns")
    trd = GpuRuntime(delta_max_edges=DELTA_CAP)
    trd.pin_prebuilt(tsnap)
    pool0 = list(tsnap.pool.strings)
    ins = temporal_inserts(wstore, ns11.arrs, ns11.seeds, tsnap.pool,
                           TEMPORAL_INSERTS)
    for a, b, props in ins:
        wstore.insert_edge(a, b, props)
    t0 = time.perf_counter()
    if trd.pin(wstore, "ns") is not trd.snapshots["ns"] \
            or trd.snapshots["ns"].delta.applied_epoch \
            != wstore.space("ns").epoch:
        raise AssertionError("[11c] the writes were not applied in place")
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    K.reset_launch_counts()
    (rows_d, st_d), dlat = timed(lambda: trd.traverse(
        wstore, "ns", ns11.seeds, ["KNOWS"], "out", 3, edge_filter=twhere,
        yields=tyields), TEMPORAL_RUNS)
    torch.cuda.synchronize()
    launches11c = counts(K)
    for name in DELTA_GO_KERNELS:
        if launches11c[name] <= 0:
            raise AssertionError(f"[11c] kernel {name} never launched")
    t0 = time.perf_counter()
    fsnap = spliced_snapshot(tsnap, pool0, ins)
    splice_s = time.perf_counter() - t0
    trd.unpin("ns")
    trf = GpuRuntime()
    trf.pin_prebuilt(fsnap)
    rows_f, st_f = trf.traverse(SnapshotStore(fsnap), "ns", ns11.seeds,
                                ["KNOWS"], "out", 3, edge_filter=twhere,
                                yields=tyields)
    if not rows_equal(rows_d, rows_f) or st_d.hop_edges != st_f.hop_edges:
        raise AssertionError(f"[11c] {len(rows_d)} rows through the plane "
                             f"vs {len(rows_f)} from a fresh pin")
    total_f, want_f, _ = final_words(fsnap, ns11.seeds, 3, TEMPORAL_YIELDS,
                                     where=True)
    if st_f.edges_traversed() != total_f:
        raise AssertionError("[11c] the fresh pin's edges differ")
    check_decoded("11c fresh pin", rows_f, want_f, ttypes, fsnap.pool)
    trf.unpin("ns")
    temporal["writes"] = {
        "inserts": len(ins), "apply_s": apply_s, "splice_s": splice_s,
        "pool_before": len(pool0), "pool_after": len(tsnap.pool),
        "rows": len(rows_d), "hop_edges": st_d.hop_edges,
        "p50_ms": float(np.median(dlat)) * 1e3,
        "launches": {k: v for k, v in launches11c.items() if v}}
    temporal["phase_s"] = time.perf_counter() - t11
    log(f"[11c] GO 3 STEPS WHERE d < d2 through {len(ins)} inserts: "
        f"{json.dumps(temporal['writes'])} | {card}")
    log(f"[11] phase 11 took {temporal['phase_s']:.1f} s")
    del rows_d, rows_f, fsnap, tsnap, wstore, tstore, ns11

    # -- 12. the store path ---------------------------------------------
    store12, st12 = store_phase(K, card, args.repeats, args.seed, ns)

    # -- 13. nGQL through the port's QueryEngine ---------------------------
    engine13, launches13 = engine_phase(K, card, st12, args.seed)

    # -- 14. MATCH, the paths and the algorithms through the engine ------
    match14, launches14 = match_phase(K, card, st12, args.seed)
    del st12

    # -- 15. LDBC IC5 and IC9 through the MATCH pipeline ------------------
    pipe15, launches15 = pipeline_phase(K, card, args.ic_persons, args.seed)

    # -- 16. the cluster plane: nGQL to a LocalCluster's graphd ------------
    cluster16, launches16 = cluster_phase(K, card, args.seed)
    # the kernels line counts the engine paths' launches too
    for row in rows_out:
        name = HUB_ROUTE if row["name"] == \
            "extend_hubs (fused into expand)" else row["name"]
        row["launches"] += launches13.get(name, 0) \
            + launches14.get(name, 0) + launches15.get(name, 0) \
            + launches16.get(name, 0)

    # -- 17. result --------------------------------------------------------
    stamp("phase 17")
    log(json.dumps({"go3": results, "expand_per_hop": per_hop,
                    "unsplit_launches": launches_u,
                    "unsplit_kernels": extra, "algo": algo, "bfs": bfs,
                    "bfs_launches": bfs_launches, "delta": delta,
                    "delta_launches": launches_d, "batch": batch,
                    "match": match, "mesh": mesh, "temporal": temporal,
                    "store": store12, "engine": engine13,
                    "engine_match": match14, "pipeline": pipe15,
                    "cluster": cluster16,
                    "hbm_bytes": rt.hbm_bytes() + (
                        rts.hbm_bytes() if rts is not None else 0)}))
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
