// mark — scatter kept destination ids into the (P, vmax) frontier bitmap
// (Queue B K2, and K6 for the seed bitmap).
//
// Replaces nebula_tpu/tpu/hop.py:_mark (:168) with the OR over blocks and
// source parts in _build_local_fn (:580), and the seed-bitmap `build` in
// nebula_tpu/tpu/runtime.py:_seed_builder (:969).  Dense id d lives at
// row d % P, column d / P: the one scatter does dedup (duplicates set the
// same byte) and routing (the row is the owning part).  Every block of
// every hop writes into the one next-frontier tensor, which is the OR.
//
// The bitmap's rows are `ld` bytes apart: ld = vmax for a plain (P, vmax)
// bitmap, vmax + H when it is the first vmax columns of a degree-split
// snapshot's (P, vmax + H) frontier buffer (see gpu/hop.py:new_frontier),
// so a row need not start on any alignment.
//
// Query lanes (Queue B K10, nebula_tpu/tpu/hop.py:619; the lanes seed
// builder, nebula_tpu/tpu/runtime.py:976): `out` may be an (L, P, vmax)
// stack of bitmaps whose rows are all `ld` bytes apart (lane l's rows
// follow lane l - 1's), and the ids come lane-major, `per_lane` of them
// a lane: lane l's ids land in rows l * P + d % P.  One launch marks
// every lane: a hop's (L, P, W) dst slots, or the (L, cap) seed ids.  A
// solo call passes per_lane = n.
//
// Only ones are ever stored, so duplicate writers agree and no atomics
// on `out` are needed; a slot that is not kept, or whose id lies outside
// [0, P*vmax), writes nothing (the reference's scatter dropped
// out-of-range ids; a scatter of `keep` values would let a False
// overwrite a True).  With no keep mask, a slot is kept when its id is
// >= 0: expand pads invalid slots with -1, and the seed list is exactly
// the ids to set.
//
// Bound: bytes — 4 bytes of id (and 1 of keep) read per slot, and the
// bitmap written once.  A scatter of one byte store a slot stays far
// above it: at a GO's hop 2, 12.45M stores land on 1M distinct bytes,
// each warp store 32 sector requests onto the few thousand lines of a 1 MB
// bitmap.  So two kernels, chosen by the wrapper by shape
// (gpu/kernels.py:mark_path), both bit for bit the plain version:
//
//  * staged — where a lane's P x vmax bitmap fits a block's shared
//    memory as bits (P * ceil(vmax / 32) words; 1M columns = 125 KB at
//    every main-path shape).  A grid of (chunks, lanes) blocks, the
//    chunks of a lane in clusters of up to 8, one wave of clusters.  Each
//    block zeroes its bit copy, reads its chunk of ids (and keep) once as
//    16-byte vectors (scalars at a misaligned head and tail) and sets a
//    bit per kept id with a shared-memory atomicOr (d % P and d / P from
//    a multiplier fixed for the launch).  The cluster then ORs its copies
//    through distributed shared memory, each block taking one slice of
//    the words, and each block flushes its slice into `out` in address
//    order: a warp reads 32 words, and for each word with a bit set lane
//    j stores column 32w + j if its bit is set — one sector a store
//    instruction, ones only, the bitmap stored once a cluster.
//  * direct — the seed ids (16 at K6), a bitmap too wide to stage, fewer
//    than MARK_STAGE_MIN_IDS ids a lane.  The same vector loads and
//    division, one thread a slot, and test-before-set: the byte is read
//    and stored only if it reads 0 (a stale 0 costs a redundant store of
//    1, so it stays exact).
//
// Measured on an H100 (chip_smoke.py's `mark paths` lines time both at
// [4], [8d], [9d] and [10f]; PERF.md): with one flush a block the staged
// kernel lost to the direct one at three of those four shapes, since
// each block stored the whole bitmap; flushing once a cluster it wins at
// all four, so the main path's marks go staged and the seed build
// direct.  Where between 16 ids and a hop's millions the two cross is
// not measured: MARK_STAGE_MIN_IDS is a guess.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastdiv.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStageThreads = 1024;
constexpr int kDirectThreads = 256;
constexpr long long kStageMinChunk = 16384;   // ids a staged block takes
constexpr long long kDirectChunk = 4096;      // ids a direct block takes
constexpr int kCluster = 8;                   // staged blocks sharing a flush

// Call fn(d) for each kept id of ids[beg, end) (keep may be null),
// threads striped over 16-byte vectors of ids with scalars at the ends.
template <typename Fn>
__device__ __forceinline__ void for_each_kept(const int* __restrict__ ids,
                                              const uint8_t* __restrict__ keep,
                                              long long beg, long long end,
                                              Fn fn) {
  if (beg >= end) return;
  const int* p = ids + beg;
  const long long cnt = end - beg;
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15) >> 2;
  if (head > cnt) head = cnt;
  const long long nvec = (cnt - head) >> 2;
  const long long tail0 = head + (nvec << 2);
  const uint8_t* k = keep == nullptr ? nullptr : keep + beg;
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    if (k == nullptr || k[i]) fn(p[i]);
  for (long long i = tail0 + threadIdx.x; i < cnt; i += blockDim.x)
    if (k == nullptr || k[i]) fn(p[i]);
  const int4* pv = reinterpret_cast<const int4*>(p + head);
  const bool kvec = k != nullptr && (((uintptr_t)(k + head)) & 3) == 0;
#pragma unroll 4
  for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int4 q = pv[v];
    unsigned kb = 0x01010101u;
    if (k != nullptr) {
      const uint8_t* kk = k + head + (v << 2);
      kb = kvec ? *reinterpret_cast<const unsigned*>(kk)
                : (unsigned)kk[0] | (unsigned)kk[1] << 8
                  | (unsigned)kk[2] << 16 | (unsigned)kk[3] << 24;
    }
    if (kb & 0xffu) fn(q.x);
    if (kb & 0xff00u) fn(q.y);
    if (kb & 0xff0000u) fn(q.z);
    if (kb & 0xff000000u) fn(q.w);
  }
}

// The block's range of its lane's ids: chunk `c` of `chunk` ids.
__device__ __forceinline__ void block_range(long long per_lane,
                                            long long chunk, long long* beg,
                                            long long* end) {
  *beg = (long long)blockIdx.x * chunk;
  *end = *beg + chunk < per_lane ? *beg + chunk : per_lane;
}

// The staged kernel.  Blocks of one lane run in clusters of C; each
// block stages its chunk's bits, then the cluster ORs its C copies word
// by word (block c of the cluster takes the c-th slice of the words,
// reading the other blocks' copies through distributed shared memory)
// and each block flushes its slice: the bitmap is stored once a cluster,
// not once a block.
__global__ void __launch_bounds__(kStageThreads)
mark_staged_kernel(const int* __restrict__ ids,
                   const uint8_t* __restrict__ keep, long long per_lane,
                   long long chunk, FastDiv byP, FastDiv byW, unsigned lim,
                   long long ld, uint8_t* __restrict__ out) {
  extern __shared__ uint4 stage_mem[];
  uint32_t* bits = reinterpret_cast<uint32_t*>(stage_mem);
  const unsigned W = byW.d;
  const int nwords = (int)(byP.d * W);
  const int nvec = (nwords + 3) >> 2;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    stage_mem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const long long lane = blockIdx.y;
  long long beg, end;
  block_range(per_lane, chunk, &beg, &end);
  for_each_kept(ids + lane * per_lane,
                keep == nullptr ? nullptr : keep + lane * per_lane, beg, end,
                [&](int d) {
                  const unsigned u = (unsigned)d;
                  if (u >= lim) return;
                  const unsigned c = div_of(u, byP);
                  const unsigned r = u - c * byP.d;
                  atomicOr(&bits[r * W + (c >> 5)], 1u << (c & 31));
                });
  // the cluster's OR, into this block's slice of 16-byte vectors
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), me = cluster.block_rank();
  cluster.sync();                       // every copy is complete
  const int seg = (int)((nvec + C - 1) / C);
  const int v0 = (int)me * seg;
  const int v1 = v0 + seg < nvec ? v0 + seg : nvec;
  for (unsigned q = 1; q < C; ++q) {
    const uint4* other = cluster.map_shared_rank(stage_mem, (me + q) % C);
    for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
      const uint4 x = other[v];
      uint4 m = stage_mem[v];
      m.x |= x.x;
      m.y |= x.y;
      m.z |= x.z;
      m.w |= x.w;
      stage_mem[v] = m;
    }
  }
  cluster.sync();                       // no copy is read after this
  // the flush of the slice: warps over 32-word groups in address order;
  // lane t finds its word's row offset, then for each word with a bit
  // set one store instruction, lane j on column 32w + j
  const int j = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int w0 = v0 * 4, w1 = v1 * 4 < nwords ? v1 * 4 : nwords;
  uint8_t* o = out + lane * (long long)byP.d * ld;
  for (int base = w0 + ((threadIdx.x >> 5) << 5); base < w1;
       base += nwarps << 5) {
    const int w = base + j;
    const uint32_t mine = w < w1 ? bits[w] : 0u;
    long long off = 0;
    if (mine != 0u) {
      const unsigned r = div_of((unsigned)w, byW);
      off = (long long)r * ld + (long long)((unsigned)w - r * W) * 32;
    }
    uint32_t nz = __ballot_sync(0xffffffffu, mine != 0u);
    while (nz) {
      const int t = __ffs(nz) - 1;
      nz &= nz - 1;
      const uint32_t word = __shfl_sync(0xffffffffu, mine, t);
      const long long at = __shfl_sync(0xffffffffu, off, t);
      if ((word >> j) & 1u) o[at + j] = 1;
    }
  }
}

__global__ void __launch_bounds__(kDirectThreads)
mark_direct_kernel(const int* __restrict__ ids,
                   const uint8_t* __restrict__ keep, long long per_lane,
                   long long chunk, FastDiv byP, unsigned lim, long long ld,
                   uint8_t* out) {
  const long long lane = blockIdx.y;
  long long beg, end;
  block_range(per_lane, chunk, &beg, &end);
  uint8_t* o = out + lane * (long long)byP.d * ld;
  for_each_kept(ids + lane * per_lane,
                keep == nullptr ? nullptr : keep + lane * per_lane, beg, end,
                [&](int d) {
                  const unsigned u = (unsigned)d;
                  if (u >= lim) return;
                  const unsigned c = div_of(u, byP);
                  const unsigned r = u - c * byP.d;
                  uint8_t* a = o + (long long)r * ld + c;
                  if (*a == 0) *a = 1;
                });
}

// A card's opt-in shared memory and the staged kernel's resident clusters
// at the last (bytes, cluster size) it launched with: host queries kept
// off the launch path (a stale entry changes only the grid's size).
struct StageCache {
  int optin = 0;
  long long bytes = -1;
  int C = 0, clusters = 1;
};
StageCache stage_cache[64];

// chunk of a lane's ids per block, a multiple of 4 (so that every block
// of a lane shares the lane's 16-byte alignment), from the chunk count
long long chunk_of(long long per_lane, long long nchunks) {
  return cdiv(cdiv(per_lane, nchunks), 4) * 4;
}

}  // namespace

// The shared-memory bytes the staged kernel takes for a (P, vmax)
// bitmap: P rows of ceil(vmax / 32) words, rounded up to 16 bytes.
extern "C" long long nt_mark_stage_bytes(int P, int vmax) {
  return cdiv((long long)P * cdiv(vmax, 32) * 4, 16) * 16;
}

// ids (n) int32 lane-major, per_lane a lane; keep (n) bool or null; out
// the (L, P, vmax) bitmap with row stride ld.  staged = 1 takes the
// staged kernel (the wrapper checks that it fits), 0 the direct one.
extern "C" int nt_mark(const int* ids, const uint8_t* keep, long long n,
                       int P, int vmax, long long ld, long long per_lane,
                       int staged, uint8_t* out, void* stream) {
  if (per_lane < 1 || n % per_lane != 0 || P < 1 || vmax < 0
      || (long long)P * vmax >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || vmax == 0) return (int)cudaGetLastError();
  const long long L = n / per_lane;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const unsigned lim = (unsigned)P * (unsigned)vmax;
  const FastDiv byP = make_div((unsigned)P);
  cudaStream_t s = (cudaStream_t)stream;
  if (staged) {
    const long long bytes = nt_mark_stage_bytes(P, vmax);
    int dev = 0;
    cudaGetDevice(&dev);
    StageCache& sc = stage_cache[dev & 63];
    if (sc.optin == 0) {
      int optin = 0;
      cudaDeviceGetAttribute(&optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      const cudaError_t e = cudaFuncSetAttribute(
          mark_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin);
      if (e != cudaSuccess) return (int)e;
      sc.optin = optin;
    }
    if (bytes > sc.optin) return (int)cudaErrorInvalidValue;
    // clusters of up to kCluster blocks of a lane, one wave of them
    long long nchunks = cdiv(per_lane, kStageMinChunk);
    const int C = nchunks < kCluster ? (int)nchunks : kCluster;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(kStageThreads);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (sc.bytes != bytes || sc.C != C) {
      cfg.gridDim = dim3((unsigned)C, 1u);
      int clusters = 0;
      cudaOccupancyMaxActiveClusters(&clusters, mark_staged_kernel, &cfg);
      sc.clusters = clusters > 0 ? clusters : 1;
      sc.bytes = bytes;
      sc.C = C;
    }
    long long fill = (long long)sc.clusters / L * C;
    if (fill < C) fill = C;
    if (nchunks > fill) nchunks = fill;
    nchunks = cdiv(nchunks, C) * C;      // whole clusters
    const long long chunk = chunk_of(per_lane, nchunks);
    cfg.gridDim = dim3((unsigned)nchunks, (unsigned)L);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, mark_staged_kernel, ids, keep, per_lane, chunk, byP,
        make_div((unsigned)cdiv(vmax, 32)), lim, ld, out);
    if (e != cudaSuccess) return (int)e;
  } else {
    long long nchunks = cdiv(per_lane, kDirectChunk);
    const long long fill = cdiv((long long)num_sms() * 16, L);
    if (nchunks > fill) nchunks = fill;
    const long long chunk = chunk_of(per_lane, nchunks);
    const dim3 grid((unsigned)cdiv(per_lane, chunk), (unsigned)L);
    mark_direct_kernel<<<grid, kDirectThreads, 0, s>>>(
        ids, keep, per_lane, chunk, byP, lim, ld, out);
  }
  return (int)cudaGetLastError();
}
