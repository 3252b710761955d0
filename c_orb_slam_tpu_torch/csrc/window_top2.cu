// Projection-window masked top-2 Hamming search over 256-bit ORB
// descriptors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c_orb_slam_tpu/ops/pallas_match.py
// (window_top2 / _kernel). On the TPU the distance was |a|+|b|-2a.b on the
// matrix unit over 512-wide target tiles in VMEM; here it is integer
// XOR + __popc, which is what the data is.
//
// Semantics are those of the XLA branch of match.search_by_projection
// (dense masked distance matrix + best_two + the idx2 argmin): every
// target counts, masked ones at INVALID_DIST = 512, and targets are ranked
// by the pair (distance, index), lowest first.
//   best/idx    = the first pair in that order;
//   second/idx2 = the first pair among all j != idx (512 and 0 when T == 1).
// A fully masked row gives best = second = 512, idx = 0, idx2 = 1.
//
// What bounds it on the H100: operations, not bytes. At Q = 8192 queries
// x T = 1000 targets the inputs and outputs are 0.6 MB (0.2 us of HBM),
// the window and octave test of 8.2e6 pairs is about 1.5 us of the
// integer/float pipes, and the popcounts are owed only to pairs inside
// the window, a handful per query on the tracking path. So the kernel
// lives near the time of a launch, and what matters is to fill the card
// and to spend no popcount on a pair the window rejects.
//
// Design:
// - A warp owns one query, held in registers; its lanes take interleaved
//   targets k + lane. A block of 8 warps shares one staged tile of targets
//   (2048: one tile at every shape of the main path). The grid is
//   B * ceil(Q / 8) blocks in x, 125 at the smallest call of the main
//   path, so batches of independent (queries, targets) problems (the
//   mapper's fuse pairs) are one launch.
// - Cull first: each target's gate data is packed into one 16-byte record
//   in shared memory (x, y, octave; x is NaN for an invalid target, so
//   validity costs no compare), staged with every load of a thread in
//   flight at once. The window and octave test is one vector load and six
//   operations a pair; a lane tests four targets per round, none waiting
//   on another, and most rounds end there.
// - Compact, then popcount: __ballot_sync gives the warp the set of its
//   lanes whose target is inside the query's window; those lanes append
//   the target's index to the warp's small queue in shared memory. Queued
//   targets are dealt back to the lanes, which fetch the descriptor (two
//   16-byte loads through L1, all lanes' loads in flight together: one
//   memory latency per query on the tracking path, not one per hit) and
//   XOR + __popc. A full queue is drained on the way, so a window that
//   holds every target costs full-lane popcount passes and nothing else.
// - Each lane keeps its top-2 as packed keys (distance << 23 | index), so
//   an insert and a merge are min/max, and the order is lexicographic in
//   (distance, index) whatever order the targets were visited in. A
//   __shfl_xor_sync butterfly leaves the warp's two smallest keys in
//   every lane.
// - Masked pairs are never visited; their ranks are filled in closed
//   form: with no candidate (512, 0, 512, 1); with one, the second rank is
//   512 at the lowest index other than the best (0, or 1 when the best is
//   0). A candidate's distance is at most 256, so the classes never tie.
// - The launch goes on the caller's stream, allocates nothing and never
//   synchronises, so it can be captured into a CUDA graph.
//
// The shape (a whole warp per query, one query per warp, 8 warps, a tile
// of 2048, four targets per lane per round) was the fastest of those
// measured at the tracking shapes; PERF.md has the table.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // warps per block, one query each, sharing a target tile
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;     // targets staged per tile
constexpr int kUnroll = 4;      // targets a lane tests per round of the gate loop
constexpr int kStride = 32 * kUnroll;  // targets a warp tests per round
constexpr int kQueue = 64;      // in-window targets a warp queues
constexpr int kInvalidDist = 512;
// A key is distance << kIndexBits | index: distances need 9 bits (0..256).
constexpr int kIndexBits = 23;
constexpr int kMaxTargets = 1 << kIndexBits;
constexpr uint32_t kIndexMask = (1u << kIndexBits) - 1;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;

static_assert(kTile % kStride == 0 && kTile % kThreads == 0, "tile size");
static_assert(kTile * 16 + kWarps * kQueue * 4 <= 48 * 1024, "static shared memory");

struct Query {
  uint4 a, b;     // descriptor words 0-3, 4-7
  float u, v, r;  // window centre and radius; r = -1 holds no target
  uint32_t lo, span;  // octave o is in range iff o - lo <= span, unsigned
  uint32_t k1, k2;    // this lane's two smallest keys
};

// Distance of queued target j to the query, into the lane's top-2.
__device__ __forceinline__ void take(Query& q, const int32_t* __restrict__ t_desc_batch, int j) {
  const uint4* d = reinterpret_cast<const uint4*>(t_desc_batch + (int64_t)j * 8);
  const uint4 ta = __ldg(d), tb = __ldg(d + 1);
  const uint32_t dist = __popc(q.a.x ^ ta.x) + __popc(q.a.y ^ ta.y) + __popc(q.a.z ^ ta.z) +
                        __popc(q.a.w ^ ta.w) + __popc(q.b.x ^ tb.x) + __popc(q.b.y ^ tb.y) +
                        __popc(q.b.z ^ tb.z) + __popc(q.b.w ^ tb.w);
  const uint32_t key = (dist << kIndexBits) | (uint32_t)j;
  q.k2 = min(q.k2, max(q.k1, key));
  q.k1 = min(q.k1, key);
}

__global__ void __launch_bounds__(kThreads) window_top2_kernel(
    const int32_t* __restrict__ q_desc,   // (B, Q, 8), rows 16-byte aligned
    const float* __restrict__ q_uv,       // (B, Q, 2), rows 8-byte aligned
    const float* __restrict__ q_radius,   // (B, Q)
    const int32_t* __restrict__ q_lo,     // (B, Q)
    const int32_t* __restrict__ q_hi,     // (B, Q)
    const uint8_t* __restrict__ q_valid,  // (B, Q) bool
    const int32_t* __restrict__ t_desc,   // (B, T, 8), rows 16-byte aligned
    const float* __restrict__ t_xy,       // (B, T, 2), rows 8-byte aligned
    const int32_t* __restrict__ t_octave, // (B, T)
    const uint8_t* __restrict__ t_valid,  // (B, T) bool
    int Q, int T, int blocks_per_batch,
    int32_t* __restrict__ best, int32_t* __restrict__ idx,
    int32_t* __restrict__ second, int32_t* __restrict__ idx2) {
  __shared__ int4 s_gate[kTile];  // x (NaN if invalid), y as float bits; octave
  __shared__ int s_queue[kWarps][kQueue];

  const int batch = blockIdx.x / blocks_per_batch;
  const int qblock = blockIdx.x - batch * blocks_per_batch;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;  // the lanes below this one
  const int64_t trow0 = (int64_t)batch * T;
  const int32_t* t_desc_batch = t_desc + trow0 * 8;
  const int qi = qblock * kWarps + warp;  // the warp's query, the same in every lane
  const bool in_range = qi < Q;
  const int64_t row = (int64_t)batch * Q + (in_range ? qi : 0);  // a row that exists

  // A query that is invalid, past the end or of an empty octave range
  // gets radius -1: no target is in its window.
  Query q;
  bool live;  // the same in every lane of the warp
  {
    const uint4* d = reinterpret_cast<const uint4*>(q_desc + row * 8);
    q.a = __ldg(d);
    q.b = __ldg(d + 1);
    const float2 p = __ldg(reinterpret_cast<const float2*>(q_uv) + row);
    q.u = p.x;
    q.v = p.y;
    const int lo = q_lo[row], hi = q_hi[row];
    q.lo = (uint32_t)lo;
    q.span = (uint32_t)hi - (uint32_t)lo;
    live = in_range && q_valid[row] != 0 && lo <= hi;
    q.r = live ? q_radius[row] : -1.f;
    q.k1 = q.k2 = kNoKey;
  }
  int* queue = s_queue[warp];
  int queued = 0;  // entries in the warp's queue, the same in its lanes

  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    const int padded = (n + kStride - 1) / kStride * kStride;  // the rest holds no target
    __syncthreads();  // previous tile fully consumed
    {
      float2 p[kTile / kThreads];
      int o[kTile / kThreads];
      uint8_t ok[kTile / kThreads];
#pragma unroll
      for (int s = 0; s < kTile / kThreads; ++s) {  // every load in flight at once
        const int k = s * kThreads + threadIdx.x;
        const int64_t t = trow0 + base + k;
        p[s] = make_float2(0.f, 0.f);
        o[s] = 0;
        ok[s] = 0;
        if (k < n) {
          p[s] = __ldg(reinterpret_cast<const float2*>(t_xy) + t);
          o[s] = t_octave[t];
          ok[s] = t_valid[t];
        }
      }
#pragma unroll
      for (int s = 0; s < kTile / kThreads; ++s) {
        const int k = s * kThreads + threadIdx.x;
        if (k < padded)
          s_gate[k] = make_int4(__float_as_int(ok[s] ? p[s].x : CUDART_NAN_F),
                                __float_as_int(p[s].y), o[s], 0);
      }
    }
    __syncthreads();
    if (!live) continue;

    for (int k0 = lane; k0 < padded; k0 += kStride) {
      int4 g[kUnroll];
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) g[s] = s_gate[k0 + s * 32];
      // The round's tests, none waiting on another; most rounds end here.
      uint32_t hits[kUnroll];
      uint32_t any = 0;
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const float x = __int_as_float(g[s].x), y = __int_as_float(g[s].y);
        const bool in = fabsf(q.u - x) <= q.r && fabsf(q.v - y) <= q.r &&
                        (uint32_t)g[s].z - q.lo <= q.span;
        hits[s] = __ballot_sync(0xFFFFFFFFu, in);
        any |= hits[s];
      }
      if (any == 0) continue;
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        if (hits[s] == 0) continue;
        if ((hits[s] >> lane) & 1u)
          queue[queued + __popc(hits[s] & below)] = base + k0 + s * 32;
        queued += __popc(hits[s]);
        if (queued > kQueue - 32) {  // the next step might not fit
          __syncwarp();
          for (int e = lane; e < queued; e += 32) take(q, t_desc_batch, queue[e]);
          __syncwarp();
          queued = 0;
        }
      }
    }
  }

  // What is still queued, then the two smallest keys of the warp's lanes,
  // left in every lane.
  __syncwarp();
  for (int e = lane; e < queued; e += 32) take(q, t_desc_batch, queue[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t o1 = __shfl_xor_sync(0xFFFFFFFFu, q.k1, off);
    const uint32_t o2 = __shfl_xor_sync(0xFFFFFFFFu, q.k2, off);
    q.k2 = min(max(q.k1, o1), min(q.k2, o2));
    q.k1 = min(q.k1, o1);
  }

  // Lane 0 writes; ranks no candidate took are the masked pairs', lowest
  // index first.
  if (lane != 0 || !in_range) return;
  const bool has1 = q.k1 != kNoKey, has2 = q.k2 != kNoKey;
  const int i1 = has1 ? (int)(q.k1 & kIndexMask) : 0;
  best[row] = has1 ? (int)(q.k1 >> kIndexBits) : kInvalidDist;
  idx[row] = i1;
  second[row] = has2 ? (int)(q.k2 >> kIndexBits) : kInvalidDist;
  idx2[row] = has2 ? (int)(q.k2 & kIndexMask) : (T == 1 ? 0 : (i1 == 0 ? 1 : 0));
}

__global__ void empty_kernel() {}

}  // namespace

// Launch on `stream` (a cudaStream_t). Returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.
extern "C" int window_top2_launch(
    const void* q_desc, const void* q_uv, const void* q_radius,
    const void* q_lo, const void* q_hi, const void* q_valid,
    const void* t_desc, const void* t_xy, const void* t_octave,
    const void* t_valid, int B, int Q, int T, void* best, void* idx,
    void* second, void* idx2, void* stream) {
  if (B <= 0 || Q <= 0) return (int)cudaSuccess;
  if (T <= 0 || T > kMaxTargets) return (int)cudaErrorInvalidValue;
  const int64_t blocks_per_batch = ((int64_t)Q + kWarps - 1) / kWarps;
  const int64_t blocks = blocks_per_batch * B;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  window_top2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q_desc, (const float*)q_uv, (const float*)q_radius,
      (const int32_t*)q_lo, (const int32_t*)q_hi, (const uint8_t*)q_valid,
      (const int32_t*)t_desc, (const float*)t_xy, (const int32_t*)t_octave,
      (const uint8_t*)t_valid, Q, T, (int)blocks_per_batch, (int32_t*)best,
      (int32_t*)idx, (int32_t*)second, (int32_t*)idx2);
  return (int)cudaGetLastError();
}

// An empty kernel launched the same way: the time no design goes under.
extern "C" int window_top2_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
