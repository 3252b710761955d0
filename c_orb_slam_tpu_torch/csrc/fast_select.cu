// FAST detection and keypoint selection for all of one image's pyramid
// levels in three launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves FAST and the per-cell
// top-k to XLA, which fuses them. Eagerly, PyTorch ran ops/fast.py::detect
// and ops/extract.py::select_levels as about 3,200 small kernels an image
// (a 16-step Python loop of four launches for each arc test, two thresholds,
// the cell fallback, the border, NMS, two stable sorts, the subpixel
// gathers), and the host's time to enqueue them was the largest part of a
// stereo frame. This kernel computes what
// select_levels(detect_levels(levels, cfg), cfg) computes, bit for bit:
//   1. segment test: the 16 circle neighbours, edge-clamped, minus the
//      centre, both rounded to bf16 and the difference rounded to bf16;
//      FAST-9 on the bright and dark flags (9 contiguous of the 16, the
//      16 bits duplicated to 32); score = max(sum of diff - th over bright,
//      sum of -diff - th over dark). Every term is a bf16 value of at least
//      th >= 7 less th: a multiple of 2^-5 under 2^8, so the float32 sums
//      are exact in any order.
//   2. per cell (cell x cell on the grid from (0, 0)): the high threshold's
//      scores where any in-image pixel of the cell is a high-threshold
//      corner (counted before the border), else the low threshold's;
//   3. zero outside [border, size - border); 3 x 3 non-maximum suppression
//      (neighbours outside the image count as -inf, ties kept, score > 0);
//   4. per cell, the 4 best of its cell x cell padded slots (slots outside
//      the image hold 0), ties to the lowest row-major index in the cell;
//   5. per level, its budget of the 4 x cells candidates in cell order,
//      ties to the lowest index, the pool padded with zeros at (0, 0) when
//      it is smaller than the budget; valid = response > 0;
//   6. the subpixel offset: the parabola over the 3 x 3 of the NMS'd map
//      at the keypoint, the patch clamped inside the image, as
//      orient.gather_patches and extract.subpixel_refine compute it.
//
// What bounds it on the H100: on paper operations, in practice latency. At
// KITTI's 1241 x 376 over 8 levels (1.44e6 pixels) it moves about 23 MB
// (each level read once, the score map written and read, the NMS'd map
// written: 7 us of HBM) and does about 6.2e8 plain operations (430 a pixel,
// counted in chip_smoke.py: 19 us of the lanes). The host issues three
// launches where it issued thousands; the device's time is set by the
// three launches' start-up and launch C's bitonic sort on level 0 (78
// dependent steps of a block barrier on one SM).
//
// Design:
// - A level table goes in by value (__grid_constant__), so the 8 levels
//   stay separate tensors and nothing is copied to the device first.
// - Launch A (score): a block per cell of every level. It stages the cell
//   plus a 3-pixel halo, rounded to bf16, in shared memory; pass 1 tests
//   the high threshold alone and ORs the corner flags across the block
//   (__syncthreads_or); pass 2 scores every pixel at the cell's threshold
//   and writes the border-masked map.
// - Launch B (NMS, top-4): a block per cell. It stages the cell's scores
//   plus a 1-pixel halo (-inf outside the image), writes the NMS'd map for
//   launch C, and takes the cell's 4 best as packed 64-bit keys
//   (score bits << 32 | ~index: scores are >= +0, so their bits order as
//   the floats, and among equal scores the lowest index wins), each round
//   the block-wide maximum of the keys under the previous winner.
// - Launch C (select): a block per level. It sorts the level's packed
//   candidate keys (~index over the candidate list) descending by a
//   bitonic sort in dynamic shared memory, keeps the budget, and writes
//   yx, response, valid and the subpixel offset into one buffer for the
//   whole image.
// - No atomics: a launch repeats its bits. The launches go on the caller's
//   stream, allocate nothing and never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCell = 64;  // shared memory of launches A and B stays under 48 KB
constexpr int kPerCell = 4;
constexpr int kThreads = 256;            // launches A and B
constexpr int kSelectThreads = 1024;     // launch C
constexpr int kMaxPool = 16384;          // keys of one level's sort: 128 KB of shared memory
constexpr int kTableInts = 9;            // ints a level in the launcher's table

struct Level {
  const float* img;  // (h, w) float32, rows back to back
  int h, w;
  int ncy, ncx;      // cells down and across
  int cell0;         // the level's first cell among all levels' cells
  int pix0;          // the level's offset in the score and NMS'd maps
  int budget;        // keypoints kept
  int out0;          // the level's first output slot
  int pool;          // max(4 x cells, budget): the sort's candidates
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  int cell;
  int border;
  float th_hi, th_lo;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The level of global cell g: the last level whose first cell is <= g.
__device__ __forceinline__ int level_of(const Params& p, int g) {
  int l = 0;
  while (l + 1 < p.n_levels && g >= p.lv[l + 1].cell0) ++l;
  return l;
}

// True where any 9 contiguous of the 16 circular flags are set.
__device__ __forceinline__ bool arc9(uint32_t bits) {
  const uint32_t w = bits | (bits << 16);
  uint32_t m = w;
#pragma unroll
  for (int i = 1; i < 9; ++i) m &= w >> i;
  return (m & 0xFFFFu) != 0;
}

// The segment test of the pixel whose bf16 value sits at `c` in a tile of
// row length tw (its circle at the offsets of ops/fast.py's CIRCLE,
// clockwise from 12 o'clock). With kScore, also its score (0 unless a
// corner).
template <bool kScore>
__device__ __forceinline__ bool segment_test(const float* c, int tw, float th, float* score) {
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float v = *c;
  uint32_t bright = 0, dark = 0;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float diff = bf16_round(c[dy[k] * tw + dx[k]] - v);
    if (diff > th) {
      bright |= 1u << k;
      if (kScore) sb += diff - th;
    }
    if (diff < -th) {
      dark |= 1u << k;
      if (kScore) sd += -diff - th;
    }
  }
  const bool corner = arc9(bright) || arc9(dark);
  if (kScore) *score = corner ? fmaxf(sb, sd) : 0.f;
  return corner;
}

// Launch A: the blended, border-masked FAST score of one cell's pixels.
__global__ void __launch_bounds__(kThreads)
    score_kernel(const __grid_constant__ Params p, float* __restrict__ score) {
  extern __shared__ float tile[];  // (cell + 6)^2 bf16 values, edge-clamped
  const int g = blockIdx.x;
  const Level& L = p.lv[level_of(p, g)];
  const int c = g - L.cell0, cy = c / L.ncx, cx = c - cy * L.ncx;
  const int cell = p.cell, tw = cell + 6;
  const int oy = cy * cell, ox = cx * cell;
  for (int i = threadIdx.x; i < tw * tw; i += blockDim.x) {
    const int ty = i / tw, tx = i - ty * tw;
    const int y = clampi(oy - 3 + ty, 0, L.h - 1), x = clampi(ox - 3 + tx, 0, L.w - 1);
    tile[i] = bf16_round(__ldg(L.img + (size_t)y * L.w + x));
  }
  __syncthreads();
  const int ch = min(cell, L.h - oy), cw = min(cell, L.w - ox);  // the cell inside the image
  const int n = ch * cw;
  int hi = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ty = i / cw, tx = i - ty * cw;
    if (segment_test<false>(tile + (ty + 3) * tw + tx + 3, tw, p.th_hi, nullptr)) {
      hi = 1;
      break;
    }
  }
  const float th = __syncthreads_or(hi) ? p.th_hi : p.th_lo;
  float* out = score + L.pix0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ty = i / cw, tx = i - ty * cw;
    const int y = oy + ty, x = ox + tx;
    float s = 0.f;
    if (y >= p.border && y < L.h - p.border && x >= p.border && x < L.w - p.border) {
      segment_test<true>(tile + (ty + 3) * tw + tx + 3, tw, th, &s);
    }
    out[(size_t)y * L.w + x] = s;
  }
}

// The block's largest key (every thread gets it). Two barriers; s_warp
// holds a key a warp, s_best the result.
__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* s_warp,
                                                        unsigned long long* s_best) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(0xffffffffu, v, o);
    v = t > v ? t : v;
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(0xffffffffu, v, o);
      v = t > v ? t : v;
    }
    if (lane == 0) *s_best = v;
  }
  __syncthreads();
  return *s_best;
}

// Launch B: 3 x 3 NMS of one cell, written to the NMS'd map, and the
// cell's 4 best slots as candidates.
__global__ void __launch_bounds__(kThreads)
    nms_top4_kernel(const __grid_constant__ Params p, const float* __restrict__ score,
                    float* __restrict__ nms, float* __restrict__ cand_val,
                    int* __restrict__ cand_yx) {
  extern __shared__ float sh[];
  __shared__ unsigned long long s_warp[kThreads / 32];
  __shared__ unsigned long long s_best;
  const int g = blockIdx.x;
  const Level& L = p.lv[level_of(p, g)];
  const int c = g - L.cell0, cy = c / L.ncx, cx = c - cy * L.ncx;
  const int cell = p.cell, hw = cell + 2, slots = cell * cell;
  const int oy = cy * cell, ox = cx * cell;
  float* halo = sh;               // (cell + 2)^2 scores, -inf outside the image
  float* kept = sh + hw * hw;     // cell^2 NMS'd slots, 0 outside the image
  const float* src = score + L.pix0;
  for (int i = threadIdx.x; i < hw * hw; i += blockDim.x) {
    const int ty = i / hw, tx = i - ty * hw;
    const int y = oy - 1 + ty, x = ox - 1 + tx;
    halo[i] = (y >= 0 && y < L.h && x >= 0 && x < L.w) ? src[(size_t)y * L.w + x] : -INFINITY;
  }
  __syncthreads();
  float* dst = nms + L.pix0;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int ty = i / cell, tx = i - ty * cell;
    const int y = oy + ty, x = ox + tx;
    float v = 0.f;
    if (y < L.h && x < L.w) {
      const float* q = halo + ty * hw + tx;  // the 3 x 3 around the slot
      const float s = q[hw + 1];
      float mx = -INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) mx = fmaxf(mx, q[a * hw + b]);
      v = (s >= mx && s > 0.f) ? s : 0.f;
      dst[(size_t)y * L.w + x] = v;
    }
    kept[i] = v;
  }
  __syncthreads();
  unsigned long long last = ~0ull;
  for (int r = 0; r < kPerCell; ++r) {
    unsigned long long best = 0ull;
    for (int i = threadIdx.x; i < slots; i += blockDim.x) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(kept[i]) << 32) | (0xFFFFFFFFu - (uint32_t)i);
      if (key < last && key > best) best = key;
    }
    best = block_max(best, s_warp, &s_best);
    if (threadIdx.x == 0) {
      const int idx = (int)(0xFFFFFFFFu - (uint32_t)best);
      const int k = kPerCell * g + r;
      cand_val[k] = __uint_as_float((uint32_t)(best >> 32));
      cand_yx[2 * k] = oy + idx / cell;
      cand_yx[2 * k + 1] = ox + idx % cell;
    }
    last = best;
  }
}

// extract.subpixel_refine's offset along one axis: m and p the neighbours.
__device__ __forceinline__ float axis_offset(float c, float m, float p) {
  float denom = __fsub_rn(__fsub_rn(__fmul_rn(2.f, c), m), p);
  if (fabsf(denom) < 1e-6f) denom = 1e-6f;
  const float t = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(p, m)), denom);
  return fminf(fmaxf(t, -0.5f), 0.5f);
}

// Launch C: one level's budget of its candidates, in rank order.
__global__ void __launch_bounds__(kSelectThreads)
    select_kernel(const __grid_constant__ Params p, const float* __restrict__ nms,
                  const float* __restrict__ cand_val, const int* __restrict__ cand_yx,
                  int* __restrict__ out_yx, float* __restrict__ out_resp,
                  uint8_t* __restrict__ out_valid, float* __restrict__ out_sub) {
  extern __shared__ unsigned long long keys[];
  const Level& L = p.lv[blockIdx.x];
  const int n_cand = kPerCell * L.ncy * L.ncx;
  int P = 1;
  while (P < L.pool) P <<= 1;
  const float* cv = cand_val + kPerCell * L.cell0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    // Candidates, then the zero pads of a pool under its budget, then keys
    // below every real one.
    const uint32_t bits = i < n_cand ? __float_as_uint(cv[i]) : 0u;
    keys[i] = i < L.pool ? ((unsigned long long)bits << 32) | (0xFFFFFFFFu - (uint32_t)i) : 0ull;
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if (((i & k) == 0) ? (a < b) : (a > b)) {  // descending where (i & k) == 0
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const float* m = nms + L.pix0;
  const int* cyx = cand_yx + 2 * kPerCell * L.cell0;
  for (int r = threadIdx.x; r < L.budget; r += blockDim.x) {
    const unsigned long long key = keys[r];
    const int idx = (int)(0xFFFFFFFFu - (uint32_t)key);
    const float val = __uint_as_float((uint32_t)(key >> 32));
    int y = 0, x = 0;
    if (idx < n_cand) {
      y = cyx[2 * idx];
      x = cyx[2 * idx + 1];
    }
    const int o = L.out0 + r;
    out_yx[2 * o] = y;
    out_yx[2 * o + 1] = x;
    out_resp[o] = val;
    out_valid[o] = val > 0.f;
    const int y0 = clampi(y - 1, 0, L.h - 3), x0 = clampi(x - 1, 0, L.w - 3);
    const float* q = m + (size_t)y0 * L.w + x0;
    const float cc = q[L.w + 1];
    out_sub[2 * o] = axis_offset(cc, q[1], q[2 * L.w + 1]);
    out_sub[2 * o + 1] = axis_offset(cc, q[L.w], q[L.w + 2]);
  }
}

}  // namespace

// Detect and select on the n_levels levels of one image, on `stream` (a
// cudaStream_t). images: n_levels device pointers (host array); table:
// kTableInts ints a level (h, w, ncy, ncx, cell0, pix0, budget, out0,
// pool; host array). score and nms hold every level's map (the sum of
// h x w), cand_val and cand_yx 4 candidates a cell, the outputs a slot a
// kept keypoint (out_valid as bytes). Returns the first cudaGetLastError()
// that is not cudaSuccess, checked after each launch, so a refused launch
// is reported to the caller.
extern "C" int fast_select_launch(const void* const* images, const int* table, int n_levels,
                                  int cell, int border, float th_hi, float th_lo,
                                  int total_cells, int max_pool, void* score, void* nms,
                                  void* cand_val, void* cand_yx, void* out_yx, void* out_resp,
                                  void* out_valid, void* out_sub, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || cell < 2 || cell > kMaxCell ||
      total_cells < 1 || max_pool < 1 || max_pool > kMaxPool) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.n_levels = n_levels;
  p.cell = cell;
  p.border = border;
  p.th_hi = th_hi;
  p.th_lo = th_lo;
  for (int l = 0; l < kMaxLevels; ++l) {
    Level& L = p.lv[l];
    if (l >= n_levels) {
      L = Level{nullptr, 0, 0, 0, 0, total_cells, 0, 0, 0, 0};
      continue;
    }
    const int* t = table + kTableInts * l;
    L = Level{(const float*)images[l], t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8]};
  }
  int P = 1;
  while (P < max_pool) P <<= 1;
  const size_t sort_bytes = (size_t)P * sizeof(unsigned long long);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  score_kernel<<<total_cells, kThreads, (size_t)(cell + 6) * (cell + 6) * sizeof(float), s>>>(
      p, (float*)score);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nms_top4_kernel<<<total_cells, kThreads,
                    (size_t)((cell + 2) * (cell + 2) + cell * cell) * sizeof(float), s>>>(
      p, (const float*)score, (float*)nms, (float*)cand_val, (int*)cand_yx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (sort_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sort_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  select_kernel<<<n_levels, kSelectThreads, sort_bytes, s>>>(
      p, (const float*)nms, (const float*)cand_val, (const int*)cand_yx, (int*)out_yx,
      (float*)out_resp, (uint8_t*)out_valid, (float*)out_sub);
  return (int)cudaGetLastError();
}
