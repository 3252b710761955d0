// Motion-only pose optimization, the whole Gauss-Newton solve in one launch,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optim/pose_opt.py's loop
// to XLA, which fuses it. Eagerly, PyTorch ran that loop as about 6,700
// small kernels a solve (4 rounds x 10 iterations of some 167 ops), and
// the host's time to enqueue them was most of a tracked frame. This kernel
// computes what optim/pose_opt.py::optimize_pose_reference computes, in
// float32:
//   per round, per iteration, per row n:
//     xc = R xw + t; z = max(xc.z, 1e-8) (NaN stays NaN);
//     r = obs - (fx x/z + cx, fy y/z + cy, u - bf/z), third part zeroed
//         for mono rows; Jproj = d(u, v, ur)/d(xc), third row zeroed too;
//     J = -(Jproj [I | -hat(xc)]);
//     w = inv_sigma2 * mask, times the Huber weight (delta^2 = the row's
//         chi2 gate) in rounds 0-1;
//   H = sum w J^T J + damping I, b = sum w J^T r; dx = solve(H, -b) by
//   Gaussian elimination with partial pivoting (a singular H gives NaN,
//   as the LU of solve_ex does); T <- exp(dx) T, exp of geometry/se3.py
//   (rho first, then phi) with so3's small-angle branches;
//   after each round: mask = valid & (chi2 <= gate), gates 5.991 (mono)
//   and 7.815 (stereo) as the caller passes them.
// Round 0's mask is `valid`. Every row enters every sum, a masked one with
// weight 0, so a NaN row poisons the solve as it does in the plain
// version.
//
// What bounds it on the H100: latency, not bytes or operations. At the
// tracker's shape (2,000 rows, 40 iterations) the work is about 16 MFLOP
// and 60 KB of rows: microseconds of one SM. Each iteration waits on a
// block-wide reduction and a serial 6x6 solve, so the solve's time is
// about 44 such dependent steps.
//
// Design:
// - One block per problem (grid = B). Its threads stride over the rows,
//   each keeping its rows' 21 upper-triangle terms of H and 6 of b in
//   registers, summed in row order. Rows stay in L1 across iterations.
// - The block's sum is taken in a fixed order: a shuffle tree in each
//   warp, then lane j of warp 0 sums term j over the warps in warp order.
//   No atomics, so a launch repeats its bits.
// - Thread 0 solves the 6x6 system and updates the pose in shared memory;
//   one __syncthreads() hands it to the block.
// - The working inlier mask is the `inliers` output: each thread reads
//   and writes only its own rows, so it needs no barrier.
// - The block's size follows the row count (a warp for PnP's 6-row
//   hypotheses, up to kMaxThreads), so the sums' order depends on the
//   shape alone.
// - The launch goes on the caller's stream, allocates nothing and never
//   synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTerms = 27;  // 21 of H's upper triangle, row-major, then 6 of b
constexpr float kEps = 1e-8f;          // camera.py / so3.py _EPS
constexpr float kEps2 = 1e-16f;        // _EPS ** 2
constexpr float kChi2Floor = 1e-12f;   // residuals.huber_weight's clamp

struct Problem {
  const float* xw;      // (N, 3) rows of this problem
  const float* obs;     // (N, 3)
  const float* isig;    // (N,)
  const uint8_t* stereo;
  const uint8_t* valid;
  uint8_t* inl;         // (N,) the working mask, then the output
  int N;
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo;
};

// Residual (3), pose Jacobian (3 x 6), chi2 and gate of row n at T.
struct Row {
  float r[3];
  float J[3][6];
  float chi2, gate;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // NaN stays NaN, as torch.clamp
}

__device__ __forceinline__ void row_at(const Problem& p, const float* T, int n, bool jac,
                                       Row& o) {
  const float X0 = __ldg(p.xw + 3 * n), X1 = __ldg(p.xw + 3 * n + 1),
              X2 = __ldg(p.xw + 3 * n + 2);
  const float x = X0 * T[0] + X1 * T[1] + X2 * T[2] + T[3];
  const float y = X0 * T[4] + X1 * T[5] + X2 * T[6] + T[7];
  const float zr = X0 * T[8] + X1 * T[9] + X2 * T[10] + T[11];
  const float z = clamp_min(zr, kEps);
  const bool st = __ldg(p.stereo + n) != 0;
  const float third = st ? 1.f : 0.f;
  const float u = p.fx * x / z + p.cx;
  const float v = p.fy * y / z + p.cy;
  o.r[0] = __ldg(p.obs + 3 * n) - u;
  o.r[1] = __ldg(p.obs + 3 * n + 1) - v;
  o.r[2] = (__ldg(p.obs + 3 * n + 2) - (u - p.bf / z)) * third;
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * __ldg(p.isig + n);
  o.gate = st ? p.chi2_stereo : p.chi2_mono;
  if (!jac) return;
  const float zinv = 1.f / z;
  const float zinv2 = zinv * zinv;
  // Jproj rows (d/dx, d/dy, d/dz): u, v, and ur = u + bf/z^2 on d/dz.
  float a[3], b[3], c[3];
  a[0] = p.fx * zinv; b[0] = 0.f;        c[0] = -p.fx * x * zinv2;
  a[1] = 0.f;        b[1] = p.fy * zinv; c[1] = -p.fy * y * zinv2;
  a[2] = a[0] * third;
  b[2] = b[0] * third;
  c[2] = (c[0] + p.bf * (1.f / (z * z))) * third;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // -(Jproj_i [I | -hat(xc)]) with xc unclamped, as so3.hat(xc).
    o.J[i][0] = -a[i];
    o.J[i][1] = -b[i];
    o.J[i][2] = -c[i];
    o.J[i][3] = b[i] * zr - c[i] * y;
    o.J[i][4] = c[i] * x - a[i] * zr;
    o.J[i][5] = a[i] * y - b[i] * x;
  }
}

// dx = solve(H, -b): Gaussian elimination with partial pivoting (the first
// largest |pivot|), every index static so the system stays in registers.
__device__ void solve6(const float* s, float damping, float dx[6]) {
  float A[6][7];
  int t = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) {
      A[j][k] = s[t];
      A[k][j] = s[t];
      ++t;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    A[j][j] += damping;
    A[j][6] = -s[21 + j];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float m = fabsf(A[i][k]);
      if (m > best) { best = m; piv = i; }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == piv) {
#pragma unroll
        for (int j = k; j < 7; ++j) {
          const float tmp = A[k][j]; A[k][j] = A[i][j]; A[i][j] = tmp;
        }
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] -= l * A[k][j];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float acc = A[k][6];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) acc -= A[k][j] * dx[j];
    dx[k] = acc / A[k][k];
  }
}

// T <- exp(dx) T with geometry/se3.exp (rho = dx[0:3], phi = dx[3:6]).
__device__ void update_pose(float* T, const float dx[6]) {
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(clamp_min(theta2, kEps2));
  const bool small = theta2 < kEps;
  const float s = sinf(theta), c = cosf(theta);
  const float A = small ? 1.f - theta2 / 6.f : s / theta;
  const float Bc = small ? 0.5f - theta2 / 24.f : (1.f - c) / theta2;
  const float C = small ? 1.f / 6.f - theta2 / 120.f : (theta - s) / (theta2 * theta);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float WW[3][3], R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      WW[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.f : 0.f;
      R[i][j] = eye + A * W[i][j] + Bc * WW[i][j];
      V[i][j] = eye + Bc * W[i][j] + C * WW[i][j];
    }
  }
  float te[3], Tn[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) te[i] = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] +
                      (j == 3 ? te[i] : 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = Tn[k];
}

__global__ void __launch_bounds__(kMaxThreads) pose_gn_kernel(
    const float* __restrict__ T0,        // (B, 3, 4)
    const float* __restrict__ xw,        // (B, N, 3), batch stride s_xw
    const float* __restrict__ obs,       // (B, N, 3), batch stride s_obs
    const float* __restrict__ isig,      // (B, N), batch stride s_isig
    const uint8_t* __restrict__ stereo,  // (B, N) bool, batch stride s_stereo
    const uint8_t* __restrict__ valid,   // (B, N) bool, batch stride s_valid
    const float* __restrict__ K,         // (4,) fx, fy, cx, cy
    long long s_xw, long long s_obs, long long s_isig, long long s_stereo, long long s_valid,
    int N, int rounds, int iters, float bf, float chi2_mono, float chi2_stereo,
    float damping, float* __restrict__ pose, uint8_t* inliers, int32_t* __restrict__ n_inliers) {
  __shared__ float s_part[kMaxWarps][kTerms];
  __shared__ float s_sum[kTerms];
  __shared__ float s_T[12];
  __shared__ int s_count[kMaxWarps];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  Problem p;
  p.xw = xw + b * s_xw;
  p.obs = obs + b * s_obs;
  p.isig = isig + b * s_isig;
  p.stereo = stereo + b * s_stereo;
  p.valid = valid + b * s_valid;
  p.inl = inliers + (long long)b * N;
  p.N = N;
  p.fx = __ldg(K); p.fy = __ldg(K + 1); p.cx = __ldg(K + 2); p.cy = __ldg(K + 3);
  p.bf = bf;
  p.chi2_mono = chi2_mono;
  p.chi2_stereo = chi2_stereo;

  if (threadIdx.x < 12) s_T[threadIdx.x] = T0[12 * b + threadIdx.x];
  for (int n = threadIdx.x; n < N; n += blockDim.x) p.inl[n] = __ldg(p.valid + n);
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;  // the reference drops the kernel from round 3
    for (int it = 0; it < iters; ++it) {
      float T[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = s_T[k];
      float acc[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) acc[k] = 0.f;
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        Row o;
        row_at(p, T, n, true, o);
        float w = __ldg(p.isig + n) * (p.inl[n] ? 1.f : 0.f);
        if (huber) {
          const float e = sqrtf(clamp_min(o.chi2, kChi2Floor));
          w *= o.chi2 <= o.gate ? 1.f : sqrtf(o.gate) / e;
        }
        int t = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float q0 = o.J[0][j] * w, q1 = o.J[1][j] * w, q2 = o.J[2][j] * w;
#pragma unroll
          for (int k = j; k < 6; ++k) {
            acc[t++] += q0 * o.J[0][k] + q1 * o.J[1][k] + q2 * o.J[2][k];
          }
          acc[21 + j] += q0 * o.r[0] + q1 * o.r[1] + q2 * o.r[2];
        }
      }
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) s_part[warp][k] = v;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < kTerms) {
          float v = s_part[0][lane];
          for (int q = 1; q < n_warps; ++q) v += s_part[q][lane];
          s_sum[lane] = v;
        }
        __syncwarp();
        if (lane == 0) {
          float dx[6];
          solve6(s_sum, damping, dx);
          float Tn[12];
#pragma unroll
          for (int k = 0; k < 12; ++k) Tn[k] = s_T[k];
          update_pose(Tn, dx);
#pragma unroll
          for (int k = 0; k < 12; ++k) s_T[k] = Tn[k];
        }
      }
      __syncthreads();
    }
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = s_T[k];
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      Row o;
      row_at(p, T, n, false, o);
      p.inl[n] = (__ldg(p.valid + n) != 0) && o.chi2 <= o.gate;
    }
  }

  int count = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) count += p.inl[n];
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int q = 0; q < n_warps; ++q) total += s_count[q];
    n_inliers[b] = total;
  }
  if (threadIdx.x < 12) pose[12 * b + threadIdx.x] = s_T[threadIdx.x];
}

}  // namespace

// Launch B problems of N rows on `stream` (a cudaStream_t) with `threads`
// threads a block (a multiple of 32, at most kMaxThreads). Returns
// cudaGetLastError() after the launch, so a refused launch is reported to
// the caller.
extern "C" int pose_gn_launch(
    const void* T0, const void* xw, const void* obs, const void* isig, const void* stereo,
    const void* valid, const void* K, long long s_xw, long long s_obs, long long s_isig,
    long long s_stereo, long long s_valid, int B, int N, int rounds, int iters, float bf,
    float chi2_mono, float chi2_stereo, float damping, int threads, void* pose, void* inliers,
    void* n_inliers, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 0 || threads < 32 || threads > kMaxThreads || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  pose_gn_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)T0, (const float*)xw, (const float*)obs, (const float*)isig,
      (const uint8_t*)stereo, (const uint8_t*)valid, (const float*)K, s_xw, s_obs, s_isig,
      s_stereo, s_valid, N, rounds, iters, bf, chi2_mono, chi2_stereo, damping,
      (float*)pose, (uint8_t*)inliers, (int32_t*)n_inliers);
  return (int)cudaGetLastError();
}
