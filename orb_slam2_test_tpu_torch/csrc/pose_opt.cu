// Motion-only bundle adjustment (pose optimization) in one kernel.
//
// Replaces the Pallas kernel built by `_make_kernel` in
// orb_slam2_test_tpu/solvers/pose_opt_pallas.py (launched by
// `pose_optimization_tpu`). Semantics follow it, and through it
// Optimizer::PoseOptimization of the reference: `rounds` rounds of
// `iters_per_round` Gauss-Newton iterations; each iteration
//   1. projects every observation, with a stereo row where u_r >= 0;
//   2. weights it by inlier * valid * (z > 0) * huber * inv_sigma2, the
//      Huber weight only in rounds 1-2 (delta = sqrt(chi2 gate));
//   3. sums the 21 lower-triangle entries of H = J^T W J and the 6 of
//      g = -J^T W r;
//   4. damps H_ii += damping * (1 + H_ii);
//   5. solves H dx = g by a 6x6 Cholesky;
//   6. zeroes dx if any entry is not finite;
//   7. left-multiplies the pose by exp(dx).
// At each round's end an observation is an inlier iff chi2 <= its gate
// (5.991 mono, 7.815 stereo) and z > 0. After the last round chi2 is
// computed from the final pose.
//
// Layout: one block of 256 threads for the one problem. Each thread
// loops over its share of the observations (read as X [O,3], obs [O,3],
// isig [O], valid [O]; no [8, R, 128] planes) and keeps partials of the
// 27 sums in registers; a warp-shuffle reduction and a shared-memory
// pass over the warps give the totals; one thread does the damping,
// the solve and the SE3 exponential and publishes the 12 pose scalars
// through shared memory. Each thread reclassifies its own observations
// at round boundaries, keeping the inlier flags in the output buffer.
//
// What bounds it: latency. The 40 iterations depend on each other and
// each ends in a block-wide reduction and a serial solve on one thread;
// the arithmetic (about 0.25 MFLOP per iteration for 1000
// observations) is negligible for one SM. Sums are taken in another
// order than XLA or the TPU takes them, so results agree to rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 H entries (j <= i) + 6 g entries

struct Params {
  float fx, fy, cx, cy, bf;
  float chi2_mono, chi2_stereo, huber_mono, huber_stereo;
  float damping;
  int rounds, iters_per_round;
};

// Pose as 12 scalars: r00 r01 r02 r10 r11 r12 r20 r21 r22 t0 t1 t2.
struct Residual {
  float x, y, iz, iz2, ru, rv, rur, chi2, stereo;
  bool z_ok;
};

__device__ __forceinline__ Residual residual(const float* P, const Params& p,
                                             const float* __restrict__ X,
                                             const float* __restrict__ obs,
                                             float isig, int o) {
  const float Xx = X[3 * o], Xy = X[3 * o + 1], Xz = X[3 * o + 2];
  const float ou = obs[3 * o], ov = obs[3 * o + 1], our = obs[3 * o + 2];
  Residual r;
  r.stereo = our >= 0.f ? 1.f : 0.f;
  r.x = P[0] * Xx + P[1] * Xy + P[2] * Xz + P[9];
  r.y = P[3] * Xx + P[4] * Xy + P[5] * Xz + P[10];
  const float z = P[6] * Xx + P[7] * Xy + P[8] * Xz + P[11];
  r.z_ok = z > 0.f;
  const float z_safe = fabsf(z) > 1e-6f ? z : 1e-6f;
  r.iz = 1.f / z_safe;
  r.iz2 = r.iz * r.iz;
  const float u = p.fx * r.x * r.iz + p.cx;
  const float v = p.fy * r.y * r.iz + p.cy;
  const float ur = u - p.bf * r.iz;
  r.ru = ou - u;
  r.rv = ov - v;
  r.rur = r.stereo * (our - ur);
  r.chi2 = (r.ru * r.ru + r.rv * r.rv + r.rur * r.rur) * isig;
  return r;
}

// Unrolled Cholesky solve of the damped 6x6 system; sum[] holds the
// lower triangle of H at i*(i+1)/2 + j and g at 21 + i.
__device__ void chol6_solve(const float* sum, float damping, float* dx) {
  float H[6][6];
  for (int i = 0, s = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j, ++s) H[i][j] = sum[s];
  for (int i = 0; i < 6; ++i) H[i][i] += damping * (1.f + H[i][i]);
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = -sum[21 + i];  // g = -J^T W r
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * dx[k];
    dx[i] = s / L[i][i];
  }
}

// P <- exp(dx) P, dx = (upsilon, omega), small-angle-safe closed form.
__device__ void se3_exp_left_mul(const float* dx, float* P) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const bool small = th2 < 1e-12f;
  const float th = small ? 1.f : sqrtf(th2);
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / (th * th);
  const float C =
      small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th * th * th);
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float Re[3][3], te[3];
  for (int i = 0; i < 3; ++i) {
    float vu = 0.f;
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.f;
      for (int k = 0; k < 3; ++k) w2 += W[i][k] * W[k][j];
      const float eye = (i == j) ? 1.f : 0.f;
      Re[i][j] = eye + A * W[i][j] + B * w2;
      vu += (eye + B * W[i][j] + C * w2) * dx[j];
    }
    te[i] = vu;
  }
  float out[12];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] =
          Re[i][0] * P[j] + Re[i][1] * P[3 + j] + Re[i][2] * P[6 + j];
    }
    out[9 + i] = Re[i][0] * P[9] + Re[i][1] * P[10] + Re[i][2] * P[11] + te[i];
  }
  for (int k = 0; k < 12; ++k) P[k] = out[k];
}

__global__ void __launch_bounds__(kThreads)
    pose_opt_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                    const float* __restrict__ obs,
                    const float* __restrict__ isig,
                    const float* __restrict__ valid, int n, Params p,
                    float* __restrict__ T_out, float* __restrict__ inl,
                    float* __restrict__ chi2_out) {
  __shared__ float pose[12];
  __shared__ float partial[kWarps][kSums];
  __shared__ float total[kSums];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    // row-major [4, 4] -> 12 scalars
    const int src[12] = {0, 1, 2, 4, 5, 6, 8, 9, 10, 3, 7, 11};
    for (int k = 0; k < 12; ++k) pose[k] = T0[src[k]];
  }
  for (int o = tid; o < n; o += kThreads) inl[o] = 1.f;
  __syncthreads();

  const int n_iters = p.rounds * p.iters_per_round;
  for (int it = 0; it < n_iters; ++it) {
    const bool robust = it < 2 * p.iters_per_round;
    float P[12];
    for (int k = 0; k < 12; ++k) P[k] = pose[k];

    float acc[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) acc[s] = 0.f;
    for (int o = tid; o < n; o += kThreads) {
      const float is = isig[o];
      const Residual r = residual(P, p, X, obs, is, o);
      const float delta = r.stereo > 0.f ? p.huber_stereo : p.huber_mono;
      const float rnorm = sqrtf(fmaxf(r.chi2, 1e-20f));
      const float w_h = (robust && rnorm > delta) ? delta / rnorm : 1.f;
      const float w =
          inl[o] * valid[o] * (r.z_ok ? 1.f : 0.f) * w_h * is;
      // Jacobian rows of (u, v, u_r) residuals w.r.t. the left update
      const float fx = p.fx, fy = p.fy, bf = p.bf;
      const float x = r.x, y = r.y, iz = r.iz, iz2 = r.iz2;
      const float a[6] = {-fx * iz,          0.f,
                          fx * x * iz2,      fx * x * y * iz2,
                          -fx * (1.f + x * x * iz2), fx * y * iz};
      const float b[6] = {0.f,
                          -fy * iz,
                          fy * y * iz2,
                          fy * (1.f + y * y * iz2),
                          -fy * x * y * iz2,
                          -fy * x * iz};
      const float e[6] = {0.f, 0.f, -bf * iz2, -bf * y * iz2, bf * x * iz2,
                          0.f};
      float c[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i] = r.stereo * (a[i] + e[i]);
      int s = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j, ++s)
          acc[s] += w * (a[i] * a[j] + b[i] * b[j] + c[i] * c[j]);
#pragma unroll
      for (int i = 0; i < 6; ++i)
        acc[21 + i] += w * (a[i] * r.ru + b[i] * r.rv + c[i] * r.rur);
    }

    // block reduction: shuffle within each warp, then across warps
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      float v = acc[s];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][s] = v;
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kSums) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += partial[w][lane];
        total[lane] = v;
      }
      __syncwarp();
      if (lane == 0) {
        float dx[6];
        chol6_solve(total, p.damping, dx);
        bool finite = true;
        for (int i = 0; i < 6; ++i) finite = finite && isfinite(dx[i]);
        if (!finite)
          for (int i = 0; i < 6; ++i) dx[i] = 0.f;
        se3_exp_left_mul(dx, P);
        for (int k = 0; k < 12; ++k) pose[k] = P[k];
      }
    }
    __syncthreads();

    if ((it + 1) % p.iters_per_round == 0) {
      // round boundary: reclassify with the fresh pose
      for (int k = 0; k < 12; ++k) P[k] = pose[k];
      for (int o = tid; o < n; o += kThreads) {
        const Residual r = residual(P, p, X, obs, isig[o], o);
        const float th = r.stereo > 0.f ? p.chi2_stereo : p.chi2_mono;
        inl[o] = (r.chi2 <= th && r.z_ok) ? 1.f : 0.f;
      }
    }
  }

  // final chi2 with the final pose
  float P[12];
  for (int k = 0; k < 12; ++k) P[k] = pose[k];
  for (int o = tid; o < n; o += kThreads)
    chi2_out[o] = residual(P, p, X, obs, isig[o], o).chi2;
  if (tid == 0) {
    const float vals[16] = {P[0], P[1], P[2], P[9],  P[3], P[4], P[5], P[10],
                            P[6], P[7], P[8], P[11], 0.f,  0.f,  0.f,  1.f};
    for (int k = 0; k < 16; ++k) T_out[k] = vals[k];
  }
}

}  // namespace

// T0 [16] row-major pose, X [n, 3], obs [n, 3] (u, v, u_r; u_r < 0 =
// mono), isig [n], valid [n] as 0/1; outputs T_out [16], inl [n] as 0/1
// (not yet ANDed with valid) and chi2 [n]. All float32, contiguous, on
// the current device.
extern "C" int pose_opt(const float* T0, const float* X, const float* obs,
                        const float* isig, const float* valid, int n,
                        float fx, float fy, float cx, float cy, float bf,
                        float chi2_mono, float chi2_stereo, float huber_mono,
                        float huber_stereo, float damping, int rounds,
                        int iters_per_round, float* T_out, float* inl,
                        float* chi2_out, void* stream) {
  const Params p{fx,          fy,         cx,           cy,
                 bf,          chi2_mono,  chi2_stereo,  huber_mono,
                 huber_stereo, damping,   rounds,       iters_per_round};
  pose_opt_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T0, X, obs, isig, valid, n, p, T_out, inl, chi2_out);
  return static_cast<int>(cudaGetLastError());
}
