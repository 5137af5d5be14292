// Motion-only bundle adjustment (pose optimization) in one launch.
//
// Replaces the Pallas kernel built by `_make_kernel` in
// orb_slam2_test_tpu/solvers/pose_opt_pallas.py (launched by
// `pose_optimization_tpu`). Semantics follow it, and through it
// Optimizer::PoseOptimization of the reference: the start pose is
// re-orthonormalized (Gram-Schmidt on the rotation's columns, as
// geometry/se3.py `so3_project`), then `rounds` rounds of
// `iters_per_round` Gauss-Newton iterations; each iteration
//   1. projects every observation, with a stereo row where u_r >= 0;
//   2. weights it by inlier * valid * (z > 0) * huber * inv_sigma2, the
//      Huber weight only in rounds 1-2 (delta = sqrt(chi2 gate));
//   3. sums the 21 lower-triangle entries of H = J^T W J and the 6 of
//      g = -J^T W r;
//   4. damps H_ii += damping * (1 + H_ii);
//   5. solves H dx = g by a 6x6 LDL^T (Cholesky without square roots);
//   6. zeroes dx if any entry is not finite;
//   7. left-multiplies the pose by exp(dx).
// At each round's end an observation is an inlier iff chi2 <= its gate
// (5.991 mono, 7.815 stereo) and z > 0. The final pose is
// re-orthonormalized, chi2 is computed from it, the inliers are ANDed
// with `valid` and counted. So one launch does all that the wrapper
// around the first port's kernel did with ~40 small torch ops.
//
// Layout: a thread-block cluster of up to 8 CTAs of up to 256 threads,
// one thread per observation where O allows (O = 2000: 8 x 256). Thread
// g of the cluster owns observations g, g + stride, ... The observations
// are staged once: each thread keeps its first one in registers, the
// next ones (up to kSmemObs per CTA) sit in its CTA's shared memory as
// structure-of-arrays (X, Y, Z, u, v, u_r, inv_sigma2, flags), and any
// beyond that are read from global memory in the same loop, with their
// inlier flags kept in the output buffer; so any O >= 0 is taken. Per
// iteration each thread sums its observations' 27 terms in registers; a
// warp reduce-scatter (a 31-shuffle butterfly) leaves sum s of the warp
// in lane s; one shared-memory row per warp and a column pass give the
// CTA's sums. After the cluster barrier every warp of every CTA adds the
// cluster's sums through distributed shared memory, in rank order (lane
// s, sum s), broadcasts them over the warp with 27 shuffles, and every
// thread solves the same system the same way: each thread keeps the pose
// in registers, and an iteration costs two barriers, one of the CTA and
// one of the cluster (the sums are double-buffered by iteration parity,
// so the buffer written next is one that nobody still reads).
//
// What bounds it: latency. The 40 iterations depend on each other, and
// each is a cluster-wide reduction and a serial 6x6 solve; the
// arithmetic (about 270 FLOP per observation and iteration, 22 MFLOP at
// O = 2000) would take 0.3 us at the card's fp32 rate over all 132 SMs,
// but on one SM it is issue-bound at about 3 us per iteration (measured
// on a single 1024-thread CTA), which is why the observations are
// spread over a cluster. The solve (LDL^T) has one division per column
// and no square root; the update one division and one sincosf. Numerics are IEEE fp32 without fast-math intrinsics; sums
// are taken in another order than the plain version's, so results
// agree to rounding.
//
// Built with -DPOSE_OPT_CLOCKS (examples/pose_opt_floor.py), thread 0 of
// the cluster's first CTA adds the clock64 cycles of each phase of an
// iteration into a device array that `pose_opt_clocks` reads back.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // most threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // CTAs per cluster, the portable limit
constexpr int kSums = 27;  // 21 H entries (j <= i) + 6 g entries
static_assert(kSums <= 32, "one sum per lane of the reduce-scatter");
constexpr int kSmemObs = 6144;  // observations a CTA stages in shared memory
constexpr int kObsBytes = 7 * 4 + 1;  // 7 floats and a flag byte
constexpr uint8_t kValid = 1, kInlier = 2;

#ifdef POSE_OPT_CLOCKS
// accumulate, reduce-scatter, CTA barrier + column sum, cluster barrier,
// cluster sums + broadcast, LDL^T solve, exp update, reclassification;
// then the iterations' nanoseconds on the global timer
constexpr int kPhases = 8;
__device__ unsigned long long g_clocks[kPhases + 1];
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#define PHASE(i)                        \
  do {                                  \
    if (timer) {                        \
      const long long now_ = clock_now(); \
      clk[i] += now_ - last;            \
      last = now_;                      \
    }                                   \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

struct Params {
  float fx, fy, cx, cy, bf;
  float chi2_mono, chi2_stereo, huber_mono, huber_stereo;
  float damping;
  int rounds, iters_per_round;
};

struct Obs {
  float X, Y, Z, u, v, ur, isig;
  bool valid;
};

__device__ __forceinline__ Obs load_obs(const float* __restrict__ X,
                                        const float* __restrict__ obs,
                                        const float* __restrict__ isig,
                                        const uint8_t* __restrict__ valid,
                                        int o) {
  return Obs{X[3 * o], X[3 * o + 1], X[3 * o + 2], obs[3 * o],
             obs[3 * o + 1], obs[3 * o + 2], isig[o], valid[o] != 0};
}

// The staged observations in shared memory, structure-of-arrays.
struct Stage {
  float *X, *Y, *Z, *u, *v, *ur, *isig;
  uint8_t* flags;

  __device__ Stage(float* base, int cap)
      : X(base), Y(base + cap), Z(base + 2 * cap), u(base + 3 * cap),
        v(base + 4 * cap), ur(base + 5 * cap), isig(base + 6 * cap),
        flags(reinterpret_cast<uint8_t*>(base + 7 * cap)) {}
  __device__ Obs get(int s) const {
    return Obs{X[s], Y[s], Z[s], u[s], v[s], ur[s], isig[s],
               (flags[s] & kValid) != 0};
  }
  __device__ void put(int s, const Obs& b) {
    X[s] = b.X; Y[s] = b.Y; Z[s] = b.Z;
    u[s] = b.u; v[s] = b.v; ur[s] = b.ur; isig[s] = b.isig;
    flags[s] = (b.valid ? kValid : 0) | kInlier;
  }
};

// Pose as 12 scalars: r00 r01 r02 r10 r11 r12 r20 r21 r22 t0 t1 t2.
struct Residual {
  float x, y, iz, iz2, ru, rv, rur, chi2, stereo;
  bool z_ok;
};

__device__ __forceinline__ Residual residual(const float* P, const Params& p,
                                             const Obs& b) {
  Residual r;
  r.stereo = b.ur >= 0.f ? 1.f : 0.f;
  r.x = P[0] * b.X + P[1] * b.Y + P[2] * b.Z + P[9];
  r.y = P[3] * b.X + P[4] * b.Y + P[5] * b.Z + P[10];
  const float z = P[6] * b.X + P[7] * b.Y + P[8] * b.Z + P[11];
  r.z_ok = z > 0.f;
  const float z_safe = fabsf(z) > 1e-6f ? z : 1e-6f;
  r.iz = 1.f / z_safe;
  r.iz2 = r.iz * r.iz;
  const float u = p.fx * r.x * r.iz + p.cx;
  const float v = p.fy * r.y * r.iz + p.cy;
  const float ur = u - p.bf * r.iz;
  r.ru = b.u - u;
  r.rv = b.v - v;
  r.rur = r.stereo * (b.ur - ur);
  r.chi2 = (r.ru * r.ru + r.rv * r.rv + r.rur * r.rur) * b.isig;
  return r;
}

__device__ __forceinline__ bool is_inlier(const float* P, const Params& p,
                                          const Obs& b) {
  const Residual r = residual(P, p, b);
  const float th = r.stereo > 0.f ? p.chi2_stereo : p.chi2_mono;
  return r.chi2 <= th && r.z_ok;
}

// acc[0..20] += w J^T J (lower triangle), acc[21..26] += w J^T r.
__device__ __forceinline__ void accumulate(const float* P, const Params& p,
                                           const Obs& b, bool inlier,
                                           bool robust, float* acc) {
  const Residual r = residual(P, p, b);
  const float delta = r.stereo > 0.f ? p.huber_stereo : p.huber_mono;
  const float rnorm = sqrtf(fmaxf(r.chi2, 1e-20f));
  const float w_h = (robust && rnorm > delta) ? delta / rnorm : 1.f;
  const float w = (inlier && b.valid && r.z_ok) ? w_h * b.isig : 0.f;
  // Jacobian rows of the (u, v, u_r) residuals w.r.t. the left update
  const float fx = p.fx, fy = p.fy, bf = p.bf;
  const float x = r.x, y = r.y, iz = r.iz, iz2 = r.iz2;
  const float a[6] = {-fx * iz,          0.f,
                      fx * x * iz2,      fx * x * y * iz2,
                      -fx * (1.f + x * x * iz2), fx * y * iz};
  const float bb[6] = {0.f,
                       -fy * iz,
                       fy * y * iz2,
                       fy * (1.f + y * y * iz2),
                       -fy * x * y * iz2,
                       -fy * x * iz};
  const float e[6] = {0.f, 0.f, -bf * iz2, -bf * y * iz2, bf * x * iz2, 0.f};
  float c[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = r.stereo * (a[i] + e[i]);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j, ++s)
      acc[s] += w * (a[i] * a[j] + bb[i] * bb[j] + c[i] * c[j]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc[21 + i] += w * (a[i] * r.ru + bb[i] * r.rv + c[i] * r.rur);
}

// One butterfly stage over a lane's first 2 kHalf values: the lane
// whose bit kHalf is 0 keeps the lower half, its partner the upper
// half, and each adds the partner's copy of the half it keeps, into
// v[0 .. kHalf-1].
template <int kHalf>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Reduce-scatter over a warp: on return lane l holds the warp's sum of
// v[l]. Each stage halves the values a lane keeps: 16 + 8 + 4 + 2 + 1 =
// 31 shuffles for 32 sums.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// Unrolled LDL^T solve of the damped 6x6 system; sum[] holds the lower
// triangle of H at i*(i+1)/2 + j and g at 21 + i. The pivots are those
// of a Cholesky factor squared (H = L D L^T with unit L), clamped at
// 1e-12 as its square roots would be, so no square root is taken and
// each column costs one division (its pivot's reciprocal).
__device__ __forceinline__ void ldl6_solve(const float* sum, float damping,
                                           float* dx) {
  float H[6][6];
#pragma unroll
  for (int i = 0, s = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j, ++s) H[i][j] = sum[s];
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i][i] += damping * (1.f + H[i][i]);
  // LD[i][k] = L[i][k] * D[k]; L[i][j] = (H[i][j] - sum_k LD[i][k] L[j][k]) / D[j]
  float L[6][6], LD[6][6], D[6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= LD[j][k] * L[j][k];
    D[j] = fmaxf(d, 1e-12f);
    inv[j] = 1.f / D[j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= LD[i][k] * L[j][k];
      LD[i][j] = s;
      L[i][j] = s * inv[j];
    }
  }
  // L y = g, then L^T dx = D^-1 y
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -sum[21 + i];  // g = -J^T W r
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i] * inv[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * dx[k];
    dx[i] = s;
  }
}

// P <- exp(dx) P, dx = (upsilon, omega), small-angle-safe closed form.
__device__ __forceinline__ void se3_exp_left_mul(const float* dx, float* P) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const bool small = th2 < 1e-12f;
  const float th = small ? 1.f : sqrtf(th2);
  const float ith = 1.f / th;  // one division for A, B and C
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float A = small ? 1.f - th2 / 6.f : sn * ith;
  const float B = small ? 0.5f - th2 / 24.f : (1.f - cs) * (ith * ith);
  const float C = small ? 1.f / 6.f - th2 / 120.f : (th - sn) * (ith * ith * ith);
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float Re[3][3], te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float vu = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2 += W[i][k] * W[k][j];
      const float eye = (i == j) ? 1.f : 0.f;
      Re[i][j] = eye + A * W[i][j] + B * w2;
      vu += (eye + B * W[i][j] + C * w2) * dx[j];
    }
    te[i] = vu;
  }
  float out[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] =
          Re[i][0] * P[j] + Re[i][1] * P[3 + j] + Re[i][2] * P[6 + j];
    }
    out[9 + i] = Re[i][0] * P[9] + Re[i][1] * P[10] + Re[i][2] * P[11] + te[i];
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = out[k];
}

// Gram-Schmidt on the rotation's columns, in the order of
// geometry/se3.py `so3_project`: x = c0 / |c0|, y = c1 - (x.c1) x,
// y /= |y|, z = x cross y.
__device__ __forceinline__ void so3_project(float* P) {
  float x0 = P[0], x1 = P[3], x2 = P[6];
  const float nx = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
  x0 /= nx; x1 /= nx; x2 /= nx;
  float y0 = P[1], y1 = P[4], y2 = P[7];
  const float d = x0 * y0 + x1 * y1 + x2 * y2;
  y0 -= d * x0; y1 -= d * x1; y2 -= d * x2;
  const float ny = sqrtf(y0 * y0 + y1 * y1 + y2 * y2);
  y0 /= ny; y1 /= ny; y2 /= ny;
  P[0] = x0; P[3] = x1; P[6] = x2;
  P[1] = y0; P[4] = y1; P[7] = y2;
  P[2] = x1 * y2 - x2 * y1;
  P[5] = x2 * y0 - x0 * y2;
  P[8] = x0 * y1 - x1 * y0;
}

__global__ void __launch_bounds__(kThreads, 1)
    pose_opt_kernel(const float* __restrict__ T0, const float* __restrict__ X,
                    const float* __restrict__ obs,
                    const float* __restrict__ isig,
                    const uint8_t* __restrict__ valid, int n, int n_smem,
                    Params p, float* __restrict__ T_out,
                    uint8_t* __restrict__ inl_out,
                    float* __restrict__ chi2_out, int* __restrict__ n_inl_out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float dyn[];
  __shared__ float red[kWarps][32];
  __shared__ float part[2][32];  // this CTA's sums, by iteration parity
  __shared__ int count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int g = static_cast<int>(cluster.block_rank()) * nthreads + tid;
  const int stride = n_cta * nthreads;
  Stage st(dyn, n_smem);
#ifdef POSE_OPT_CLOCKS
  const bool timer = g == 0;
  unsigned long long clk[kPhases] = {};
  long long last = 0, ns0 = 0;
#endif

  // every thread: row-major [4, 4] -> 12 scalars, on the SE3 manifold
  float P[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[3 * i + j] = T0[4 * i + j];
    P[9 + i] = T0[4 * i + 3];
  }
  so3_project(P);
  if (tid == 0) count = 0;
  // stage the observations o = g + k * stride: k = 0 in registers, the
  // next ones in this CTA's shared memory (slot (k-1) * nthreads + tid)
  // while it lasts, the rest stay in global memory
  const bool has0 = g < n;
  Obs r0{};
  bool inl0 = true;
  if (has0) r0 = load_obs(X, obs, isig, valid, g);
  for (int o = g + stride, s = tid; o < n; o += stride, s += nthreads) {
    if (s < n_smem)
      st.put(s, load_obs(X, obs, isig, valid, o));
    else
      inl_out[o] = 1;
  }
  __syncthreads();

  const int n_iters = p.rounds * p.iters_per_round;
#ifdef POSE_OPT_CLOCKS
  ns0 = global_ns();
  last = clock_now();
#endif
  for (int it = 0; it < n_iters; ++it) {
    const bool robust = it < 2 * p.iters_per_round;
    PHASE(7);
    float acc[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) acc[s] = 0.f;
    if (has0) accumulate(P, p, r0, inl0, robust, acc);
    for (int o = g + stride, s = tid; o < n; o += stride, s += nthreads) {
      if (s < n_smem)
        accumulate(P, p, st.get(s), (st.flags[s] & kInlier) != 0, robust, acc);
      else
        accumulate(P, p, load_obs(X, obs, isig, valid, o), inl_out[o] != 0,
                   robust, acc);
    }
    PHASE(0);
    red[warp][lane] = reduce_scatter32(acc, lane);
    PHASE(1);
    // barrier 1: every warp's row is written (and warp 0 read the rows
    // of the iteration before, before the last cluster barrier)
    __syncthreads();
    float* mine = part[it & 1];
    if (warp == 0) {
      float t = 0.f;
      for (int w = 0; w < nwarps; ++w) t += red[w][lane];
      mine[lane] = t;
    }
    PHASE(2);
    // barrier 2: every CTA's sums of this iteration are written, and
    // nobody reads those of the iteration before last any more (a
    // cluster of one CTA needs only the CTA's barrier, ~20x cheaper)
    if (n_cta > 1)
      cluster.sync();
    else
      __syncthreads();
    PHASE(3);
    // every thread: sum `lane` of the cluster, in rank order, then all
    // 27 sums by broadcast; the loads are issued before the adds
    float v[kMaxCluster];
    v[0] = n_cta > 1 ? cluster.map_shared_rank(mine, 0)[lane] : mine[lane];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      v[r] = r < n_cta ? cluster.map_shared_rank(mine, r)[lane] : 0.f;
    float t = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n_cta) t += v[r];
    float total[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) total[s] = __shfl_sync(0xffffffffu, t, s);
    PHASE(4);
    float dx[6];
    ldl6_solve(total, p.damping, dx);
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) finite = finite && isfinite(dx[i]);
    if (!finite) {
#pragma unroll
      for (int i = 0; i < 6; ++i) dx[i] = 0.f;
    }
    PHASE(5);
    se3_exp_left_mul(dx, P);
    PHASE(6);

    if ((it + 1) % p.iters_per_round == 0) {
      // round boundary: each thread reclassifies its own observations
      if (has0) inl0 = is_inlier(P, p, r0);
      for (int o = g + stride, s = tid; o < n; o += stride, s += nthreads) {
        if (s < n_smem) {
          const bool in = is_inlier(P, p, st.get(s));
          st.flags[s] = (st.flags[s] & kValid) | (in ? kInlier : 0);
        } else {
          inl_out[o] = is_inlier(P, p, load_obs(X, obs, isig, valid, o));
        }
      }
    }
  }
  PHASE(7);
#ifdef POSE_OPT_CLOCKS
  if (timer) {
    g_clocks[kPhases] = global_ns() - ns0;
    for (int i = 0; i < kPhases; ++i) g_clocks[i] = clk[i];
  }
#endif

  // the final pose back on the manifold (in every thread, alike); chi2
  // from it; inliers & valid
  so3_project(P);
  if (g == 0) {
    const float vals[16] = {P[0], P[1], P[2], P[9],  P[3], P[4],
                            P[5], P[10], P[6], P[7], P[8], P[11],
                            0.f,  0.f,  0.f,  1.f};
    for (int k = 0; k < 16; ++k) T_out[k] = vals[k];
  }
  int n_mine = 0;
  if (has0) {
    chi2_out[g] = residual(P, p, r0).chi2;
    const bool in = inl0 && r0.valid;
    inl_out[g] = in;
    n_mine += in;
  }
  for (int o = g + stride, s = tid; o < n; o += stride, s += nthreads) {
    const Obs b = s < n_smem ? st.get(s) : load_obs(X, obs, isig, valid, o);
    chi2_out[o] = residual(P, p, b).chi2;
    const bool was = s < n_smem ? (st.flags[s] & kInlier) != 0 : inl_out[o] != 0;
    const bool in = was && b.valid;
    inl_out[o] = in;
    n_mine += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_mine += __shfl_xor_sync(0xffffffffu, n_mine, off);
  if (lane == 0) atomicAdd(&count, n_mine);
  cluster.sync();  // every CTA's count is in
  if (g == 0) {
    int c = 0;
    for (int r = 0; r < n_cta; ++r) c += *cluster.map_shared_rank(&count, r);
    *n_inl_out = c;
  }
  cluster.sync();  // no CTA leaves while its shared memory may be read
}

}  // namespace

// T0 [16] row-major pose, X [n, 3], obs [n, 3] (u, v, u_r; u_r < 0 =
// mono), isig [n] float32, valid [n] bool (one byte, 0 or 1); outputs
// T_out [16] row-major, inl [n] bool (inliers AND valid), chi2 [n]
// float32, n_inl [1] int32. All contiguous on the current device; one
// launch, nothing else.
extern "C" int pose_opt(const float* T0, const float* X, const float* obs,
                        const float* isig, const uint8_t* valid, int n,
                        float fx, float fy, float cx, float cy, float bf,
                        float chi2_mono, float chi2_stereo, float huber_mono,
                        float huber_stereo, float damping, int rounds,
                        int iters_per_round, float* T_out, uint8_t* inl,
                        float* chi2_out, int* n_inl, void* stream) {
  // opt in to the dynamic shared memory, once per device
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices || !attr_set[device]) {
    e = cudaFuncSetAttribute(pose_opt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemObs * kObsBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < kMaxDevices) attr_set[device] = true;
  }
  const Params p{fx,          fy,         cx,           cy,
                 bf,          chi2_mono,  chi2_stereo,  huber_mono,
                 huber_stereo, damping,   rounds,       iters_per_round};
  // one observation per thread where O allows: up to kMaxCluster CTAs
  // of up to kThreads threads, in whole warps
  const int n_cta = n > kThreads * kMaxCluster ? kMaxCluster
                    : n > kThreads               ? (n + kThreads - 1) / kThreads
                                                 : 1;
  const int per_cta = (n + n_cta - 1) / n_cta;
  const int threads = per_cta >= kThreads ? kThreads
                      : per_cta > 0        ? (per_cta + 31) / 32 * 32
                                           : 32;
  const int stride = n_cta * threads;
  const int later = n > stride ? (n - 1) / stride : 0;  // passes after the first
  const int n_smem = later * threads < kSmemObs ? later * threads : kSmemObs;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cta);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_smem) * kObsBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pose_opt_kernel, T0, X, obs, isig, valid, n,
                         n_smem, p, T_out, inl, chi2_out, n_inl);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifdef POSE_OPT_CLOCKS
// The phase cycles of the last launch (kPhases of them, see PHASE) and
// its iterations' nanoseconds, into host memory; synchronizes the device.
extern "C" int pose_opt_clocks(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks)));
}
#endif
