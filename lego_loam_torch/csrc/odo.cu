// The scan-to-scan odometry's Gauss-Newton trip, one block a launch.
//
// Replaces no Pallas kernel: the JAX package leaves a trip's arithmetic to
// XLA, which fuses it. In PyTorch the same arithmetic ran as ~1,100 tiny
// kernels a trip (`odometry._solve_stage_plain`, its plain twin), 40 trips a
// scan, each kernel ~1.2 us of launch for a few thousand float operations.
//
// A stage (surf: roll, pitch, tz against the ground surfs; corner: yaw, tx,
// ty against the less-sharp corners; or all six DOFs) is:
//   odo_begin   copy the warm start into the state, warp the query by it;
//   20 x [K2 (csrc/knn.cu) on the warped query, then odo_trip];
//   odo_end     the stage-level trust region around the warm start.
// One trip, in one block of 512 threads, each thread its own query points:
//   1. fit: where the device flag `need` is set, gather each point's five
//      neighbours from K2's indices, fit the line (corner) or the plane
//      (surf) by the closed-form 3x3 eigensolver (float32), apply the
//      distance, ratio, coplanarity and normal-z gates, and cache the fit
//      (and R_ref, t_ref); otherwise keep the cache;
//   2. residuals and the robust weights' mean |residual| (a block sum), then
//      the Jacobian rows and H = J^T J, g = J^T (d w) and the count of w > 0
//      (a block sum);
//   3. one thread: the eigenproblem in float64 (closed form for 3 DOFs,
//      6 sweeps of cyclic Jacobi for 6), the degeneracy gate, the step and
//      its clamps, exp/compose, the convergence and refresh tests, the
//      sticky `done` (R, t frozen once set) and the useful-trip count;
//   4. warp the query by the new pose for the next trip's K2.
// No host read: `need` and `done` live on the device, so a stage is one
// stretch of a CUDA graph.
//
// Bound on this card: a trip reads the query (17 B a point), K2's lists
// (40 B), the five neighbours (60 B) and the warped query (12 B), and
// writes the fit cache (32 B) and the warped query (12 B): 173 B a point,
// ~0.1 us for 2,048 points at 3.35 TB/s. The float work (a few hundred operations a point)
// is as small. So a trip is bound by its own latency: the serial float64
// solve, two block reductions and the dependent chains of each point.
// The design keeps everything in one block so that nothing but K2 stands
// between two trips, and uses 512 threads so each thread has 4 points of
// 2,048.
//
// Arithmetic: float32 where the twin uses float32, float64 for the
// eigenproblem, the plain math functions (no fast math). The fits repeat the
// twin's operations as PyTorch runs them on the card, rounding for rounding:
// the source is built with --fmad=false (each PyTorch kernel rounds its one
// operation), a division by a Python number is a product with its float
// reciprocal (PyTorch's `div` by a CPU scalar), `number / tensor` is
// `reciprocal(tensor) * number` (`Tensor.__rtruediv__`), and the five-term
// sums and means add in the order of PyTorch's reduction kernel (`sum5_*`).
// That matters: five neighbours along one ring are nearly collinear, their
// plane normal is ill-conditioned, and a last-bit difference in the scatter
// tilts it by degrees. Given the same K2 lists the cache is then the twin's,
// bit for bit, and the step differs only by the order of the block sums,
// which the Gauss-Newton loop does not amplify. Every sum runs in a fixed
// order (per thread over its points in order, a shuffle tree within each
// warp, the warps in order): no atomics, and two runs of the same input give
// the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;
constexpr int kFit = 8;  // floats a query point in the fit cache
constexpr int kSurf = 0, kCorner = 1;

// state (float32): the pose, the refresh reference, the warm start and the
// stage's result; flags (int32): need, done, useful trips
enum { S_R = 0, S_T = 9, S_RREF = 12, S_TREF = 21, S_MR = 24, S_MT = 33, S_ROUT = 36, S_TOUT = 45 };
enum { F_NEED = 0, F_DONE = 1, F_USEFUL = 2 };

// The stage's settings, in the order of `odometry._odo_params`.
struct Params {
  float max_d2, line_ratio, plane_tol, normal_min_z, slope, slope25, weight_min, eigen_thr, step_scale,
      rot_cap, trans_cap, rot_conv, trans_conv, refresh_thr, refresh_trans, cap_rot, cap_trans, min_corr;
};

struct Dofs {
  int idx[6];
};

struct WarpParams {
  float kx, ky, kz, theta, vx, vy, vz, safe;
};

__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float macos(float x) { return acosf(x); }
__device__ __forceinline__ double macos(double x) { return acos(x); }
__device__ __forceinline__ float mcos(float x) { return cosf(x); }
__device__ __forceinline__ double mcos(double x) { return cos(x); }
// torch.clamp's one-sided forms (a NaN passes through)
template <class T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <class T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

__device__ __forceinline__ float norm3(float x, float y, float z) { return sqrtf(x * x + y * y + z * z); }

// PyTorch's reduction order for five terms (ATen/native/cuda/Reduce.cuh,
// vt0 = 4 accumulators a thread):
// - over a strided dimension, one thread adds all five: e0+e4 in the first
//   accumulator, then the accumulators in order;
__device__ __forceinline__ float sum5_strided(const float (&e)[5]) { return (((e[0] + e[4]) + e[1]) + e[2]) + e[3]; }
// - over the contiguous last dimension, four lanes (e0+e4, e1, e2, e3)
//   combined by a shuffle tree of offsets 2, then 1.
__device__ __forceinline__ float sum5_lanes(const float (&e)[5]) { return ((e[0] + e[4]) + e[2]) + (e[1] + e[3]); }
// `mean` is the sum times the float factor outputs / inputs (1/5).
constexpr float kMean5 = 0.2f;

// ---- math/linalg3.py: eigenvalues and extreme eigenvectors of a symmetric 3x3

template <class T>
__device__ void eigvals3(T a00, T a01, T a02, T a11, T a12, T a22, T& lo, T& mid, T& hi) {
  const T eps = T(1e-12);
  const T p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const T q = (a00 + a11 + a22) * (T(1) / T(3));
  const T d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const T p2 = d0 * d0 + d1 * d1 + d2 * d2 + T(2) * p1;
  if (p2 <= eps) {  // near-diagonal / repeated eigenvalues: the sorted diagonal
    lo = a00 < a11 ? a00 : a11;
    lo = lo < a22 ? lo : a22;
    hi = a00 > a11 ? a00 : a11;
    hi = hi > a22 ? hi : a22;
    mid = a00 + a11 + a22 - lo - hi;
    return;
  }
  const T p = msqrt(clamp_min(p2 * (T(1) / T(6)), eps));
  const T b00 = d0 / p, b11 = d1 / p, b22 = d2 / p;
  const T b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const T detB = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) + b02 * (b01 * b12 - b11 * b02);
  const T r = clamp_max(clamp_min(detB * T(0.5), T(-1)), T(1));
  const T phi = macos(r) * (T(1) / T(3));
  hi = q + T(2) * p * mcos(phi);
  lo = q + T(2) * p * mcos(phi + T(2.0 * kPi / 3.0));
  mid = T(3) * q - hi - lo;
}

// Unit eigenvector of the eigenvalue not in (la, lb): the largest-norm
// column of (A - la I)(A - lb I); (1, 0, 0) where that column vanishes.
template <class T>
__device__ void eigvec_extreme(T a00, T a01, T a02, T a11, T a12, T a22, T la, T lb, T& vx, T& vy, T& vz) {
  const T b00 = a00 - la, b11 = a11 - la, b22 = a22 - la;
  const T c00 = a00 - lb, c11 = a11 - lb, c22 = a22 - lb;
  const T m00 = b00 * c00 + a01 * a01 + a02 * a02;
  const T m10 = a01 * c00 + b11 * a01 + a12 * a02;
  const T m20 = a02 * c00 + a12 * a01 + b22 * a02;
  const T m01 = b00 * a01 + a01 * c11 + a02 * a12;
  const T m11 = a01 * a01 + b11 * c11 + a12 * a12;
  const T m21 = a02 * a01 + a12 * c11 + b22 * a12;
  const T m02 = b00 * a02 + a01 * a12 + a02 * c22;
  const T m12 = a01 * a02 + b11 * a12 + a12 * c22;
  const T m22 = a02 * a02 + a12 * a12 + b22 * c22;
  const T n0 = m00 * m00 + m10 * m10 + m20 * m20;
  const T n1 = m01 * m01 + m11 * m11 + m21 * m21;
  const T n2 = m02 * m02 + m12 * m12 + m22 * m22;
  const bool use1 = n1 >= n0 && n1 >= n2;
  const bool use2 = n2 > n0 && n2 > n1 && !use1;
  const T x = use2 ? m02 : (use1 ? m01 : m00);
  const T y = use2 ? m12 : (use1 ? m11 : m10);
  const T z = use2 ? m22 : (use1 ? m21 : m20);
  const T nn = msqrt(x * x + y * y + z * z);
  if (nn > T(1e-9)) {
    const T inv = T(1) / clamp_min(nn, T(1e-12));
    vx = x * inv;
    vy = y * inv;
    vz = z * inv;
  } else {
    vx = T(1);
    vy = T(0);
    vz = T(0);
  }
}

// eigh3x3 in float64: evals ascending, evecs[i][k] the i-th component of
// the k-th eigenvector (the middle one by orthogonality)
__device__ void eigh3(const double (&A)[3][3], double (&ev)[3], double (&V)[3][3]) {
  const double a00 = A[0][0], a01 = A[0][1], a02 = A[0][2], a11 = A[1][1], a12 = A[1][2], a22 = A[2][2];
  double lo, mid, hi;
  eigvals3(a00, a01, a02, a11, a12, a22, lo, mid, hi);
  double lx, ly, lz, hx, hy, hz;
  eigvec_extreme(a00, a01, a02, a11, a12, a22, mid, hi, lx, ly, lz);
  eigvec_extreme(a00, a01, a02, a11, a12, a22, lo, mid, hx, hy, hz);
  double mx = hy * lz - hz * ly, my = hz * lx - hx * lz, mz = hx * ly - hy * lx;
  const double n = sqrt(mx * mx + my * my + mz * mz);
  if (n > 1e-9) {
    const double inv = 1.0 / clamp_min(n, 1e-12);
    mx *= inv;
    my *= inv;
    mz *= inv;
  } else {
    eigvec_extreme(a00, a01, a02, a11, a12, a22, lo, hi, mx, my, mz);
  }
  ev[0] = lo;
  ev[1] = mid;
  ev[2] = hi;
  V[0][0] = lx; V[0][1] = mx; V[0][2] = hx;
  V[1][0] = ly; V[1][1] = my; V[1][2] = hy;
  V[2][0] = lz; V[2][1] = mz; V[2][2] = hz;
}

// math/jacobi.py at n = 6: 6 sweeps of the round-robin order, each round's
// three disjoint rotations computed from the matrix before the round and
// applied as A <- G^T A G, V <- V G; then the diagonal sorted ascending.
__constant__ int kRounds[5][3][2] = {
    {{0, 5}, {1, 4}, {2, 3}}, {{0, 4}, {3, 5}, {1, 2}}, {{0, 3}, {2, 4}, {1, 5}},
    {{0, 2}, {1, 3}, {4, 5}}, {{0, 1}, {2, 5}, {3, 4}},
};

__device__ void jacobi6(double (&a)[6][6], double (&ev)[6], double (&V)[6][6]) {
  double v[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 6; ++sweep) {
    for (int r = 0; r < 5; ++r) {
      double c[3], s[3];
      for (int k = 0; k < 3; ++k) {
        const int p = kRounds[r][k][0], q = kRounds[r][k][1];
        const double apq = a[p][q];
        const bool live = apq != 0.0;
        const double th = (a[q][q] - a[p][p]) / (2.0 * (live ? apq : 1.0));
        const double t = live ? (th >= 0.0 ? 1.0 : -1.0) / (fabs(th) + sqrt(th * th + 1.0)) : 0.0;
        c[k] = rsqrt(t * t + 1.0);
        s[k] = t * c[k];
      }
      for (int k = 0; k < 3; ++k) {  // rows: G^T A
        const int p = kRounds[r][k][0], q = kRounds[r][k][1];
        for (int j = 0; j < 6; ++j) {
          const double ap = a[p][j], aq = a[q][j];
          a[p][j] = c[k] * ap - s[k] * aq;
          a[q][j] = s[k] * ap + c[k] * aq;
        }
      }
      for (int k = 0; k < 3; ++k) {  // columns: (G^T A) G and V G
        const int p = kRounds[r][k][0], q = kRounds[r][k][1];
        for (int i = 0; i < 6; ++i) {
          const double ap = a[i][p], aq = a[i][q];
          a[i][p] = c[k] * ap - s[k] * aq;
          a[i][q] = s[k] * ap + c[k] * aq;
          const double vp = v[i][p], vq = v[i][q];
          v[i][p] = c[k] * vp - s[k] * vq;
          v[i][q] = s[k] * vp + c[k] * vq;
        }
      }
    }
  }
  int order[6];
  for (int k = 0; k < 6; ++k) {  // stable insertion sort of the diagonal
    int j = k;
    while (j > 0 && a[order[j - 1]][order[j - 1]] > a[k][k]) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = k;
  }
  for (int k = 0; k < 6; ++k) {
    ev[k] = a[order[k]][order[k]];
    for (int i = 0; i < 6; ++i) V[i][k] = v[i][order[k]];
  }
}

// ---- math/se3.py in float32, row-major 3x3

__device__ void matmul3(const float* A, const float* B, float* C) {
  float out[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
  for (int k = 0; k < 9; ++k) C[k] = out[k];
}

__device__ void matvec3(const float* A, const float* x, float* y) {
  float out[3];
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
  y[0] = out[0];
  y[1] = out[1];
  y[2] = out[2];
}

__device__ void hat(float x, float y, float z, float* K) {
  K[0] = 0.f; K[1] = -z; K[2] = y;
  K[3] = z; K[4] = 0.f; K[5] = -x;
  K[6] = -y; K[7] = x; K[8] = 0.f;
}

// I + a K + b K K; with a small-angle form where theta <= 1e-7
__device__ void rodrigues(const float* w, bool jacobian, float* out) {
  const float theta = norm3(w[0], w[1], w[2]);
  float K[9], KK[9];
  if (theta > 1e-7f) {
    const float d = clamp_min(theta, 1e-9f);
    hat(w[0] / d, w[1] / d, w[2] / d, K);
    float a, b;
    if (jacobian) {  // left Jacobian: A = (1 - cos)/theta, B = (theta - sin)/theta
      a = (1.f - cosf(theta)) / clamp_min(theta, 1e-9f);
      b = (theta - sinf(theta)) / clamp_min(theta, 1e-9f);
    } else {
      a = sinf(theta);
      b = 1.f - cosf(theta);
    }
    matmul3(K, K, KK);
    for (int k = 0; k < 9; ++k) out[k] = ((k % 4 == 0) ? 1.f : 0.f) + a * K[k] + b * KK[k];
  } else {
    hat(w[0], w[1], w[2], K);
    if (jacobian) {  // I + 0.5 hat(w)
      for (int k = 0; k < 9; ++k) out[k] = ((k % 4 == 0) ? 1.f : 0.f) + 0.5f * K[k];
    } else {  // I + K + 0.5 K K
      matmul3(K, K, KK);
      for (int k = 0; k < 9; ++k) out[k] = ((k % 4 == 0) ? 1.f : 0.f) + K[k] + 0.5f * KK[k];
    }
  }
}

__device__ void exp_se3(const float* xi, float* R, float* t) {
  float J[9];
  rodrigues(xi, false, R);
  rodrigues(xi, true, J);
  matvec3(J, xi + 3, t);
}

__device__ void log_so3(const float* R, float* w) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_t = clamp_max(clamp_min((tr - 1.f) * 0.5f, -1.f), 1.f);
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const float sin_tv = clamp_max(clamp_min(0.5f * norm3(v[0], v[1], v[2]), 0.f), 1.f);
  // arccos is ill-conditioned at both ends: atan2 away from pi, pi - arcsin near it
  const float theta = cos_t < -0.7f ? static_cast<float>(kPi) - asinf(sin_tv) : atan2f(sin_tv, cos_t);
  const float sin_t = sinf(theta);
  const float scale = fabsf(sin_t) > 1e-6f ? theta / clamp_min(2.f * sin_t, 1e-9f) : 0.5f;
  if (cos_t < static_cast<float>(-1.0 + 1e-4)) {  // near pi: the axis from the diagonal
    for (int i = 0; i < 3; ++i) {
      const float axis = sqrtf(clamp_min((R[4 * i] - cos_t) / (1.f - cos_t + 1e-9f), 0.f));
      const float sgn = v[i] < 0.f ? -1.f : 1.f;
      w[i] = axis * sgn * theta;
    }
  } else {
    for (int i = 0; i < 3; ++i) w[i] = v[i] * scale;
  }
}

__device__ void inverse3(const float* A, float* B) {
  const float c00 = A[4] * A[8] - A[5] * A[7];
  const float c01 = A[5] * A[6] - A[3] * A[8];
  const float c02 = A[3] * A[7] - A[4] * A[6];
  const float inv = 1.f / (A[0] * c00 + A[1] * c01 + A[2] * c02);
  B[0] = c00 * inv;
  B[1] = (A[2] * A[7] - A[1] * A[8]) * inv;
  B[2] = (A[1] * A[5] - A[2] * A[4]) * inv;
  B[3] = c01 * inv;
  B[4] = (A[0] * A[8] - A[2] * A[6]) * inv;
  B[5] = (A[2] * A[3] - A[0] * A[5]) * inv;
  B[6] = c02 * inv;
  B[7] = (A[1] * A[6] - A[0] * A[7]) * inv;
  B[8] = (A[0] * A[4] - A[1] * A[3]) * inv;
}

__device__ void log_se3(const float* R, const float* t, float* xi) {
  float J[9], Jinv[9];
  log_so3(R, xi);
  rodrigues(xi, true, J);
  inverse3(J, Jinv);
  matvec3(Jinv, t, xi + 3);
}

// ---- odometry.warp_points: q = exp(s log M) p, the angle scaled by s

__device__ WarpParams warp_params(const float* R, const float* t) {
  float xi[6];
  log_se3(R, t, xi);
  WarpParams P;
  P.theta = norm3(xi[0], xi[1], xi[2]);
  P.safe = P.theta > 1e-9f ? 1.f : 0.f;
  const float d = clamp_min(P.theta, 1e-12f);
  P.kx = xi[0] / d * P.safe;
  P.ky = xi[1] / d * P.safe;
  P.kz = xi[2] / d * P.safe;
  P.vx = xi[3];
  P.vy = xi[4];
  P.vz = xi[5];
  return P;
}

__device__ __forceinline__ void warp_point(const WarpParams& P, const float* p, float s, float* out) {
  const float kx = P.kx, ky = P.ky, kz = P.kz;
  const float px = p[0], py = p[1], pz = p[2];
  const float th = s * P.theta;
  const float ct = cosf(th), st = sinf(th);
  const float kdotp = kx * px + ky * py + kz * pz;
  const float cx = ky * pz - kz * py, cy = kz * px - kx * pz, cz = kx * py - ky * px;
  const float one_ct = 1.f - ct;
  const float rx = px * ct + cx * st + kx * kdotp * one_ct;
  const float ry = py * ct + cy * st + ky * kdotp * one_ct;
  const float rz = pz * ct + cz * st + kz * kdotp * one_ct;
  // t(s) = J_l(s w)(s v) = x + A (k x x) + B (k (k.x) - x), sign-preserving divide
  const float svx = s * P.vx, svy = s * P.vy, svz = s * P.vz;
  const float den = fabsf(th) > 1e-12f ? th : 1.f;
  const float A = one_ct / den * P.safe;
  const float B = (th - st) / den * P.safe;
  const float kxsx = ky * svz - kz * svy, kxsy = kz * svx - kx * svz, kxsz = kx * svy - ky * svx;
  const float kdots = kx * svx + ky * svy + kz * svz;
  out[0] = rx + (svx + A * kxsx + B * (kx * kdots - svx));
  out[1] = ry + (svy + A * kxsy + B * (ky * kdots - svy));
  out[2] = rz + (svz + A * kxsz + B * (kz * kdots - svz));
}

__device__ void warp_query(const WarpParams& P, const float* __restrict__ xyz, const float* __restrict__ rel,
                           int Q, float* __restrict__ qw) {
  for (int i = threadIdx.x; i < Q; i += kThreads) warp_point(P, xyz + 3 * i, rel[i], qw + 3 * i);
}

// ---- step 1: the fits (odometry.corner_fit5 / surf_fit5 and their gates)

template <int KIND>
__device__ void fit_point(const Params& p, int i, const uint8_t* __restrict__ mask, const float* __restrict__ target,
                          const int* __restrict__ idx, const float* __restrict__ d5, float* __restrict__ fit) {
  float nx[5], ny[5], nz[5];
  for (int k = 0; k < 5; ++k) {
    const int j = max(idx[5 * i + k], 0);
    nx[k] = target[3 * j];
    ny[k] = target[3 * j + 1];
    nz[k] = target[3 * j + 2];
  }
  bool ok = mask[i] != 0 && d5[5 * i + 4] < p.max_d2;
  // the centre: a mean over the strided neighbour dimension of (Q, 5, 3)
  const float cx = sum5_strided(nx) * kMean5;
  const float cy = sum5_strided(ny) * kMean5;
  const float cz = sum5_strided(nz) * kMean5;
  // the six products of the centred neighbours, summed over the last dimension of (Q, 5)
  float pxx[5], pxy[5], pxz[5], pyy[5], pyz[5], pzz[5];
  for (int k = 0; k < 5; ++k) {
    const float dx = nx[k] - cx, dy = ny[k] - cy, dz = nz[k] - cz;
    pxx[k] = dx * dx;
    pxy[k] = dx * dy;
    pxz[k] = dx * dz;
    pyy[k] = dy * dy;
    pyz[k] = dy * dz;
    pzz[k] = dz * dz;
  }
  float s00 = sum5_lanes(pxx), s01 = sum5_lanes(pxy), s02 = sum5_lanes(pxz);
  float s11 = sum5_lanes(pyy), s12 = sum5_lanes(pyz), s22 = sum5_lanes(pzz);
  float* f = fit + kFit * i;
  if (KIND == kCorner) {  // covariance (mean of products): largest eigenvector, ratio hi/mid
    s00 *= kMean5; s01 *= kMean5; s02 *= kMean5; s11 *= kMean5; s12 *= kMean5; s22 *= kMean5;
    float lo, mid, hi, vx, vy, vz;
    eigvals3(s00, s01, s02, s11, s12, s22, lo, mid, hi);
    eigvec_extreme(s00, s01, s02, s11, s12, s22, lo, mid, vx, vy, vz);
    ok = ok && hi / clamp_min(mid, 1e-9f) > p.line_ratio;
    f[0] = cx; f[1] = cy; f[2] = cz; f[3] = vx; f[4] = vy; f[5] = vz;
  } else {  // scatter (sum of products): smallest eigenvector, plane offset, largest deviation
    float lo, mid, hi, gx, gy, gz;
    eigvals3(s00, s01, s02, s11, s12, s22, lo, mid, hi);
    eigvec_extreme(s00, s01, s02, s11, s12, s22, mid, hi, gx, gy, gz);
    const float d_off = -(gx * cx + gy * cy + gz * cz);
    float dev = 0.f;
    for (int k = 0; k < 5; ++k) dev = fmaxf(dev, fabsf(gx * nx[k] + gy * ny[k] + gz * nz[k] + d_off));
    ok = ok && dev < p.plane_tol;
    if (p.normal_min_z > 0.f) ok = ok && fabsf(gz) >= p.normal_min_z;
    f[0] = gx; f[1] = gy; f[2] = gz; f[3] = d_off;
  }
  f[7] = ok ? 1.f : 0.f;
}

// ---- step 2: residual, gradient direction n and weight of one point

template <int KIND>
__device__ __forceinline__ float residual(const float* f, const float* q, float* n) {
  if (KIND == kCorner) {  // |(q - c) x v|; n = v x unit(cross)
    const float px = q[0] - f[0], py = q[1] - f[1], pz = q[2] - f[2];
    const float vx = f[3], vy = f[4], vz = f[5];
    const float crx = py * vz - pz * vy, cry = pz * vx - px * vz, crz = px * vy - py * vx;
    const float dist = sqrtf(crx * crx + cry * cry + crz * crz);
    if (n) {
      const float inv = 1.f / clamp_min(dist, 1e-12f);
      const float ux = crx * inv, uy = cry * inv, uz = crz * inv;
      n[0] = vy * uz - vz * uy;
      n[1] = vz * ux - vx * uz;
      n[2] = vx * uy - vy * ux;
    }
    return dist;
  }
  if (n) {  // plane: g . q + d_off, n = g
    n[0] = f[0];
    n[1] = f[1];
    n[2] = f[2];
  }
  return f[0] * q[0] + f[1] * q[1] + f[2] * q[2] + f[3];
}

// Sum v over the block in a fixed order: a shuffle tree in each warp, then
// the warps in order. Every thread gets the sums in out.
template <int N>
__device__ void block_sum(float (&v)[N], float* red /* [kWarps * N] */, float* out /* [N] */) {
  for (int o = 16; o > 0; o >>= 1)
    for (int j = 0; j < N; ++j) v[j] += __shfl_down_sync(kFull, v[j], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- step 3: odometry._gn_step on the reduced sums (one thread)

template <int K>
__device__ void gn_step(const float* sums, const Dofs& dofs, const Params& p, float (&delta)[6], float& rot_deg,
                        float& trans_cm) {
  constexpr int NH = K * (K + 1) / 2;
  double A[K][K];
  for (int a = 0, m = 0; a < K; ++a)
    for (int b = a; b < K; ++b, ++m) A[a][b] = A[b][a] = static_cast<double>(sums[m]);
  double evd[K], Vd[K][K];
  if constexpr (K == 3) {
    eigh3(A, evd, Vd);
  } else {
    jacobi6(A, evd, Vd);
  }
  float proj[K];
  for (int k = 0; k < K; ++k) {  // (V^T g) / lambda, degenerate directions dropped
    const float ev = static_cast<float>(evd[k]);
    float x = 0.f;
    for (int i = 0; i < K; ++i) x += static_cast<float>(Vd[i][k]) * sums[NH + i];
    const float ginv = ev > 1e-12f ? 1.f / clamp_min(ev, 1e-12f) : 0.f;
    proj[k] = x * ginv * (ev >= p.eigen_thr ? 1.f : 0.f);
  }
  const bool enough = sums[NH + K] >= p.min_corr;
  for (int j = 0; j < 6; ++j) delta[j] = 0.f;
  for (int i = 0; i < K; ++i) {
    float x = 0.f;
    for (int k = 0; k < K; ++k) x += static_cast<float>(Vd[i][k]) * proj[k];
    delta[dofs.idx[i]] = enough ? -x * p.step_scale : 0.f;
  }
  const float rot_n = norm3(delta[0], delta[1], delta[2]);
  const float trans_n = norm3(delta[3], delta[4], delta[5]);
  const float scale = fminf(clamp_max((1.f / clamp_min(rot_n, 1e-12f)) * p.rot_cap, 1.f),
                            clamp_max((1.f / clamp_min(trans_n, 1e-12f)) * p.trans_cap, 1.f));
  for (int j = 0; j < 6; ++j) delta[j] *= scale;
  rot_deg = norm3(delta[0], delta[1], delta[2]) * 180.f * (1.f / static_cast<float>(kPi));
  trans_cm = norm3(delta[3], delta[4], delta[5]) * 100.f;
}

// ---- the kernels

__global__ void __launch_bounds__(kThreads) odo_begin_kernel(const float* __restrict__ m_r,
                                                             const float* __restrict__ m_t,
                                                             const float* __restrict__ xyz,
                                                             const float* __restrict__ rel, int Q,
                                                             float* __restrict__ st, int* __restrict__ flags,
                                                             float* __restrict__ qw) {
  __shared__ WarpParams wp;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) st[S_R + k] = st[S_RREF + k] = st[S_MR + k] = m_r[k];
    for (int k = 0; k < 3; ++k) st[S_T + k] = st[S_TREF + k] = st[S_MT + k] = m_t[k];
    flags[F_NEED] = 1;  // the first trip always searches
    flags[F_DONE] = 0;
    flags[F_USEFUL] = 0;
    wp = warp_params(m_r, m_t);
  }
  __syncthreads();
  warp_query(wp, xyz, rel, Q, qw);
}

template <int KIND, int K>
__global__ void __launch_bounds__(kThreads) odo_trip_kernel(Params p, Dofs dofs, const float* __restrict__ xyz,
                                                            const float* __restrict__ rel,
                                                            const uint8_t* __restrict__ mask, int Q,
                                                            const float* __restrict__ target,
                                                            const int* __restrict__ idx,
                                                            const float* __restrict__ d5, float* __restrict__ fit,
                                                            float* __restrict__ st, int* __restrict__ flags,
                                                            float* __restrict__ qw) {
  constexpr int NH = K * (K + 1) / 2;
  constexpr int NR = NH + K + 1;  // H's upper triangle, g, the count of w > 0
  __shared__ float red[kWarps * NR];
  __shared__ float tot[NR];
  __shared__ int need;
  __shared__ WarpParams wp;
  if (threadIdx.x == 0) need = flags[F_NEED];
  __syncthreads();

  // 1. refresh the fits where the pose moved since the last search
  if (need) {
    for (int i = threadIdx.x; i < Q; i += kThreads) fit_point<KIND>(p, i, mask, target, idx, d5, fit);
    if (threadIdx.x == 0)
      for (int k = 0; k < 12; ++k) st[S_RREF + k] = st[S_R + k];
  }

  // 2a. the robust weights' scale: mean of min(|residual|, 1) over the kept points
  // (each thread reads back only the cache entries it wrote)
  float s1[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    const float* f = fit + kFit * i;
    if (f[7] != 0.f) {
      const float a = fabsf(residual<KIND>(f, qw + 3 * i, nullptr));
      s1[0] += a > 1.f ? 1.f : a;
      s1[1] += 1.f;
    }
  }
  block_sum<2>(s1, red, tot);
  const float slope = p.slope;
  const float scale = clamp_min(p.slope25 * (tot[0] / clamp_min(tot[1], 1.f)), 1.f);
  const float coef = (1.f / scale) * slope;

  // 2b. Jacobian rows, H = J^T J, g = J^T (d w), count of w > 0
  float s2[NR];
  for (int j = 0; j < NR; ++j) s2[j] = 0.f;
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    const float* f = fit + kFit * i;
    const float* q = qw + 3 * i;
    float n[3];
    const float d = residual<KIND>(f, q, n);
    const float s = 1.f - coef * fabsf(d);
    bool use = f[7] != 0.f && s > p.weight_min;
    if (KIND == kCorner) use = use && d > 1e-9f;
    const float w = use ? s : 0.f;
    const float cols[6] = {q[1] * n[2] - q[2] * n[1], q[2] * n[0] - q[0] * n[2], q[0] * n[1] - q[1] * n[0],
                           n[0], n[1], n[2]};
    float J[K];
    for (int k = 0; k < K; ++k) {
      float c = cols[0];
      for (int j = 1; j < 6; ++j) c = dofs.idx[k] == j ? cols[j] : c;
      J[k] = c * w;
    }
    const float dw = d * w;
    for (int a = 0, m = 0; a < K; ++a)
      for (int b = a; b < K; ++b, ++m) s2[m] += J[a] * J[b];
    for (int a = 0; a < K; ++a) s2[NH + a] += J[a] * dw;
    s2[NR - 1] += w > 0.f ? 1.f : 0.f;
  }
  block_sum<NR>(s2, red, tot);

  // 3. the step, the pose update and the loop's flags
  if (threadIdx.x == 0) {
    float delta[6], rot_deg, trans_cm;
    gn_step<K>(tot, dofs, p, delta, rot_deg, trans_cm);
    float dR[9], dt[3], R_new[9], t_new[3];
    exp_se3(delta, dR, dt);
    matmul3(dR, st + S_R, R_new);
    matvec3(dR, st + S_T, t_new);
    for (int k = 0; k < 3; ++k) t_new[k] += dt[k];
    const bool converged = rot_deg < p.rot_conv && trans_cm < p.trans_conv;
    // trace(R_ref^T R_new) = 1 + 2 cos(angle between them)
    float tr = 0.f;
    for (int i = 0; i < 3; ++i)
      tr += st[S_RREF + i] * R_new[i] + st[S_RREF + 3 + i] * R_new[3 + i] + st[S_RREF + 6 + i] * R_new[6 + i];
    const bool moved = tr < p.refresh_thr || norm3(t_new[0] - st[S_TREF], t_new[1] - st[S_TREF + 1],
                                                   t_new[2] - st[S_TREF + 2]) > p.refresh_trans;
    const int done = flags[F_DONE];
    if (!done) {  // once converged, the pose stays frozen
      flags[F_USEFUL] += 1;
      for (int k = 0; k < 9; ++k) st[S_R + k] = R_new[k];
      for (int k = 0; k < 3; ++k) st[S_T + k] = t_new[k];
    }
    flags[F_DONE] = done || converged;
    flags[F_NEED] = moved;
    wp = warp_params(st + S_R, st + S_T);
  }
  __syncthreads();

  // 4. the query at the new pose, for the next trip's K2
  warp_query(wp, xyz, rel, Q, qw);
}

// The stage-level trust region: the motion relative to the warm start,
// scaled into the rotation and translation caps.
__global__ void odo_end_kernel(Params p, float* __restrict__ st) {
  const float* MR = st + S_MR;
  const float* Mt = st + S_MT;
  float Rinv[9], tinv[3], dR[9], dt[3], xi[6];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rinv[3 * i + j] = MR[3 * j + i];
  matvec3(Rinv, Mt, tinv);
  for (int k = 0; k < 3; ++k) tinv[k] = -tinv[k];
  matmul3(Rinv, st + S_R, dR);
  matvec3(Rinv, st + S_T, dt);
  for (int k = 0; k < 3; ++k) dt[k] += tinv[k];
  log_se3(dR, dt, xi);
  const float s_cap = fminf(clamp_max((1.f / clamp_min(norm3(xi[0], xi[1], xi[2]), 1e-12f)) * p.cap_rot, 1.f),
                            clamp_max((1.f / clamp_min(norm3(xi[3], xi[4], xi[5]), 1e-12f)) * p.cap_trans, 1.f));
  for (int k = 0; k < 6; ++k) xi[k] *= s_cap;
  float dRc[9], dtc[3];
  exp_se3(xi, dRc, dtc);
  matmul3(MR, dRc, st + S_ROUT);
  matvec3(MR, dtc, st + S_TOUT);
  for (int k = 0; k < 3; ++k) st[S_TOUT + k] += Mt[k];
}

template <int KIND, int K>
cudaError_t launch_trip(const Params& p, const Dofs& d, const float* xyz, const float* rel, const uint8_t* mask,
                        int Q, const float* target, const int* idx, const float* d5, float* fit, float* st,
                        int* flags, float* qw, cudaStream_t s) {
  odo_trip_kernel<KIND, K><<<1, kThreads, 0, s>>>(p, d, xyz, rel, mask, Q, target, idx, d5, fit, st, flags, qw);
  return cudaGetLastError();
}

}  // namespace

// prm: the Params floats on the host (copied into the launch), `odometry._odo_params`.
extern "C" int odo_begin_launch(const void* m_r, const void* m_t, const void* xyz, const void* rel, int Q,
                                void* st, void* flags, void* qw, void* stream) {
  odo_begin_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_r), static_cast<const float*>(m_t), static_cast<const float*>(xyz),
      static_cast<const float*>(rel), Q, static_cast<float*>(st), static_cast<int*>(flags),
      static_cast<float*>(qw));
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 surf, 1 corner; dof_bits: the solved DOFs of (roll, pitch, yaw,
// tx, ty, tz), 3 or 6 of them.
extern "C" int odo_trip_launch(int kind, int dof_bits, const void* prm, const void* xyz, const void* rel,
                               const void* mask, int Q, const void* target, const void* idx, const void* d5,
                               void* fit, void* st, void* flags, void* qw, void* stream) {
  Params p;
  memcpy(&p, prm, sizeof(Params));
  Dofs d = {};
  int K = 0;
  for (int j = 0; j < 6; ++j)
    if (dof_bits >> j & 1) d.idx[K++ % 6] = j;
  if ((K != 3 && K != 6) || (dof_bits >> 6) != 0 || (kind != kSurf && kind != kCorner))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  const float* r = static_cast<const float*>(rel);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* t = static_cast<const float*>(target);
  const int* i = static_cast<const int*>(idx);
  const float* dd = static_cast<const float*>(d5);
  float* f = static_cast<float*>(fit);
  float* s = static_cast<float*>(st);
  int* fl = static_cast<int*>(flags);
  float* q = static_cast<float*>(qw);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == kSurf)
    err = K == 3 ? launch_trip<kSurf, 3>(p, d, x, r, m, Q, t, i, dd, f, s, fl, q, cs)
                 : launch_trip<kSurf, 6>(p, d, x, r, m, Q, t, i, dd, f, s, fl, q, cs);
  else
    err = K == 3 ? launch_trip<kCorner, 3>(p, d, x, r, m, Q, t, i, dd, f, s, fl, q, cs)
                 : launch_trip<kCorner, 6>(p, d, x, r, m, Q, t, i, dd, f, s, fl, q, cs);
  return static_cast<int>(err);
}

extern "C" int odo_end_launch(const void* prm, void* st, void* stream) {
  Params p;
  memcpy(&p, prm, sizeof(Params));
  odo_end_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(p, static_cast<float*>(st));
  return static_cast<int>(cudaGetLastError());
}
