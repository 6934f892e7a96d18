// Rotation-carrying IMU scans with their bias tangents, as an ordered
// reduction of per-sample elements: a block a segment, a warp each
// gyroscope bias direction and a fourth for the accelerometer directions
// (or AHRS's covariance).
//
// Replaces two lax.scans of gtsam_personal_tpu/navigation/preintegration.py,
// each under jax.jacfwd over the bias:
//   - _manifold_scan (the scan at :171, differentiated at :191): deltaR,
//     deltaP, deltaV composed on the manifold, R+ = R Exp(w dt);
//   - integrate_ahrs (the rotation scan at :225, differentiated at :229, and
//     the covariance scan at :240), in the same pass.
// Neither is a Pallas kernel; eager PyTorch has no form of them but a Python
// loop over the samples. Built for sm_90a by
// gtsam_personal_tpu_torch/ops/_build.py and called through
// gtsam_personal_tpu_torch/ops/preintegration.py:preint_rotation, which also
// holds the plain versions (Python loops under torch.func.jacfwd). The final
// Log of deltaR and its derivative stay torch operations on the results.
//
// The function. With a = acc - b_a, w = gyro - b_w and E_n = Exp(w dt), the
// scan is a product of one element per sample,
//   X_n = (E_n, dv_n = a dt, dp_n = a dt^2/2, t_n = dt),
// under the associative (not commutative) composition of [i,j) and [j,k):
//   R_ik = R_ij R_jk,  v_ik = v_ij + R_ij v_jk,
//   p_ik = p_ij + v_ij t_jk + R_ij p_jk,  t_ik = t_ij + t_jk,
// the scan's step (ops/preintegration.py:_manifold_scan) regrouped. The
// tangent in bias direction d (d < 3 moves b_a, d >= 3 b_w in mode 0; d < 3
// moves b_w in mode 1) composes by the product rule:
//   dR_ik = dR_ij R_jk + R_ij dR_jk,  dv_ik = dv_ij + dR_ij v_jk + R_ij dv_jk,
//   dp_ik = dp_ij + dv_ij t_jk + dR_ij p_jk + R_ij dp_jk;
// an accelerometer direction has dE = 0, so its dR is 0 throughout and is
// not carried, and its dv, dp are columns of 3 x 3 matrices DV, DP that
// compose as DV_ik = DV_ij + R_ij DV_jk, DP_ik = DP_ij + DV_ij t_jk +
// R_ij DP_jk. In mode 1 (AHRS) the element also holds
//   Q_n = (Jl(-w dt) dt) (Sg / dt_safe) (Jl(-w dt) dt)^T,
// and the covariance composes as cov_ik = R_jk^T cov_ij R_jk + cov_jk
// (ops/preintegration.py:ahrs_cov_ref's step regrouped).
//
// The grouping, which fixes the result to the bit. A round is kRound =
// kLanes x kChunk samples. In each, lane l of a direction's warp composes
// samples l kChunk .. l kChunk + kChunk - 1 of the round in order; lane 0
// starts from the product of the rounds before (the carry), the other lanes
// from the identity; then the 32 lanes combine left to right in a fixed
// binary tree (warp shuffles, strides 1, 2, 4, 8, 16), which leaves the
// product through the round in lane 0. kLanes, kChunk and the tree do not
// depend on N. A sample of dt = 0, and a sample past the end of the segment,
// acts as the identity exactly (E = I, dv = dp = 0, Q = 0, dE = 0), and
// composing with the identity is exact, so a segment padded to any N gives
// bitwise what it gives alone.
//
// The element builder. Each round, the block's threads first form the
// records of the round's kRound samples, one thread a sample (E, phi = w dt,
// Exp's coefficients A, B, dA, dB in t2 = |phi|^2, dt, and a in mode 0 or
// Q's upper triangle in mode 1) into shared memory, structure of arrays in
// the order the lanes read them (lane l's c-th sample at c kLanes + l: no
// bank conflict). Square root, sine and cosine (as sincospi, whose
// reduction needs no table in local memory) and one division are taken
// once per sample here, off the composition, and every direction reads
// them: a gyroscope direction forms its dE from them with a few FMAs.
//
// Layout: accs (mode 0), gyros [S, N, 3], dts [S, N], bias [S, 6] (mode 0)
// or [S, 3] (mode 1), gyro_cov [3, 3] (mode 1); out R [S, 3, 3], dR
// [S, nd, 3, 3], and p, v [S, 3], dp, dv [S, 6, 3] (mode 0) or cov [S, 3, 3]
// (mode 1), nd = 6 or 3. A block has 4 warps, one to each of an SM's four
// schedulers: the 3 gyroscope directions and, in mode 0, the 3
// accelerometer directions together, each carrying the primal; in mode 1
// the covariance.
//
// What bounds it: the operations of the 6 (3 + covariance) tangents and the
// primal per sample, at the card's scalar float64 rate, for a batch of
// segments; for one segment the depth of the reduction, one element and
// log2 N combines deep (chip_smoke.py:preint_bound). Measured on an NVIDIA
// H100 80GB HBM3 (power limit 700 W) by tools/time_kernels.py (PERF.md
// section 6), float64, 200 samples a segment, per launch by CUDA events
// around launches from the host: manifold 0.0421-0.0467 ms for one segment
// and 0.0900-0.0908 ms for 2000, AHRS 0.0336-0.0440 and 0.0796-0.0798 ms;
// the device's time alone, from a CUDA graph of launches: 0.0086, 0.0895,
// 0.0084-0.0085 and 0.0783 ms (one segment's launch is the host's). The
// accelerometer directions share a warp because each warp carries the
// primal: a warp each (6 a block) took 13-17% longer in manifold mode.
// 137 / 134 registers (manifold / AHRS) in float64, 72 / 64 in float32, no
// stack; 47104 bytes of shared memory in float64, so 3 blocks an SM (4,
// asked of __launch_bounds__, spill).
//
// The arithmetic below is plain C++ apart from the launch at the end, and
// compiles for the host as well: rotation_host runs the kernel's rounds,
// chunks and tree in the kernel's order.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PREINT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define PREINT_HD inline
#endif

namespace preint_rot {

#ifndef __CUDACC__
using std::cos;
using std::fma;
using std::sin;
using std::sqrt;
#endif

constexpr double kSmall = 1e-6;            // geometry/so3.py:_SMALL
constexpr int kLanes = 32;                 // lanes of a direction's warp
constexpr int kChunk = 8;                  // samples a lane composes in order
constexpr int kRound = kLanes * kChunk;    // samples of a round

// The fields of a sample's record, each an array of kRound in shared memory.
enum Field {
  fE = 0,        // Exp(phi), 9
  fPhi = 9,      // phi = w dt, 3
  fA = 12, fB = 13, fdA = 14, fdB = 15,   // Exp's coefficients, d/d t2
  fDt = 16,
  fX = 17,       // mode 0: a (3); mode 1: Q's upper triangle (6)
  kFields = 23
};

// What a warp carries: the 3 accelerometer directions, one gyroscope
// direction (mode 0); one gyroscope direction, the covariance (mode 1).
enum Kind { kAccel = 0, kGyro = 1, kAhrsGyro = 2, kAhrsCov = 3 };

template <int K>
struct Has {
  static constexpr bool pv = K == kAccel || K == kGyro;  // p, v, t
  static constexpr bool dR = K == kGyro || K == kAhrsGyro;
  static constexpr bool cov = K == kAhrsCov;
};

// The product of a run of samples and its tangents; the fields a kind does
// not carry are never touched.
template <typename T, int K>
struct State {
  T R[9];
  T p[3], v[3], t;
  T dR[9];
  T dp[3], dv[3];     // kGyro
  T DP[9], DV[9];     // kAccel: column d is direction d's dp, dv
  T cov[9];
};

#ifdef __CUDA_ARCH__
// sin and cos of x as sincospi of x / pi: the reduction of a multiple of pi
// is exact, so the device needs no large-argument path (which would put a
// table in local memory); the product's rounding moves x by about an ulp
__device__ __forceinline__ void sincos_of(float x, float& s, float& c) {
  sincospif(x * 0.318309886183790671538f, &s, &c);
}
__device__ __forceinline__ void sincos_of(double x, double& s, double& c) {
  sincospi(x * 0.318309886183790671537767526745, &s, &c);
}
#else
template <typename T>
inline void sincos_of(T x, T& s, T& c) {
  s = sin(x);
  c = cos(x);
}
#endif

// A = sin(t)/t, B = (1 - cos t)/t^2, C = (t - sin t)/t^3 of t2 = t^2, and
// the derivatives of A and B in t2 (geometry/so3.py:_trig_coeffs), with
// one division.
template <typename T>
PREINT_HD void exp_coeffs(T t2, T& A, T& B, T& C, T& dA, T& dB) {
  if (t2 < T(kSmall)) {
    A = T(1.0) - t2 / T(6.0) + t2 * t2 / T(120.0);
    B = T(0.5) - t2 / T(24.0) + t2 * t2 / T(720.0);
    C = T(1.0) / T(6.0) - t2 / T(120.0) + t2 * t2 / T(5040.0);
    dA = -T(1.0) / T(6.0) + T(2.0) * t2 / T(120.0);
    dB = -T(1.0) / T(24.0) + T(2.0) * t2 / T(720.0);
  } else {
    const T th = sqrt(t2);
    T s, c;
    sincos_of(th, s, c);
    const T rth = T(1.0) / th;
    const T rt2 = rth * rth;
    const T dth = T(0.5) * rth;
    const T omc = T(1.0) - c;
    A = s * rth;
    B = omc * rt2;
    C = (th - s) * (rt2 * rth);
    dA = (c * dth) * rth - (s * dth) * rt2;
    dB = (s * dth) * rt2 - omc * (rt2 * rt2);
  }
}

template <typename T>
PREINT_HD void hat(const T x[3], T M[9]) {
  M[0] = T(0); M[1] = -x[2]; M[2] = x[1];
  M[3] = x[2]; M[4] = T(0); M[5] = -x[0];
  M[6] = -x[1]; M[7] = x[0]; M[8] = T(0);
}

// hat(x)^2 = x x^T - |x|^2 I
template <typename T>
PREINT_HD void hat2(const T x[3], T M[9]) {
  M[0] = -fma(x[1], x[1], x[2] * x[2]);
  M[4] = -fma(x[0], x[0], x[2] * x[2]);
  M[8] = -fma(x[0], x[0], x[1] * x[1]);
  M[1] = M[3] = x[0] * x[1];
  M[2] = M[6] = x[0] * x[2];
  M[5] = M[7] = x[1] * x[2];
}

// C = A B + D (D = 0 if null), each entry a chain of fma() ending in A's
// first column
template <typename T>
PREINT_HD void matmul3(const T A[9], const T B[9], T C[9],
                       const T* D = nullptr) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = fma(A[3 * i], B[j],
                         fma(A[3 * i + 1], B[3 + j],
                             D ? fma(A[3 * i + 2], B[6 + j], D[3 * i + j])
                               : A[3 * i + 2] * B[6 + j]));
}

// y = A x + z
template <typename T>
PREINT_HD void matvec_add(const T A[9], const T x[3], const T z[3], T y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = fma(A[3 * i], x[0],
               fma(A[3 * i + 1], x[1], fma(A[3 * i + 2], x[2], z[i])));
}

// out = E^T P E + Q
template <typename T>
PREINT_HD void congruence_add(const T P[9], const T E[9], const T Q[9],
                              T out[9]) {
  T M[9];
  matmul3(P, E, M);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = fma(E[i], M[j],
                           fma(E[3 + i], M[3 + j],
                               fma(E[6 + i], M[6 + j], Q[3 * i + j])));
}

template <typename T, int K>
PREINT_HD void set_identity(State<T, K>& x) {
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    x.R[e] = (e % 4 == 0) ? T(1) : T(0);
    x.dR[e] = x.DP[e] = x.DV[e] = x.cov[e] = T(0);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) x.p[i] = x.v[i] = x.dp[i] = x.dv[i] = T(0);
  x.t = T(0);
}

// The record of one sample (a, w with the bias removed; all zero past the
// end of the segment) into column `pos` of the round's records.
template <typename T, bool kAhrs>
PREINT_HD void build_record(const T a[3], const T w[3], T dt,
                            const T* __restrict__ gyro_cov,
                            T (*rec)[kRound], int pos) {
  const T phi[3] = {w[0] * dt, w[1] * dt, w[2] * dt};
  const T t2 = fma(phi[0], phi[0], fma(phi[1], phi[1], phi[2] * phi[2]));
  T A, B, C, dA, dB;
  exp_coeffs(t2, A, B, C, dA, dB);
  T W[9], WW[9];
  hat(phi, W);
  hat2(phi, WW);
#pragma unroll
  for (int e = 0; e < 9; ++e)
    rec[fE + e][pos] = fma(B, WW[e], fma(A, W[e], (e % 4 == 0) ? T(1) : T(0)));
#pragma unroll
  for (int i = 0; i < 3; ++i) rec[fPhi + i][pos] = phi[i];
  rec[fA][pos] = A;
  rec[fB][pos] = B;
  rec[fdA][pos] = dA;
  rec[fdB][pos] = dB;
  rec[fDt][pos] = dt;
  if constexpr (!kAhrs) {
#pragma unroll
    for (int i = 0; i < 3; ++i) rec[fX + i][pos] = a[i];
  } else {
    // Jl(-phi) dt = (I - B W + C W^2) dt, then J (Sg / dt_safe) J^T
    T J[9], S[9], JS[9];
    const T rdt = T(1.0) / (dt > T(1e-12) ? dt : T(1e-12));
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      J[e] = fma(C, WW[e], fma(-B, W[e], (e % 4 == 0) ? T(1) : T(0))) * dt;
      S[e] = gyro_cov[e] * rdt;
    }
    matmul3(J, S, JS);
    int u = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j, ++u)
        rec[fX + u][pos] = fma(JS[3 * i], J[3 * j],
                               fma(JS[3 * i + 1], J[3 * j + 1],
                                   JS[3 * i + 2] * J[3 * j + 2]));
  }
}

// The record of sample n of a segment (n >= N: the identity's).
template <typename T, bool kAhrs>
PREINT_HD void build_sample(const T* __restrict__ acc,
                            const T* __restrict__ gyr,
                            const T* __restrict__ dts, int64_t N, int64_t n,
                            const T* __restrict__ bias,
                            const T* __restrict__ gyro_cov,
                            T (*rec)[kRound], int pos) {
  T a[3] = {T(0), T(0), T(0)}, w[3] = {T(0), T(0), T(0)}, dt = T(0);
  if (n < N) {
    const T* bw = kAhrs ? bias : bias + 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (!kAhrs) a[i] = acc[3 * n + i] - bias[i];
      w[i] = gyr[3 * n + i] - bw[i];
    }
    dt = dts[n];
  }
  build_record<T, kAhrs>(a, w, dt, gyro_cov, rec, pos);
}

// The round's sample at record column pos: lane pos % kLanes, its
// (pos / kLanes)-th sample.
PREINT_HD int64_t sample_of(int64_t round, int pos) {
  return round * kRound + (pos % kLanes) * kChunk + pos / kLanes;
}

// dE of the record at `pos` in the direction dphi = -dt e_k:
//   dE = (dA dt2) W + A D + (dB dt2) W^2 + B (D W + W D),
// with D = hat(dphi), dt2 = 2 phi . dphi and
// D W + W D = -dt (e_k phi^T + phi e_k^T - 2 phi_k I).
template <typename T>
PREINT_HD void exp_tangent(const T (*rec)[kRound], int pos, int k, T dE[9]) {
  const T phi[3] = {rec[fPhi][pos], rec[fPhi + 1][pos], rec[fPhi + 2][pos]};
  const T A = rec[fA][pos], B = rec[fB][pos];
  const T q = -rec[fDt][pos];
  const T ek[3] = {k == 0 ? T(1) : T(0), k == 1 ? T(1) : T(0),
                   k == 2 ? T(1) : T(0)};
  const T phik = fma(ek[0], phi[0], fma(ek[1], phi[1], ek[2] * phi[2]));
  const T dt2 = T(2.0) * (q * phik);
  const T cA = rec[fdA][pos] * dt2, cB = rec[fdB][pos] * dt2;
  T W[9], WW[9], He[9];
  hat(phi, W);
  hat2(phi, WW);
  hat(ek, He);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = 3 * i + j;
      const T sym = fma(ek[i], phi[j], phi[i] * ek[j]) -
                    (i == j ? T(2.0) * phik : T(0));
      dE[e] = fma(cA, W[e], fma(A, q * He[e], fma(cB, WW[e], B * (q * sym))));
    }
}

// x = x X_n: the state composed with the element of the record at `pos`
// (k: the gyroscope direction of kGyro and kAhrsGyro).
template <typename T, int K>
PREINT_HD void step(State<T, K>& x, const T (*rec)[kRound], int pos, int k) {
  T E[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) E[e] = rec[fE + e][pos];
  if constexpr (Has<K>::pv) {
    const T dt = rec[fDt][pos];
    const T h = (T(0.5) * dt) * dt;
    const T a[3] = {rec[fX][pos], rec[fX + 1][pos], rec[fX + 2][pos]};
    const T zero[3] = {T(0), T(0), T(0)};
    T a_nav[3];
    matvec_add(x.R, a, zero, a_nav);
    if constexpr (K == kAccel) {
      // direction d: da = -e_d, so its a_nav's tangent is -R e_d
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        x.DP[e] = fma(h, -x.R[e], fma(x.DV[e], dt, x.DP[e]));
        x.DV[e] = fma(-x.R[e], dt, x.DV[e]);
      }
    } else {
      T da_nav[3];
      matvec_add(x.dR, a, zero, da_nav);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x.dp[i] = fma(h, da_nav[i], fma(x.dv[i], dt, x.dp[i]));
        x.dv[i] = fma(da_nav[i], dt, x.dv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.p[i] = fma(h, a_nav[i], fma(x.v[i], dt, x.p[i]));
      x.v[i] = fma(a_nav[i], dt, x.v[i]);
    }
    x.t = x.t + dt;
  }
  if constexpr (Has<K>::dR) {
    T dE[9], RdE[9], dRn[9];
    exp_tangent(rec, pos, k, dE);
    matmul3(x.R, dE, RdE);
    matmul3(x.dR, E, dRn, RdE);
#pragma unroll
    for (int e = 0; e < 9; ++e) x.dR[e] = dRn[e];
  }
  if constexpr (Has<K>::cov) {
    const T* qu = &rec[fX][0];
    const T Q[9] = {qu[0 * kRound + pos], qu[1 * kRound + pos],
                    qu[2 * kRound + pos], qu[1 * kRound + pos],
                    qu[3 * kRound + pos], qu[4 * kRound + pos],
                    qu[2 * kRound + pos], qu[4 * kRound + pos],
                    qu[5 * kRound + pos]};
    T P[9];
    congruence_add(x.cov, E, Q, P);
#pragma unroll
    for (int e = 0; e < 9; ++e) x.cov[e] = P[e];
  }
  T R[9];
  matmul3(x.R, E, R);
#pragma unroll
  for (int e = 0; e < 9; ++e) x.R[e] = R[e];
}

// x = x y: x covers [i, j), y covers [j, k).
template <typename T, int K>
PREINT_HD void combine(State<T, K>& x, const State<T, K>& y) {
  if constexpr (K == kAccel) {
    T DPt[9], DV[9], DP[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) DPt[e] = fma(x.DV[e], y.t, x.DP[e]);
    matmul3(x.R, y.DV, DV, x.DV);
    matmul3(x.R, y.DP, DP, DPt);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      x.DV[e] = DV[e];
      x.DP[e] = DP[e];
    }
  }
  if constexpr (K == kGyro) {
    T dpv[3], dv[3], dp[3], dv2[3], dp2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) dpv[i] = fma(x.dv[i], y.t, x.dp[i]);
    matvec_add(x.R, y.dv, x.dv, dv);
    matvec_add(x.R, y.dp, dpv, dp);
    matvec_add(x.dR, y.v, dv, dv2);
    matvec_add(x.dR, y.p, dp, dp2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.dv[i] = dv2[i];
      x.dp[i] = dp2[i];
    }
  }
  if constexpr (Has<K>::pv) {
    T v[3], p[3], pv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) pv[i] = fma(x.v[i], y.t, x.p[i]);
    matvec_add(x.R, y.v, x.v, v);
    matvec_add(x.R, y.p, pv, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.v[i] = v[i];
      x.p[i] = p[i];
    }
    x.t = x.t + y.t;
  }
  if constexpr (Has<K>::dR) {
    T RdR[9], dR[9];
    matmul3(x.R, y.dR, RdR);
    matmul3(x.dR, y.R, dR, RdR);
#pragma unroll
    for (int e = 0; e < 9; ++e) x.dR[e] = dR[e];
  }
  if constexpr (Has<K>::cov) {
    T P[9];
    congruence_add(x.cov, y.R, y.cov, P);
#pragma unroll
    for (int e = 0; e < 9; ++e) x.cov[e] = P[e];
  }
  T R[9];
  matmul3(x.R, y.R, R);
#pragma unroll
  for (int e = 0; e < 9; ++e) x.R[e] = R[e];
}

// Where a warp's result goes: the accelerometer directions' tangents (dR
// is 0 for them) with the primal, gyroscope direction d's tangent (in mode
// 1 direction 0's warp writes R), or cov.
template <typename T, int K>
PREINT_HD void store_state(const State<T, K>& x, int d, T* __restrict__ R,
                           T* __restrict__ dR, T* __restrict__ p,
                           T* __restrict__ v, T* __restrict__ dp,
                           T* __restrict__ dv, T* __restrict__ cov) {
  if constexpr (K == kAccel) {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      R[e] = x.R[e];
      dR[e] = dR[9 + e] = dR[18 + e] = T(0);
      // DP, DV: column d is direction d's; dp, dv: row d is
      dp[3 * (e % 3) + e / 3] = x.DP[e];
      dv[3 * (e % 3) + e / 3] = x.DV[e];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = x.p[i];
      v[i] = x.v[i];
    }
  } else if constexpr (K == kGyro) {
#pragma unroll
    for (int e = 0; e < 9; ++e) dR[9 * d + e] = x.dR[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dp[3 * d + i] = x.dp[i];
      dv[3 * d + i] = x.dv[i];
    }
  } else if constexpr (K == kAhrsGyro) {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      dR[9 * d + e] = x.dR[e];
      if (d == 0) R[e] = x.R[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 9; ++e) cov[e] = x.cov[e];
  }
}

#ifndef __CUDACC__
// One round of one direction on the host: the lanes' chunks, lane 0 from
// the carry, then the kernel's tree; the carry becomes the product through
// the round.
template <typename T, int K>
void round_host(const T (*rec)[kRound], int k, State<T, K>& carry) {
  State<T, K> lanes[kLanes];
  for (int l = 0; l < kLanes; ++l) {
    if (l == 0)
      lanes[0] = carry;
    else
      set_identity(lanes[l]);
    for (int c = 0; c < kChunk; ++c) step(lanes[l], rec, c * kLanes + l, k);
  }
  for (int s = 1; s < kLanes; s *= 2)
    for (int l = 0; l + s < kLanes; l += 2 * s)
      combine(lanes[l], lanes[l + s]);
  carry = lanes[0];
}

// One segment on the host, in the kernel's grouping (rounds, chunks, the
// tree); the outputs are the segment's rows of the kernel's.
template <typename T, bool kAhrs>
void rotation_host(const T* __restrict__ acc, const T* __restrict__ gyr,
                   const T* __restrict__ dts, int64_t N,
                   const T* __restrict__ bias,
                   const T* __restrict__ gyro_cov, T* __restrict__ R,
                   T* __restrict__ dR, T* __restrict__ p, T* __restrict__ v,
                   T* __restrict__ dp, T* __restrict__ dv,
                   T* __restrict__ cov) {
  T rec[kFields][kRound];
  constexpr int kG = kAhrs ? kAhrsGyro : kGyro;
  State<T, kAccel> accel;
  State<T, kG> gyro[3];
  State<T, kAhrsCov> cv;
  set_identity(accel);
  for (int k = 0; k < 3; ++k) set_identity(gyro[k]);
  set_identity(cv);
  const int64_t rounds = (N + kRound - 1) / kRound;
  for (int64_t r = 0; r < rounds; ++r) {
    for (int pos = 0; pos < kRound; ++pos)
      build_sample<T, kAhrs>(acc, gyr, dts, N, sample_of(r, pos), bias,
                             gyro_cov, rec, pos);
    for (int k = 0; k < 3; ++k) round_host(rec, k, gyro[k]);
    if (kAhrs)
      round_host(rec, 0, cv);
    else
      round_host(rec, 0, accel);
  }
  for (int k = 0; k < 3; ++k)
    store_state(gyro[k], kAhrs ? k : 3 + k, R, dR, p, v, dp, dv, cov);
  if (kAhrs)
    store_state(cv, 0, R, dR, p, v, dp, dv, cov);
  else
    store_state(accel, 0, R, dR, p, v, dp, dv, cov);
}
#endif

}  // namespace preint_rot

#ifdef __CUDACC__
namespace {

using preint_rot::kChunk;
using preint_rot::kLanes;
using preint_rot::kRound;

constexpr int kThreads = 4 * kLanes;

// Every thread of the block at barrier 0. The warps reach it from different
// kinds' code (so not the .aligned form that __syncthreads() is), each
// through the same barriers in the same order.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

template <typename T, int K>
__device__ __forceinline__ void shfl_down(const preint_rot::State<T, K>& x,
                                          preint_rot::State<T, K>& y, int s) {
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int e = 0; e < 9; ++e) y.R[e] = __shfl_down_sync(kAll, x.R[e], s);
  if constexpr (preint_rot::Has<K>::pv) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      y.p[i] = __shfl_down_sync(kAll, x.p[i], s);
      y.v[i] = __shfl_down_sync(kAll, x.v[i], s);
    }
    y.t = __shfl_down_sync(kAll, x.t, s);
  }
  if constexpr (K == preint_rot::kGyro) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      y.dp[i] = __shfl_down_sync(kAll, x.dp[i], s);
      y.dv[i] = __shfl_down_sync(kAll, x.dv[i], s);
    }
  }
  if constexpr (K == preint_rot::kAccel) {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      y.DP[e] = __shfl_down_sync(kAll, x.DP[e], s);
      y.DV[e] = __shfl_down_sync(kAll, x.DV[e], s);
    }
  }
  if constexpr (preint_rot::Has<K>::dR) {
#pragma unroll
    for (int e = 0; e < 9; ++e) y.dR[e] = __shfl_down_sync(kAll, x.dR[e], s);
  }
  if constexpr (preint_rot::Has<K>::cov) {
#pragma unroll
    for (int e = 0; e < 9; ++e)
      y.cov[e] = __shfl_down_sync(kAll, x.cov[e], s);
  }
}

// One warp's direction k (of kind K) through every round of segment `seg`,
// the whole block building each round's records first.
template <typename T, bool kAhrs, int K>
__device__ __forceinline__ void direction_warp(
    int k, int d, const T* __restrict__ accs, const T* __restrict__ gyros,
    const T* __restrict__ dts, const T* __restrict__ bias,
    const T* __restrict__ gyro_cov, T* __restrict__ R, T* __restrict__ dR,
    T* __restrict__ p, T* __restrict__ v, T* __restrict__ dp,
    T* __restrict__ dv, T* __restrict__ cov, int64_t seg, int64_t N,
    T (*rec)[kRound]) {
  constexpr int nd = kAhrs ? 3 : 6;
  const int lane = threadIdx.x % kLanes;
  const T* acc = kAhrs ? nullptr : accs + seg * N * 3;
  const T* gyr = gyros + seg * N * 3;
  const T* dtv = dts + seg * N;
  const T* b = bias + seg * (kAhrs ? 3 : 6);
  preint_rot::State<T, K> x;
  preint_rot::set_identity(x);
  const int64_t rounds = (N + kRound - 1) / kRound;
  for (int64_t r = 0; r < rounds; ++r) {
    for (int pos = threadIdx.x; pos < kRound; pos += kThreads)
      preint_rot::build_sample<T, kAhrs>(acc, gyr, dtv, N,
                                         preint_rot::sample_of(r, pos), b,
                                         gyro_cov, rec, pos);
    block_sync();
    // lane 0 goes on from the rounds before
    if (lane != 0) preint_rot::set_identity(x);
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      preint_rot::step(x, rec, c * kLanes + lane, k);
#pragma unroll
    for (int s = 1; s < kLanes; s *= 2) {
      preint_rot::State<T, K> y;
      shfl_down(x, y, s);
      preint_rot::combine(x, y);
    }
    block_sync();   // before the next round's records
  }
  if (lane == 0)
    preint_rot::store_state(x, d, R + seg * 9, dR + seg * nd * 9,
                            kAhrs ? nullptr : p + seg * 3,
                            kAhrs ? nullptr : v + seg * 3,
                            kAhrs ? nullptr : dp + seg * nd * 3,
                            kAhrs ? nullptr : dv + seg * nd * 3,
                            kAhrs ? cov + seg * 9 : nullptr);
}

template <typename T, bool kAhrs>
__global__ void __launch_bounds__(kThreads)
preint_rotation_kernel(const T* __restrict__ accs, const T* __restrict__ gyros,
                       const T* __restrict__ dts, const T* __restrict__ bias,
                       const T* __restrict__ gyro_cov, T* __restrict__ R,
                       T* __restrict__ dR, T* __restrict__ p,
                       T* __restrict__ v, T* __restrict__ dp,
                       T* __restrict__ dv, T* __restrict__ cov, int64_t N) {
  __shared__ T rec[preint_rot::kFields][kRound];
  const int warp = threadIdx.x / kLanes;
  const int64_t seg = blockIdx.x;
  // warps 0-2: the gyroscope directions; warp 3: the accelerometer
  // directions (mode 0) or the covariance (mode 1)
  if (warp < 3) {
    constexpr int kG = kAhrs ? preint_rot::kAhrsGyro : preint_rot::kGyro;
    direction_warp<T, kAhrs, kG>(warp, kAhrs ? warp : 3 + warp, accs, gyros,
                                 dts, bias, gyro_cov, R, dR, p, v, dp, dv,
                                 cov, seg, N, rec);
  } else {
    constexpr int kO = kAhrs ? preint_rot::kAhrsCov : preint_rot::kAccel;
    direction_warp<T, kAhrs, kO>(0, 0, accs, gyros, dts, bias, gyro_cov, R,
                                 dR, p, v, dp, dv, cov, seg, N, rec);
  }
}

template <typename T>
int launch(int mode, const void* accs, const void* gyros, const void* dts,
           const void* bias, const void* gyro_cov, void* R, void* dR, void* p,
           void* v, void* dp, void* dv, void* cov, int64_t S, int64_t N,
           void* stream) {
  if (mode != 0 && mode != 1) return -1;
  if (S > 0) {
    auto kernel = mode == 1 ? preint_rotation_kernel<T, true>
                            : preint_rotation_kernel<T, false>;
    kernel<<<static_cast<unsigned int>(S), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(accs), static_cast<const T*>(gyros),
        static_cast<const T*>(dts), static_cast<const T*>(bias),
        static_cast<const T*>(gyro_cov), static_cast<T*>(R),
        static_cast<T*>(dR), static_cast<T*>(p), static_cast<T*>(v),
        static_cast<T*>(dp), static_cast<T*>(dv), static_cast<T*>(cov), N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: return cudaGetLastError() after the launch (0 = success;
// -1: a mode that does not exist). Pointers a mode does not use may be 0.
extern "C" int preint_rotation_f32(int mode, const void* accs,
                                   const void* gyros, const void* dts,
                                   const void* bias, const void* gyro_cov,
                                   void* R, void* dR, void* p, void* v,
                                   void* dp, void* dv, void* cov, int64_t S,
                                   int64_t N, void* stream) {
  return launch<float>(mode, accs, gyros, dts, bias, gyro_cov, R, dR, p, v,
                       dp, dv, cov, S, N, stream);
}

extern "C" int preint_rotation_f64(int mode, const void* accs,
                                   const void* gyros, const void* dts,
                                   const void* bias, const void* gyro_cov,
                                   void* R, void* dR, void* p, void* v,
                                   void* dp, void* dv, void* cov, int64_t S,
                                   int64_t N, void* stream) {
  return launch<double>(mode, accs, gyros, dts, bias, gyro_cov, R, dR, p, v,
                        dp, dv, cov, S, N, stream);
}
#endif  // __CUDACC__
