// Rotation-carrying IMU scans with their bias tangents, one thread per
// (segment, bias direction).
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
// Mode 0, manifold: with a = acc - b_a, w = gyro - b_w, per sample
//   a_nav = R a;  p+ = p + v dt + (dt^2/2) a_nav;  v+ = v + a_nav dt;
//   R+ = R Exp(w dt)
// and the forward-mode tangent of (R, p, v) in bias direction d (6 of them:
// d < 3 moves b_a, d >= 3 moves b_w), by the product rule through the same
// formulas, Exp's coefficients carried as values and derivatives in
// t2 = |w dt|^2 with the Taylor branch of geometry/so3.py below 1e-6.
// Mode 1, AHRS: R only, 3 gyro-bias directions, and the 3 x 3 covariance
//   cov+ = Exp(w dt)^T cov Exp(w dt) + Jr (Sg/dt) Jr^T dt^2,
//   Jr = Jl(-w dt),
// taken by the direction-0 thread of each segment.
//
// Layout: accs (mode 0), gyros [S, N, 3], dts [S, N], bias [S, 6] (mode 0)
// or [S, 3] (mode 1), gyro_cov [3, 3] (mode 1); out R [S, 3, 3], dR
// [S, nd, 3, 3], and p, v [S, 3], dp, dv [S, 6, 3] (mode 0) or cov [S, 3, 3]
// (mode 1), nd = 6 or 3.
//
// What bounds it: a step is a few hundred operations on 7 inputs, so the
// bytes (the samples, read once) and the operations are both small; what
// limits a launch is the chain of N dependent steps of each thread. A
// thread carries the primal and one tangent (30 values in mode 0) in
// registers and shares nothing, so no barrier sits in the step; every
// thread of a segment recomputes the primal, which costs operations the
// card has to spare, and reads the same sample as its neighbours, which the
// cache serves. Measured on an NVIDIA H100 80GB HBM3 (power limit 700 W) in
// float64, manifold mode, by CUDA events (chip_smoke.py phase 14): 0.277 ms
// for 2000 segments of 200 samples (the bound by operations is 24 us),
// 0.237 ms for one segment (1.18 us a dependent step); 202-210 registers.
//
// The arithmetic below is plain C++ apart from the launch at the end, and
// compiles for the host as well.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PREINT_HD __host__ __device__
#else
#include <cmath>
#define PREINT_HD
#endif

namespace preint_rot {

#ifndef __CUDACC__
using std::cos;
using std::sin;
using std::sqrt;
#endif

constexpr double kSmall = 1e-6;   // geometry/so3.py:_SMALL

// A = sin(t)/t, B = (1 - cos t)/t^2, C = (t - sin t)/t^3 of t2 = t^2, and
// the derivatives of A and B in t2 (geometry/so3.py:_trig_coeffs).
template <typename T>
PREINT_HD void trig_coeffs(T t2, T& A, T& B, T& C, T& dA, T& dB) {
  if (t2 < T(kSmall)) {
    A = T(1.0) - t2 / T(6.0) + t2 * t2 / T(120.0);
    B = T(0.5) - t2 / T(24.0) + t2 * t2 / T(720.0);
    C = T(1.0) / T(6.0) - t2 / T(120.0) + t2 * t2 / T(5040.0);
    dA = -T(1.0) / T(6.0) + T(2.0) * t2 / T(120.0);
    dB = -T(1.0) / T(24.0) + T(2.0) * t2 / T(720.0);
  } else {
    const T th = sqrt(t2);
    const T dth = T(0.5) / th;
    const T s = sin(th), c = cos(th);
    A = s / th;
    B = (T(1.0) - c) / t2;
    C = (th - s) / (t2 * th);
    dA = (c * dth) / th - s * dth / (th * th);
    dB = (s * dth) / t2 - (T(1.0) - c) / (t2 * t2);
  }
}

template <typename T>
PREINT_HD void hat(const T x[3], T M[9]) {
  M[0] = T(0); M[1] = -x[2]; M[2] = x[1];
  M[3] = x[2]; M[4] = T(0); M[5] = -x[0];
  M[6] = -x[1]; M[7] = x[0]; M[8] = T(0);
}

template <typename T>
PREINT_HD void matmul3(const T A[9], const T B[9], T C[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

template <typename T>
PREINT_HD void matvec3(const T A[9], const T x[3], T y[3]) {
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// E = Exp(phi) and its tangent dE in direction dphi.
template <typename T>
PREINT_HD void exp_jvp(const T phi[3], const T dphi[3], T E[9], T dE[9]) {
  const T t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T dt2 = (dphi[0] * phi[0] + dphi[1] * phi[1] + dphi[2] * phi[2]) +
                (phi[0] * dphi[0] + phi[1] * dphi[1] + phi[2] * dphi[2]);
  T A, B, C, dA, dB;
  trig_coeffs(t2, A, B, C, dA, dB);
  T W[9], WW[9], D[9], DW[9], WD[9];
  hat(phi, W);
  matmul3(W, W, WW);
  hat(dphi, D);
  matmul3(D, W, DW);
  matmul3(W, D, WD);
  for (int e = 0; e < 9; ++e) {
    const T I = (e % 4 == 0) ? T(1) : T(0);
    E[e] = I + A * W[e] + B * WW[e];
    dE[e] = (dA * dt2) * W[e] + A * D[e] + (dB * dt2) * WW[e] +
            B * (DW[e] + WD[e]);
  }
}

// (acc, gyro, dt) of sample n into out[7] (acc left as it is in AHRS
// mode, which has none).
template <typename T, bool kAhrs>
PREINT_HD void load_sample(const T* __restrict__ acc,
                           const T* __restrict__ gyr,
                           const T* __restrict__ dts, int64_t n, T out[7]) {
  for (int i = 0; i < 3; ++i) {
    if (!kAhrs) out[i] = acc[3 * n + i];
    out[3 + i] = gyr[3 * n + i];
  }
  out[6] = dts[n];
}

// One segment in direction d (manifold mode: d < 6; AHRS mode: d < 3).
template <typename T, bool kAhrs>
PREINT_HD void rotation_segment(int d, const T* __restrict__ acc,
                                const T* __restrict__ gyr,
                                const T* __restrict__ dts, int64_t N,
                                const T* __restrict__ bias,
                                const T* __restrict__ gyro_cov,
                                T* __restrict__ R_out,
                                T* __restrict__ dR_out, T* __restrict__ p_out,
                                T* __restrict__ v_out, T* __restrict__ dp_out,
                                T* __restrict__ dv_out,
                                T* __restrict__ cov_out) {
  // bias tangent: -e_d on the bias component d moves (a, w) by -e
  T da[3] = {T(0), T(0), T(0)}, dw[3] = {T(0), T(0), T(0)};
  const T* bw = kAhrs ? bias : bias + 3;
  if (kAhrs) {
    dw[d] = T(-1);
  } else if (d < 3) {
    da[d] = T(-1);
  } else {
    dw[d - 3] = T(-1);
  }
  T R[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
  T dR[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T p[3] = {T(0), T(0), T(0)}, v[3] = {T(0), T(0), T(0)};
  T dp[3] = {T(0), T(0), T(0)}, dv[3] = {T(0), T(0), T(0)};
  T P[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  // the next sample is read while this one is worked on
  T next[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (N > 0) load_sample<T, kAhrs>(acc, gyr, dts, 0, next);
  for (int64_t n = 0; n < N; ++n) {
    const T dt = next[6];
    const T w[3] = {next[3] - bw[0], next[4] - bw[1], next[5] - bw[2]};
    const T am[3] = {next[0], next[1], next[2]};
    if (n + 1 < N) load_sample<T, kAhrs>(acc, gyr, dts, n + 1, next);
    if (!kAhrs) {
      const T a[3] = {am[0] - bias[0], am[1] - bias[1], am[2] - bias[2]};
      T a_nav[3], dRa[3], Rda[3];
      matvec3(R, a, a_nav);
      matvec3(dR, a, dRa);
      matvec3(R, da, Rda);
      const T h = T(0.5) * dt * dt;
      for (int i = 0; i < 3; ++i) {
        const T da_nav = dRa[i] + Rda[i];
        p[i] = p[i] + v[i] * dt + h * a_nav[i];
        dp[i] = dp[i] + dv[i] * dt + h * da_nav;
        v[i] = v[i] + a_nav[i] * dt;
        dv[i] = dv[i] + da_nav * dt;
      }
    }
    const T phi[3] = {w[0] * dt, w[1] * dt, w[2] * dt};
    const T dphi[3] = {dw[0] * dt, dw[1] * dt, dw[2] * dt};
    T E[9], dE[9];
    exp_jvp(phi, dphi, E, dE);
    if (kAhrs && d == 0) {
      // cov+ = E^T cov E + (Jr dt) (Sg / dt_safe) (Jr dt)^T, Jr = Jl(-phi)
      const T t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
      T A_, B_, C_, dA_, dB_;
      trig_coeffs(t2, A_, B_, C_, dA_, dB_);
      const T mphi[3] = {-phi[0], -phi[1], -phi[2]};
      T V[9], VV[9], Bm[9], Et[9], EtP[9], Pn[9], BS[9];
      hat(mphi, V);
      matmul3(V, V, VV);
      for (int e = 0; e < 9; ++e) {
        const T I = (e % 4 == 0) ? T(1) : T(0);
        Bm[e] = (I + B_ * V[e] + C_ * VV[e]) * dt;
        Et[e] = E[3 * (e % 3) + e / 3];
      }
      const T dt_safe = dt > T(1e-12) ? dt : T(1e-12);
      matmul3(Et, P, EtP);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          Pn[3 * i + j] = EtP[3 * i] * Et[3 * j] +
                          EtP[3 * i + 1] * Et[3 * j + 1] +
                          EtP[3 * i + 2] * Et[3 * j + 2];
          BS[3 * i + j] = Bm[3 * i] * (gyro_cov[j] / dt_safe) +
                          Bm[3 * i + 1] * (gyro_cov[3 + j] / dt_safe) +
                          Bm[3 * i + 2] * (gyro_cov[6 + j] / dt_safe);
        }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          P[3 * i + j] = Pn[3 * i + j] + (BS[3 * i] * Bm[3 * j] +
                                          BS[3 * i + 1] * Bm[3 * j + 1] +
                                          BS[3 * i + 2] * Bm[3 * j + 2]);
    }
    T RE[9], dRE[9], RdE[9];
    matmul3(R, E, RE);
    matmul3(dR, E, dRE);
    matmul3(R, dE, RdE);
    for (int e = 0; e < 9; ++e) {
      R[e] = RE[e];
      dR[e] = dRE[e] + RdE[e];
    }
  }
  for (int e = 0; e < 9; ++e) dR_out[e] = dR[e];
  if (d == 0) {
    for (int e = 0; e < 9; ++e) R_out[e] = R[e];
    if (kAhrs) {
      for (int e = 0; e < 9; ++e) cov_out[e] = P[e];
    } else {
      for (int i = 0; i < 3; ++i) {
        p_out[i] = p[i];
        v_out[i] = v[i];
      }
    }
  }
  if (!kAhrs) {
    for (int i = 0; i < 3; ++i) {
      dp_out[i] = dp[i];
      dv_out[i] = dv[i];
    }
  }
}

}  // namespace preint_rot

#ifdef __CUDACC__
namespace {

constexpr int kThreads = 128;

template <typename T, bool kAhrs>
__global__ void __launch_bounds__(kThreads)
preint_rotation_kernel(const T* __restrict__ accs, const T* __restrict__ gyros,
                       const T* __restrict__ dts, const T* __restrict__ bias,
                       const T* __restrict__ gyro_cov, T* __restrict__ R,
                       T* __restrict__ dR, T* __restrict__ p,
                       T* __restrict__ v, T* __restrict__ dp,
                       T* __restrict__ dv, T* __restrict__ cov, int64_t S,
                       int64_t N) {
  constexpr int nd = kAhrs ? 3 : 6;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= S * nd) return;
  const int64_t seg = t / nd;
  const int d = static_cast<int>(t % nd);
  const int nb = kAhrs ? 3 : 6;
  preint_rot::rotation_segment<T, kAhrs>(
      d, kAhrs ? nullptr : accs + seg * N * 3, gyros + seg * N * 3,
      dts + seg * N, N, bias + seg * nb, gyro_cov, R + seg * 9,
      dR + (seg * nd + d) * 9, kAhrs ? nullptr : p + seg * 3,
      kAhrs ? nullptr : v + seg * 3,
      kAhrs ? nullptr : dp + (seg * nd + d) * 3,
      kAhrs ? nullptr : dv + (seg * nd + d) * 3,
      kAhrs ? cov + seg * 9 : nullptr);
}

template <typename T>
int launch(int mode, const void* accs, const void* gyros, const void* dts,
           const void* bias, const void* gyro_cov, void* R, void* dR, void* p,
           void* v, void* dp, void* dv, void* cov, int64_t S, int64_t N,
           void* stream) {
  if (mode != 0 && mode != 1) return -1;
  const int nd = mode == 1 ? 3 : 6;
  if (S > 0) {
    const int64_t blocks = (S * nd + kThreads - 1) / kThreads;
    auto kernel = mode == 1 ? preint_rotation_kernel<T, true>
                            : preint_rotation_kernel<T, false>;
    kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(accs), static_cast<const T*>(gyros),
        static_cast<const T*>(dts), static_cast<const T*>(bias),
        static_cast<const T*>(gyro_cov), static_cast<T*>(R),
        static_cast<T*>(dR), static_cast<T*>(p), static_cast<T*>(v),
        static_cast<T*>(dp), static_cast<T*>(dv), static_cast<T*>(cov), S, N);
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
