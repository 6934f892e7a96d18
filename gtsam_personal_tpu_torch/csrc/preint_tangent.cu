// IMU preintegration on the 9-D tangent space, one warp per segment.
//
// Replaces the lax.scan of gtsam_personal_tpu/navigation/preintegration.py:
// integrate (the scan at :112, whose body takes jax.jacfwd of _update_zeta
// at :98-100). It is no Pallas kernel: XLA compiles the scan into one
// program, and eager PyTorch has no form of it but a Python loop of several
// launches per IMU sample. Built for sm_90a by
// gtsam_personal_tpu_torch/ops/_build.py and called through
// gtsam_personal_tpu_torch/ops/preintegration.py:preint_tangent, which also
// holds the plain version (that Python loop, with torch.func.jacfwd per
// step).
//
// Per sample, with a = acc - b_a, w = gyro - b_w and zeta = (theta, p, v):
//
//   theta+ = theta + Jl(-theta)^{-1} w dt
//   p+     = p + v dt + Exp(theta) a dt^2/2
//   v+     = v + Exp(theta) a dt
//   H+     = A H - [B | C]                  (H = [H_ba | H_bw], [9, 6])
//   cov+   = A cov A^T + B (Sa/dt) B^T + C (Sg/dt) C^T + Si dt (p block)
//
// with A = d zeta+/d zeta, B = d zeta+/d a, C = d zeta+/d w. The JAX package
// and the plain version take A, B, C from forward-mode differentiation of
// the update. Here they are the same derivatives written out: theta enters
// through the scalar coefficients of Exp and of Jl^{-1} (functions of
// t2 = theta . theta, with the Taylor branch below t2 = 1e-6 of
// geometry/so3.py) and through hat(theta); each coefficient is carried as a
// value and its derivative in t2 (dual arithmetic over t2, with the same
// branches and thresholds), and d t2 / d theta_k = 2 theta_k. The entries of
// A, B and C that are constant (identities, dt) are what jacfwd gives for
// them, so the kernel agrees with the plain version to rounding; theta
// starts at exactly 0, where the Taylor branch and its derivative hold.
//
// Layout: accs, gyros [S, N, 3], dts [S, N], bias [S, 6] (b_a, b_w), covs
// [3, 3, 3] (accel, gyro, integration covariance), all contiguous; out
// zeta [S, 9], H [S, 9, 6], cov [S, 9, 9], dT [S]. A sample with dt = 0 is
// the identity on zeta, H and cov (B = C = 0, Si dt = 0), which is how the
// wrapper pads segments of unequal length.
//
// What bounds it: per sample about 5.5k floating-point operations (the
// products with the dense 9 x 9 A dominate) on 7 inputs, so a launch over
// many segments is bound by operations, not bytes. But a segment is a chain
// of N dependent steps, and one segment's step is too small to fill more
// than one warp: one warp walks one segment, its 32 lanes sharing each
// step's matrix products (lane e takes entries e, e + 32, e + 64), the
// carry (zeta, H, cov) in shared memory and the step's coefficients in
// every lane's registers, computed by all lanes alike. A launch for one
// segment (the ISAM2 stream's, one per GPS fix) is the latency of N steps;
// a launch for thousands (the batch path) puts one warp per segment on all
// SMs. Three __syncwarp() a step separate filling A, forming A cov and
// A H, and forming cov+. The step's divisions by dt are taken once, into
// shared memory, not once per entry of cov+ (that took 12.3 us a step).
//
// Measured on an NVIDIA H100 80GB HBM3 (power limit 700 W) in float64, by
// CUDA events (chip_smoke.py phase 14): 2.08 ms for 2000 segments of 200
// samples (the bound by operations is 75 us), 0.82 ms for one segment
// (4.1 us a dependent step); 254 registers and a 400-byte stack a thread.
//
// The arithmetic below is plain C++ apart from the launch at the end, and
// compiles for the host as well (with `lane = 0, nlanes = 1`).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PREINT_HD __host__ __device__
#else
#include <cmath>
#define PREINT_HD
#endif
// the lanes of a warp meet here on the device; the host has one lane
#ifdef __CUDA_ARCH__
#define PREINT_SYNC() __syncwarp()
#else
#define PREINT_SYNC()
#endif

namespace preint {

#ifndef __CUDACC__
using std::cos;
using std::fabs;
using std::sin;
using std::sqrt;
#endif

constexpr double kSmall = 1e-6;   // geometry/so3.py:_SMALL

// Exp's coefficients A = sin(t)/t, B = (1 - cos t)/t^2 of t2 = t^2 and
// their derivatives in t2 (geometry/so3.py:_trig_coeffs).
template <typename T>
PREINT_HD void exp_coeffs(T t2, T& A, T& B, T& dA, T& dB) {
  if (t2 < T(kSmall)) {
    A = T(1.0) - t2 / T(6.0) + t2 * t2 / T(120.0);
    B = T(0.5) - t2 / T(24.0) + t2 * t2 / T(720.0);
    dA = -T(1.0) / T(6.0) + T(2.0) * t2 / T(120.0);
    dB = -T(1.0) / T(24.0) + T(2.0) * t2 / T(720.0);
  } else {
    const T th = sqrt(t2);
    const T dth = T(0.5) / th;
    const T s = sin(th), c = cos(th);
    A = s / th;
    B = (T(1.0) - c) / t2;
    dA = (c * dth) / th - s * dth / (th * th);
    dB = (s * dth) / t2 - (T(1.0) - c) / (t2 * t2);
  }
}

// The coefficient D of Jl^{-1}(v) = I - V/2 + D V^2 and its derivative in
// t2 (geometry/so3.py:left_jacobian_inverse).
template <typename T>
PREINT_HD void jinv_coeff(T t2, T& D, T& dD) {
  if (t2 < T(kSmall)) {
    D = T(1.0) / T(12.0) + t2 / T(720.0) + t2 * t2 / T(30240.0);
    dD = T(1.0) / T(720.0) + T(2.0) * t2 / T(30240.0);
  } else {
    const T th = sqrt(t2);
    const T dth = T(0.5) / th;
    const T s = sin(th), c = cos(th);
    const bool tiny = fabs(s) < T(1e-12);
    const T ss = tiny ? T(1.0) : s;
    const T dss = tiny ? T(0.0) : c * dth;
    const T num = T(1.0) + c, dnum = -s * dth;
    const T den = T(2.0) * th * ss;
    const T dden = T(2.0) * dth * ss + T(2.0) * th * dss;
    D = T(1.0) / t2 - num / den;
    dD = -T(1.0) / (t2 * t2) - (dnum / den - num * dden / (den * den));
  }
}

// M = hat(x)
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

// The coefficients of one step, the same in every lane: R = Exp(theta),
// Jinv = Jl(-theta)^{-1}, a_nav = R a, w_tan = Jinv w, and the derivatives
// Ga[i][k] = d a_nav_i / d theta_k, Gw[i][k] = d w_tan_i / d theta_k.
template <typename T>
struct StepCoeffs {
  T R[9], Jinv[9], a_nav[3], w_tan[3], Ga[9], Gw[9];
};

template <typename T>
PREINT_HD void step_coeffs(const T th[3], const T a[3], const T w[3],
                           StepCoeffs<T>& c) {
  const T t2 = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T A, B, dA, dB, D, dD;
  exp_coeffs(t2, A, B, dA, dB);
  jinv_coeff(t2, D, dD);
  T W[9], WW[9], V[9], VV[9];
  const T mth[3] = {-th[0], -th[1], -th[2]};
  hat(th, W);
  matmul3(W, W, WW);
  hat(mth, V);
  matmul3(V, V, VV);
  for (int e = 0; e < 9; ++e) {
    const T I = (e % 4 == 0) ? T(1) : T(0);
    c.R[e] = I + A * W[e] + B * WW[e];
    c.Jinv[e] = I - T(0.5) * V[e] + D * VV[e];
  }
  matvec3(c.R, a, c.a_nav);
  matvec3(c.Jinv, w, c.w_tan);
  for (int k = 0; k < 3; ++k) {
    // d t2 / d theta_k, the same for t2 of -theta
    const T dt2 = T(2.0) * th[k];
    T ek[3] = {T(0), T(0), T(0)};
    ek[k] = T(1);
    const T mek[3] = {-ek[0], -ek[1], -ek[2]};
    T E[9], dV[9], EW[9], WE[9], dVV[9], VdV[9];
    hat(ek, E);                 // d W / d theta_k
    hat(mek, dV);               // d V / d theta_k
    matmul3(E, W, EW);
    matmul3(W, E, WE);
    matmul3(dV, V, dVV);
    matmul3(V, dV, VdV);
    T dR[9], dJ[9];
    for (int e = 0; e < 9; ++e) {
      dR[e] = (dA * dt2) * W[e] + A * E[e] + (dB * dt2) * WW[e] +
              B * (EW[e] + WE[e]);
      dJ[e] = -T(0.5) * dV[e] + (dD * dt2) * VV[e] + D * (dVV[e] + VdV[e]);
    }
    T ga[3], gw[3];
    matvec3(dR, a, ga);
    matvec3(dJ, w, gw);
    for (int i = 0; i < 3; ++i) {
      c.Ga[3 * i + k] = ga[i];
      c.Gw[3 * i + k] = gw[i];
    }
  }
}

// One warp's working set in shared memory.
template <typename T>
struct Carry {
  T Z[2][9];       // zeta, double-buffered by step parity
  T H[2][54];      // [H_ba | H_bw], [9, 6], double-buffered
  T P[81];         // cov
  T M[81];         // A cov
  T A[81];         // this step's A
  T BC[54];        // this step's [B | C], [9, 6]
  T Q[27];         // the three covariances
  T Qdt[18];       // this step's accel and gyro covariances over dt
};

// Entry (i, l) of A of a step.
template <typename T>
PREINT_HD T a_entry(const StepCoeffs<T>& c, int i, int l, T dt, T dt22) {
  const int bi = i / 3, ri = i % 3, bl = l / 3, rl = l % 3;
  const T delta = (ri == rl) ? T(1) : T(0);
  if (bi == 0) return bl == 0 ? delta + c.Gw[3 * ri + rl] * dt : T(0);
  if (bi == 1) {
    if (bl == 0) return c.Ga[3 * ri + rl] * dt22;
    return bl == 1 ? delta : delta * dt;
  }
  if (bl == 0) return c.Ga[3 * ri + rl] * dt;
  return bl == 2 ? delta : T(0);
}

// Entry (i, k) of [B | C] of a step.
template <typename T>
PREINT_HD T bc_entry(const StepCoeffs<T>& c, int i, int k, T dt, T dt22) {
  const int bi = i / 3, ri = i % 3;
  if (k < 3) {
    if (bi == 1) return c.R[3 * ri + k] * dt22;
    return bi == 2 ? c.R[3 * ri + k] * dt : T(0);
  }
  return bi == 0 ? c.Jinv[3 * ri + (k - 3)] * dt : T(0);
}

// (acc, gyro, dt) of sample n into out[7].
template <typename T>
PREINT_HD void load_sample(const T* __restrict__ acc,
                           const T* __restrict__ gyr,
                           const T* __restrict__ dts, int64_t n, T out[7]) {
  for (int i = 0; i < 3; ++i) {
    out[i] = acc[3 * n + i];
    out[3 + i] = gyr[3 * n + i];
  }
  out[6] = dts[n];
}

// Integrate one segment of N samples. Lane `lane` of `nlanes` takes every
// nlanes-th entry of each product; on the device nlanes = 32 (a warp).
template <typename T>
PREINT_HD void tangent_segment(int lane, int nlanes,
                               const T* __restrict__ acc,
                               const T* __restrict__ gyr,
                               const T* __restrict__ dts, int64_t N,
                               const T* __restrict__ bias,
                               const T* __restrict__ covs, Carry<T>& s,
                               T* __restrict__ zeta_out,
                               T* __restrict__ H_out,
                               T* __restrict__ cov_out,
                               T* __restrict__ dT_out) {
  for (int e = lane; e < 81; e += nlanes) s.P[e] = T(0);
  for (int e = lane; e < 54; e += nlanes) s.H[0][e] = T(0);
  for (int e = lane; e < 27; e += nlanes) s.Q[e] = covs[e];
  if (lane == 0)
    for (int e = 0; e < 9; ++e) s.Z[0][e] = T(0);
  const T ba[3] = {bias[0], bias[1], bias[2]};
  const T bw[3] = {bias[3], bias[4], bias[5]};
  T total = T(0);
  PREINT_SYNC();
  // the next sample is read while this one is worked on, so that the
  // chain of steps does not wait on memory
  T next[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (N > 0) load_sample(acc, gyr, dts, 0, next);
  for (int64_t n = 0; n < N; ++n) {
    const int cur = static_cast<int>(n & 1), nxt = cur ^ 1;
    const T a[3] = {next[0] - ba[0], next[1] - ba[1], next[2] - ba[2]};
    const T w[3] = {next[3] - bw[0], next[4] - bw[1], next[5] - bw[2]};
    const T dt = next[6];
    if (n + 1 < N) load_sample(acc, gyr, dts, n + 1, next);
    const T th[3] = {s.Z[cur][0], s.Z[cur][1], s.Z[cur][2]};
    StepCoeffs<T> c;
    step_coeffs(th, a, w, c);
    const T dt22 = T(0.5) * dt * dt;
    total = total + dt;
    // fill A, [B | C] and zeta+
    for (int e = lane; e < 81; e += nlanes)
      s.A[e] = a_entry(c, e / 9, e % 9, dt, dt22);
    for (int e = lane; e < 54; e += nlanes)
      s.BC[e] = bc_entry(c, e / 6, e % 6, dt, dt22);
    const T dt_safe = dt > T(1e-12) ? dt : T(1e-12);
    for (int e = lane; e < 18; e += nlanes) s.Qdt[e] = s.Q[e] / dt_safe;
    for (int i = lane; i < 3; i += nlanes) {
      const T p = s.Z[cur][3 + i], v = s.Z[cur][6 + i];
      s.Z[nxt][i] = th[i] + c.w_tan[i] * dt;
      s.Z[nxt][3 + i] = p + v * dt + c.a_nav[i] * dt22;
      s.Z[nxt][6 + i] = v + c.a_nav[i] * dt;
    }
    PREINT_SYNC();
    // A cov and A H - [B | C]
    for (int e = lane; e < 81; e += nlanes) {
      const int i = e / 9, j = e % 9;
      T acc_ = T(0);
      for (int l = 0; l < 9; ++l)
        acc_ = acc_ + s.A[9 * i + l] * s.P[9 * l + j];
      s.M[e] = acc_;
    }
    for (int e = lane; e < 54; e += nlanes) {
      const int i = e / 6, j = e % 6;
      T acc_ = T(0);
      for (int l = 0; l < 9; ++l)
        acc_ = acc_ + s.A[9 * i + l] * s.H[cur][6 * l + j];
      s.H[nxt][e] = acc_ - s.BC[e];
    }
    PREINT_SYNC();
    // cov+ = (A cov) A^T + B (Sa/dt) B^T + C (Sg/dt) C^T + Si dt
    for (int e = lane; e < 81; e += nlanes) {
      const int i = e / 9, j = e % 9;
      T v = T(0);
      for (int l = 0; l < 9; ++l) v = v + s.M[9 * i + l] * s.A[9 * j + l];
      for (int q = 0; q < 2; ++q) {      // q = 0: B and Sa; q = 1: C and Sg
        T u = T(0);
        for (int l = 0; l < 3; ++l) {
          T bs = T(0);
          for (int k = 0; k < 3; ++k)
            bs = bs + s.BC[6 * i + 3 * q + k] * s.Qdt[9 * q + 3 * k + l];
          u = u + bs * s.BC[6 * j + 3 * q + l];
        }
        v = v + u;
      }
      if (i >= 3 && i < 6 && j >= 3 && j < 6)
        v = v + s.Q[18 + 3 * (i - 3) + (j - 3)] * dt;
      s.P[e] = v;
    }
    PREINT_SYNC();
  }
  const int fin = static_cast<int>(N & 1);
  for (int e = lane; e < 9; e += nlanes) zeta_out[e] = s.Z[fin][e];
  for (int e = lane; e < 54; e += nlanes) H_out[e] = s.H[fin][e];
  for (int e = lane; e < 81; e += nlanes) cov_out[e] = s.P[e];
  if (lane == 0) *dT_out = total;
}

}  // namespace preint

#ifdef __CUDACC__
namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
preint_tangent_kernel(const T* __restrict__ accs, const T* __restrict__ gyros,
                      const T* __restrict__ dts, const T* __restrict__ bias,
                      const T* __restrict__ covs, T* __restrict__ zeta,
                      T* __restrict__ H, T* __restrict__ cov,
                      T* __restrict__ dT, int64_t S, int64_t N) {
  __shared__ preint::Carry<T> carry[kWarpsPerBlock];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (seg >= S) return;          // the whole warp leaves together
  preint::tangent_segment<T>(lane, 32, accs + seg * N * 3,
                             gyros + seg * N * 3, dts + seg * N, N,
                             bias + seg * 6, covs, carry[warp],
                             zeta + seg * 9, H + seg * 54, cov + seg * 81,
                             dT + seg);
}

template <typename T>
int launch(const void* accs, const void* gyros, const void* dts,
           const void* bias, const void* covs, void* zeta, void* H, void* cov,
           void* dT, int64_t S, int64_t N, void* stream) {
  if (S > 0) {
    const int64_t blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
    preint_tangent_kernel<T>
        <<<static_cast<unsigned int>(blocks), 32 * kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(accs), static_cast<const T*>(gyros),
            static_cast<const T*>(dts), static_cast<const T*>(bias),
            static_cast<const T*>(covs), static_cast<T*>(zeta),
            static_cast<T*>(H), static_cast<T*>(cov), static_cast<T*>(dT), S,
            N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: return cudaGetLastError() after the launch (0 = success).
extern "C" int preint_tangent_f32(const void* accs, const void* gyros,
                                  const void* dts, const void* bias,
                                  const void* covs, void* zeta, void* H,
                                  void* cov, void* dT, int64_t S, int64_t N,
                                  void* stream) {
  return launch<float>(accs, gyros, dts, bias, covs, zeta, H, cov, dT, S, N,
                       stream);
}

extern "C" int preint_tangent_f64(const void* accs, const void* gyros,
                                  const void* dts, const void* bias,
                                  const void* covs, void* zeta, void* H,
                                  void* cov, void* dT, int64_t S, int64_t N,
                                  void* stream) {
  return launch<double>(accs, gyros, dts, bias, covs, zeta, H, cov, dT, S, N,
                        stream);
}
#endif  // __CUDACC__
