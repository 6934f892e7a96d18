// IMU preintegration on the 9-D tangent space, one block per segment.
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
// branches and thresholds), and d t2 / d theta_k = 2 theta_k. Written in
// 3 x 3 blocks,
//
//   A = [[I + Gw dt, 0, 0], [Ga dt^2/2, I, dt I], [Ga dt, 0, I]],
//   B = [0; R dt^2/2; R dt],  C = [Jinv dt; 0; 0],
//
// with R = Exp(theta), Jinv = Jl(-theta)^{-1}, Ga = d(R a)/d theta and
// Gw = d(Jinv w)/d theta: the kernel forms the entries that jacfwd gives
// and skips only the exact zeros and ones. theta starts at exactly 0, where
// the Taylor branch and its derivative hold.
//
// Layout: accs, gyros [S, N, 3], dts [S, N], bias [S, 6] (b_a, b_w), covs
// [3, 3, 3] (accel, gyro, integration covariance), all contiguous; out
// zeta [S, 9], H [S, 9, 6], cov [S, 9, 9], dT [S]. A sample with dt = 0 is
// the identity on zeta, H and cov (B = C = 0, Si dt = 0), which is how the
// wrapper pads segments of unequal length.
//
// What bounds it: a segment is a chain of N dependent steps, but only theta
// is a nonlinear recurrence. Once the theta of a step is known, the step's
// R, Jinv, Ga, Gw and the noise terms depend on no other step, and p, v, H
// and cov are linear recurrences in their own carry. So a block of four
// warps walks one segment as a pipeline over chunks of kChunk steps, one
// __syncthreads() a chunk:
//
// - warp 0: one lane runs the theta chain in registers: t2, D of Jl^{-1}
//   (by its series below t2 = 1/4: no square root, sine, cosine or
//   division on the chain), Jinv w dt as two cross products; it writes
//   each step's theta to shared memory, chunk c;
// - warp 1: reads the samples of chunk c + 1 into shared memory and forms
//   the coefficients of chunk c - 1, two lanes a step (step_half: Exp's
//   half and Jl^{-1}'s, with the reference's trigonometric branches): no
//   lane waits on another;
// - warps 2-3: propagate p, v, H and cov through chunk c - 2 with the block
//   form of A, each lane taking fixed entries (X = A cov and H+ in one
//   pass, then the 45 entries of the symmetric cov+ = X A^T + noise), with
//   no branch in a pass, one named barrier of the two warps after each,
//   explicit fma() in every product.
//
// A lane's entries and coefficient indices are decoded once from its lane
// number, and its operands read from shared memory, so no register array is
// indexed at run time and nothing is placed in local memory (sine and cosine
// are taken as sincospi, whose reduction needs no table in local memory). A
// launch for one segment (the ISAM2 stream's, one per GPS fix) is the
// latency of the slowest role; a launch for thousands (the batch path) puts
// a block per segment on all SMs.
//
// Measured on an NVIDIA H100 80GB HBM3 (power limit 700 W) by CUDA events
// (tools/time_kernels.py, chip_smoke.py phase 14; PERF.md section 6), in
// float64: one segment of 200 samples 0.051-0.069 ms (0.81 ms before this
// design), 2000 segments 0.43 ms (2.06-2.08); per step the roles take
// about 306 (theta), 290 (coefficients) and 367 (carry) cycles
// (tools/kernel_probes.py, which runs this kernel's body, tangent_block,
// with a clock64() timer). 167 registers, no stack, 3 blocks an SM.
//
// The arithmetic below is plain C++ apart from the launch at the end, and
// compiles for the host as well: tangent_segment runs the three roles in
// turn (with `lane = 0, nlanes = 1`).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PREINT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define PREINT_HD inline
#endif
// The NL lanes of the carry's role meet here on the device: one warp at
// __syncwarp(), two warps at named barrier 1; the host has one lane.
template <int NL>
PREINT_HD void carry_sync() {
#ifdef __CUDA_ARCH__
  if constexpr (NL == 32) {
    __syncwarp();
  } else {
    static_assert(NL % 32 == 0, "the carry's role is whole warps");
    asm volatile("bar.sync 1, %0;\n" :: "n"(NL) : "memory");
  }
#endif
}

namespace preint {

#ifndef __CUDACC__
using std::cos;
using std::fabs;
using std::fma;
using std::sin;
using std::sqrt;
#endif

constexpr double kSmall = 1e-6;   // geometry/so3.py:_SMALL
constexpr int kChunk = 16;        // steps of a chunk of the pipeline

#ifdef __CUDA_ARCH__
// sin and cos of x as sincospi of x / pi: the reduction of a multiple of pi
// is exact, so the device needs no large-argument path (which would put a
// table in local memory); the product's rounding moves x by about an ulp
__device__ __forceinline__ void sincos_of(float x, float* s, float* c) {
  sincospif(x * 0.318309886183790671538f, s, c);
}
__device__ __forceinline__ void sincos_of(double x, double* s, double* c) {
  sincospi(x * 0.318309886183790671537767526745, s, c);
}
#endif

// t2 = theta . theta and, above kSmall, th = sqrt(t2), s = sin th,
// c = cos th: what the coefficients of a step are functions of.
template <typename T>
struct Trig {
  T t2, th, s, c;
};

template <typename T>
PREINT_HD void trig_of(const T th[3], Trig<T>& tr) {
  tr.t2 = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  if (tr.t2 < T(kSmall)) {
    tr.th = tr.s = tr.c = T(0);
    return;
  }
  tr.th = sqrt(tr.t2);
#ifdef __CUDA_ARCH__
  sincos_of(tr.th, &tr.s, &tr.c);
#else
  tr.s = sin(tr.th);
  tr.c = cos(tr.th);
#endif
}

// Exp's coefficients A = sin(t)/t, B = (1 - cos t)/t^2 of t2 = t^2 and
// their derivatives in t2 (geometry/so3.py:_trig_coeffs).
template <typename T>
PREINT_HD void exp_coeffs(const Trig<T>& tr, T& A, T& B, T& dA, T& dB) {
  const T t2 = tr.t2;
  if (t2 < T(kSmall)) {
    A = T(1.0) - t2 / T(6.0) + t2 * t2 / T(120.0);
    B = T(0.5) - t2 / T(24.0) + t2 * t2 / T(720.0);
    dA = -T(1.0) / T(6.0) + T(2.0) * t2 / T(120.0);
    dB = -T(1.0) / T(24.0) + T(2.0) * t2 / T(720.0);
  } else {
    const T th = tr.th, s = tr.s, c = tr.c;
    const T dth = T(0.5) / th;
    A = s / th;
    B = (T(1.0) - c) / t2;
    dA = (c * dth) / th - s * dth / (th * th);
    dB = (s * dth) / t2 - (T(1.0) - c) / (t2 * t2);
  }
}

// The coefficient D of Jl^{-1}(v) = I - V/2 + D V^2
// (geometry/so3.py:left_jacobian_inverse).
template <typename T>
PREINT_HD T jinv_D(const Trig<T>& tr) {
  const T t2 = tr.t2;
  if (t2 < T(kSmall))
    return T(1.0) / T(12.0) + t2 / T(720.0) + t2 * t2 / T(30240.0);
  const T ss = fabs(tr.s) < T(1e-12) ? T(1.0) : tr.s;
  return T(1.0) / t2 - (T(1.0) + tr.c) / (T(2.0) * tr.th * ss);
}

// D and its derivative in t2.
template <typename T>
PREINT_HD void jinv_coeff(const Trig<T>& tr, T& D, T& dD) {
  const T t2 = tr.t2;
  D = jinv_D(tr);
  if (t2 < T(kSmall)) {
    dD = T(1.0) / T(720.0) + T(2.0) * t2 / T(30240.0);
  } else {
    const T th = tr.th, s = tr.s, c = tr.c;
    const T dth = T(0.5) / th;
    const bool tiny = fabs(s) < T(1e-12);
    const T ss = tiny ? T(1.0) : s;
    const T dss = tiny ? T(0.0) : c * dth;
    const T num = T(1.0) + c, dnum = -s * dth;
    const T den = T(2.0) * th * ss;
    const T dden = T(2.0) * dth * ss + T(2.0) * th * dss;
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

template <typename T>
PREINT_HD void matvec3(const T A[9], const T x[3], T y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// x cross y, which is hat(x) y
template <typename T>
PREINT_HD void cross3(const T x[3], const T y[3], T z[3]) {
  z[0] = fma(x[1], y[2], -(x[2] * y[1]));
  z[1] = fma(x[2], y[0], -(x[0] * y[2]));
  z[2] = fma(x[0], y[1], -(x[1] * y[0]));
}

// D of Jl^{-1} on the theta chain: below t2 = kSeriesT2 its Taylor series in
// t2, D = sum_n |B_2n| / (2n)! t2^(n-1) (B: the Bernoulli numbers), nine
// terms, within 2e-16 of D there; above, jinv_D. The series needs no
// square root, sine, cosine or division, which take 89, about 190 and 62
// cycles on the H100 (PERF.md section 6); it differs from jinv_D's
// evaluation, whose two terms of size 1/t2 cancel to D, by that
// cancellation's rounding (about 1e-16 / t2 relative), which moves theta by
// D t2 |w| dt of it.
constexpr double kSeriesT2 = 0.25;

template <typename T>
PREINT_HD T chain_D(const T th[3]) {
  const T t2 = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  if (t2 >= T(kSeriesT2)) {
    Trig<T> tr;
    trig_of(th, tr);
    return jinv_D(tr);
  }
  T D = T(8.586062056277845e-15);
  D = fma(D, t2, T(3.3896802963225827e-13));
  D = fma(D, t2, T(1.3382536530684679e-11));
  D = fma(D, t2, T(5.284190138687493e-10));
  D = fma(D, t2, T(2.08767569878681e-08));
  D = fma(D, t2, T(8.267195767195768e-07));
  D = fma(D, t2, T(3.306878306878307e-05));
  D = fma(D, t2, T(0.001388888888888889));
  return fma(D, t2, T(0.08333333333333333));
}

// The theta chain's step: theta += Jl(-theta)^{-1} w dt, as
// w - V w / 2 + D V (V w) with V = hat(-theta).
template <typename T>
PREINT_HD void theta_step(T th[3], const T w[3], T dt) {
  const T D = chain_D(th);
  const T mth[3] = {-th[0], -th[1], -th[2]};
  T Vw[3], VVw[3];
  cross3(mth, w, Vw);
  cross3(mth, Vw, VVw);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    th[i] = fma(fma(D, VVw[i], fma(T(-0.5), Vw[i], w[i])), dt, th[i]);
}

// The coefficients of one step, as the propagation reads them.
template <typename T>
struct Record {
  T L[3][9];         // A's theta column: I + Gw dt, Ga dt^2/2, Ga dt
  T RJ[18];          // Exp(theta) (0-8), then Jl(-theta)^{-1} (9-17)
  T Ma[9], Mg[9];    // R (Sa/dt) R^T, J (Sg/dt) J^T
  T a_nav[3];        // R a
  T dt, dt22;
  T spare[9];        // where half 1 puts what only half 0 keeps
};

// Half of the record of a step, from its theta, trig values and sample.
// Both halves are M = I + c1 X + c2 X^2 and the derivative of M v in
// theta, G[i][k] = d (M v)_i / d theta_k, with
//   half 0: M = R = Exp(theta), X = hat(theta), (c1, c2) = (A, B), v = a;
//   half 1: M = Jinv = Jl(-theta)^{-1}, X = hat(-theta), (c1, c2) =
//           (-1/2, D), v = w,
// so that two lanes of one warp form a step's record with the same
// instructions. Half 0 writes R, Ga dt^2/2, Ga dt, R (Sa/dt) R^T, a_nav, dt
// and dt^2/2; half 1 Jinv, I + Gw dt and Jinv (Sg/dt) Jinv^T.
template <typename T>
PREINT_HD void step_half(int half, const T th[3], const Trig<T>& tr,
                         const T a[3], const T w[3], T dt,
                         const T* __restrict__ Q, Record<T>& out) {
  T A, B, dA, dB, D, dD;
  exp_coeffs(tr, A, B, dA, dB);
  jinv_coeff(tr, D, dD);
  const bool j = half == 1;
  const T c1 = j ? T(-0.5) : A, c2 = j ? D : B;
  const T dc1 = j ? T(0) : dA, dc2 = j ? dD : dB;
  const T sg = j ? T(-1) : T(1);
  const T x[3] = {sg * th[0], sg * th[1], sg * th[2]};
  const T v[3] = {j ? w[0] : a[0], j ? w[1] : a[1], j ? w[2] : a[2]};
  T X[9], XX[9], M[9];
  hat(x, X);
  matmul3(X, X, XX);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const T I = (e % 4 == 0) ? T(1) : T(0);
    M[e] = I + c1 * X[e] + c2 * XX[e];
  }
  const T dt22 = T(0.5) * dt * dt;
  // half 0: L[2] = Ga dt and L[1] = Ga dt^2/2; half 1: L[0] = I + Gw dt
  T* L1 = j ? out.L[0] : out.L[2];
  T* L2 = j ? out.spare : out.L[1];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // d t2 / d theta_k, the same for t2 of -theta
    const T dt2 = T(2.0) * th[k];
    T ek[3] = {T(0), T(0), T(0)};
    ek[k] = sg;
    T dX[9], dXX[9], XdX[9];
    hat(ek, dX);                // d X / d theta_k
    matmul3(dX, X, dXX);
    matmul3(X, dX, XdX);
    T dM[9];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      dM[e] = (dc1 * dt2) * X[e] + c1 * dX[e] + (dc2 * dt2) * XX[e] +
              c2 * (dXX[e] + XdX[e]);
    T g[3];
    matvec3(dM, v, g);          // column k of Ga or Gw
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      L1[3 * i + k] = (j && i == k ? T(1) : T(0)) + g[i] * dt;
      L2[3 * i + k] = g[i] * dt22;
    }
  }
  const T rdt = T(1) / (dt > T(1e-12) ? dt : T(1e-12));
  const T* S = Q + 9 * half;
  T* out_m = j ? out.Mg : out.Ma;
  T MS[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      MS[3 * i + l] = fma(M[3 * i], S[l],
                          fma(M[3 * i + 1], S[3 + l], M[3 * i + 2] * S[6 + l]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out_m[3 * i + k] = fma(MS[3 * i], M[3 * k],
                             fma(MS[3 * i + 1], M[3 * k + 1],
                                 MS[3 * i + 2] * M[3 * k + 2])) * rdt;
#pragma unroll
  for (int e = 0; e < 9; ++e) out.RJ[9 * half + e] = M[e];
  matvec3(M, v, j ? out.spare : out.a_nav);
  *(j ? &out.spare[3] : &out.dt) = dt;
  *(j ? &out.spare[4] : &out.dt22) = dt22;
}

// A block's working set in shared memory.
template <typename T>
struct Carry {
  T smp[3][kChunk][7];     // a, w (bias removed) and dt of a chunk's samples
  T th[2][kChunk][3];      // theta before the step
  Record<T> rec[2][kChunk];
  T P[81];                 // cov, both triangles
  T X[81];                 // A cov of the step
  T H[2][54];              // [H_ba | H_bw], by step parity
  T pv[2][6];              // p, v, by step parity
  T Q[27];                 // the three covariances
  T sink;                  // where a lane past the last entry stores
};

// The samples of chunk `ch` into smp[ch % 3]; a lane a step.
template <typename T>
PREINT_HD void load_chunk(int lane, int nlanes, const T* __restrict__ acc,
                          const T* __restrict__ gyr,
                          const T* __restrict__ dts, int64_t N,
                          const T* __restrict__ bias, int64_t ch,
                          Carry<T>& s) {
  for (int k = lane; k < kChunk; k += nlanes) {
    const int64_t n = ch * kChunk + k;
    if (n >= N) break;
    T* out = s.smp[ch % 3][k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[i] = acc[3 * n + i] - bias[i];
      out[3 + i] = gyr[3 * n + i] - bias[3 + i];
    }
    out[6] = dts[n];
  }
}

template <typename T>
PREINT_HD int steps_of(int64_t ch, int64_t N) {
  const int64_t left = N - ch * kChunk;
  return static_cast<int>(left < kChunk ? left : kChunk);
}

// The theta chain through chunk `ch`, in one lane; each step's w and dt
// are read a step ahead.
template <typename T>
PREINT_HD void theta_chunk(int64_t ch, int64_t N, Carry<T>& s, T th[3],
                           T& total) {
  const int steps = steps_of<T>(ch, N);
  const T(*in)[7] = s.smp[ch % 3];
  T(*out)[3] = s.th[ch & 1];
  T w[3] = {in[0][3], in[0][4], in[0][5]};
  T dt = in[0][6];
  for (int k = 0; k < steps; ++k) {
    const T wk[3] = {w[0], w[1], w[2]};
    const T dtk = dt;
    if (k + 1 < steps) {
      w[0] = in[k + 1][3];
      w[1] = in[k + 1][4];
      w[2] = in[k + 1][5];
      dt = in[k + 1][6];
    }
    out[k][0] = th[0];
    out[k][1] = th[1];
    out[k][2] = th[2];
    theta_step(th, wk, dtk);
    total = total + dtk;
  }
}

// The records of chunk `ch`: two lanes a step, one a half.
template <typename T>
PREINT_HD void coeff_chunk(int lane, int nlanes, int64_t ch, int64_t N,
                           Carry<T>& s) {
  const int steps = steps_of<T>(ch, N);
  for (int t = lane; t < 2 * kChunk; t += nlanes) {
    const int k = t % kChunk, half = t / kChunk;
    if (k >= steps) continue;
    const T* tin = s.th[ch & 1][k];
    const T* in = s.smp[ch % 3][k];
    const T th[3] = {tin[0], tin[1], tin[2]};
    Trig<T> tr;
    trig_of(th, tr);
    const T a[3] = {in[0], in[1], in[2]};
    const T w[3] = {in[3], in[4], in[5]};
    step_half(half, th, tr, a, w, in[6], s.Q, s.rec[ch & 1][k]);
  }
}

// The entries of one step that a lane of NL takes, decoded once: in the
// first pass entry e of X = A cov (0-71) or H+ = A H - [B | C] (72-125),
// and lanes 0-5 also p+ and v+; in the second, entry e of cov+'s upper
// triangle. Row block a of A is [L_a, alpha_a I, beta_a I] (alpha = 0, 1,
// 0 and beta = 0, dt, 1), so an entry (a, i; q) of A Y reads row i of L_a
// and column q of rows 0-2, 3 + i and 6 + i of Y. cov+'s upper triangle
// reads X's blocks (a, 1) only for a <= 1, so X's block (2, 1) is not
// formed. A lane past the last entry computes the last one again and
// stores it to a sink, so that the pass has no branch and its loads can all
// be in flight at once.
constexpr int kPass1 = 72 + 54;

template <int NL>
struct LaneEntries {
  static constexpr int kM1 = (kPass1 + NL - 1) / NL;
  static constexpr int kM2 = (45 + NL - 1) / NL;
  bool store1[kM1], isH[kM1];
  int f[kM1];      // the entry's index in X or H
  int a[kM1], i[kM1], q[kM1];
  int bc[kM1];     // [B | C]'s entry: 0 none, 1 dt^2/2, 2 dt, times
  int m[kM1];      // this entry of R (0-8) or Jinv (9-17)
  bool store2[kM2];
  int row[kM2], col[kM2];   // cov entry (row, col), row <= col
};

template <int NL>
PREINT_HD void lane_entries(int lane, LaneEntries<NL>& le) {
#pragma unroll
  for (int m = 0; m < le.kM1; ++m) {
    const int e0 = lane + NL * m;
    const int e = e0 < kPass1 ? e0 : kPass1 - 1;
    const bool isH = e >= 72;
    int row, q;
    if (isH) {
      row = (e - 72) / 6;
      q = e - 72 - 6 * row;
    } else if (e < 54) {
      row = e / 9;
      q = e - 9 * row;
    } else {                     // rows 6-8 without columns 3-5
      row = 6 + (e - 54) / 6;
      const int c6 = e - 54 - 6 * (row - 6);
      q = c6 < 3 ? c6 : c6 + 3;
    }
    const int a = row / 3, i = row % 3;
    le.store1[m] = e0 < kPass1;
    le.isH[m] = isH;
    le.f[m] = isH ? 6 * row + q : 9 * row + q;
    le.a[m] = a;
    le.i[m] = i;
    le.q[m] = q;
    le.bc[m] = !isH ? 0 : q < 3 ? a : (a == 0 ? 2 : 0);
    le.m[m] = !isH ? 0 : q < 3 ? 3 * i + q : 9 + 3 * i + q - 3;
  }
#pragma unroll
  for (int m = 0; m < le.kM2; ++m) {
    const int e0 = lane + NL * m;
    int row = 0, left = e0 < 45 ? e0 : 44;
    while (left >= 9 - row) {
      left -= 9 - row;
      ++row;
    }
    le.store2[m] = e0 < 45;
    le.row[m] = row;
    le.col[m] = row + left;
  }
}

// alpha_a and beta_a of row block a; b_a of B = [0; R dt^2/2; R dt]
template <typename T>
PREINT_HD T alpha_of(int a) { return a == 1 ? T(1) : T(0); }
template <typename T>
PREINT_HD T beta_of(int a, T dt) { return a == 0 ? T(0) : a == 1 ? dt : T(1); }
template <typename T>
PREINT_HD T b_of(int a, T dt, T dt22) {
  return a == 0 ? T(0) : a == 1 ? dt22 : dt;
}

// One step of p, v, H and cov (carry parity `cur`) through record `r`;
// `lane` is the lane's number among the NL.
template <int NL, typename T>
PREINT_HD void propagate_step(int lane, const LaneEntries<NL>& le,
                              const Record<T>& r, Carry<T>& s, int cur) {
  const int nxt = cur ^ 1;
  const T dt = r.dt, dt22 = r.dt22;
  // every entry is read and formed before any is stored, so that the loads
  // of all of them are in flight together (a store could alias a load);
  // each sum is a shallow tree of fma()
  T out[le.kM1];
#pragma unroll
  for (int m = 0; m < le.kM1; ++m) {
    const bool isH = le.isH[m];
    const int a = le.a[m], i = le.i[m], q = le.q[m];
    const int w = isH ? 6 : 9;
    const T* src = isH ? s.H[cur] : s.P;
    const T* L = &r.L[a][3 * i];
    // H's [B | C]: b_a R in columns 0-2, c_a Jinv in 3-5 (c = dt, 0, 0);
    // nothing for X
    const int bc = le.bc[m];
    const T coef = bc == 0 ? T(0) : bc == 1 ? dt22 : dt;
    const T head = fma(L[1], src[w + q], L[0] * src[q]);
    const T tail = fma(beta_of(a, dt), src[(6 + i) * w + q],
                       fma(alpha_of<T>(a), src[(3 + i) * w + q],
                           -(coef * r.RJ[le.m[m]])));
    out[m] = head + fma(L[2], src[2 * w + q], tail);
  }
  // p+ and v+, one entry a lane
  const bool has_pv = lane < 6;
  const int k = has_pv ? lane : 0;
  const T* pv = s.pv[cur];
  const T pv_out = k < 3 ? pv[k] + pv[3 + k] * dt + r.a_nav[k] * dt22
                         : pv[k] + r.a_nav[k - 3] * dt;
#pragma unroll
  for (int m = 0; m < le.kM1; ++m)
    *(!le.store1[m] ? &s.sink : le.isH[m] ? &s.H[nxt][le.f[m]]
                                          : &s.X[le.f[m]]) = out[m];
  *(has_pv ? &s.pv[nxt][k] : &s.sink) = pv_out;
  if constexpr (NL < 6) {   // the host's one lane takes the rest
    for (int k2 = lane + NL; k2 < 6; k2 += NL)
      s.pv[nxt][k2] = k2 < 3 ? pv[k2] + pv[3 + k2] * dt + r.a_nav[k2] * dt22
                             : pv[k2] + r.a_nav[k2 - 3] * dt;
  }
  carry_sync<NL>();
  // cov+ = X A^T + B (Sa/dt) B^T + C (Sg/dt) C^T + Si dt
#pragma unroll
  for (int m = 0; m < le.kM2; ++m) {
    const int row = le.row[m], col = le.col[m];
    const int a = row / 3, i = row - 3 * a, c = col / 3, j = col - 3 * c;
    const T* x = &s.X[9 * row];
    const T* L = &r.L[c][3 * j];
    // the noise terms do not wait on X
    const T noise = fma(b_of(a, dt, dt22) * b_of(c, dt, dt22), r.Ma[3 * i + j],
                        fma(a == 0 && c == 0 ? dt * dt : T(0),
                            r.Mg[3 * i + j],
                            (a == 1 && c == 1 ? dt : T(0)) *
                                s.Q[18 + 3 * i + j]));
    const T head = fma(x[1], L[1], x[0] * L[0]);
    const T tail = fma(beta_of(c, dt), x[6 + j],
                       fma(alpha_of<T>(c), x[3 + j], noise));
    const T acc = head + fma(x[2], L[2], tail);
    *(le.store2[m] ? &s.P[9 * row + col] : &s.sink) = acc;
    *(le.store2[m] ? &s.P[9 * col + row] : &s.sink) = acc;
  }
  carry_sync<NL>();
}

template <int NL, typename T>
PREINT_HD void propagate_chunk(int lane, const LaneEntries<NL>& le,
                               int64_t ch, int64_t N, Carry<T>& s) {
  const int steps = steps_of<T>(ch, N);
  for (int k = 0; k < steps; ++k)
    propagate_step(lane, le, s.rec[ch & 1][k], s,
                   static_cast<int>((ch * kChunk + k) & 1));
}

// The carry's start and the covariances.
template <typename T>
PREINT_HD void init_carry(int lane, int nlanes, const T* __restrict__ covs,
                          Carry<T>& s) {
  // X's block (2, 1) is never formed, and read only times zero
  for (int e = lane; e < 81; e += nlanes) s.P[e] = s.X[e] = T(0);
  for (int e = lane; e < 54; e += nlanes) s.H[0][e] = T(0);
  for (int e = lane; e < 27; e += nlanes) s.Q[e] = covs[e];
  for (int e = lane; e < 6; e += nlanes) s.pv[0][e] = T(0);
}

// The carry's end: p, v, H and cov (the theta lane writes theta and dT).
template <typename T>
PREINT_HD void store_carry(int lane, int nlanes, int64_t N,
                           const Carry<T>& s, T* __restrict__ zeta_out,
                           T* __restrict__ H_out, T* __restrict__ cov_out) {
  const int fin = static_cast<int>(N & 1);
  for (int e = lane; e < 6; e += nlanes) zeta_out[3 + e] = s.pv[fin][e];
  for (int e = lane; e < 54; e += nlanes) H_out[e] = s.H[fin][e];
  for (int e = lane; e < 81; e += nlanes) cov_out[e] = s.P[e];
}

#ifndef __CUDACC__
// One segment of N samples on the host: the kernel's pipeline, its roles
// taken in turn within each chunk (lane = 0, nlanes = 1).
template <typename T>
void tangent_segment(int lane, int nlanes, const T* __restrict__ acc,
                     const T* __restrict__ gyr, const T* __restrict__ dts,
                     int64_t N, const T* __restrict__ bias,
                     const T* __restrict__ covs, Carry<T>& s,
                     T* __restrict__ zeta_out, T* __restrict__ H_out,
                     T* __restrict__ cov_out, T* __restrict__ dT_out) {
  init_carry(lane, nlanes, covs, s);
  const int64_t nch = (N + kChunk - 1) / kChunk;
  if (nch > 0) load_chunk(lane, nlanes, acc, gyr, dts, N, bias, 0, s);
  LaneEntries<1> le;
  lane_entries(0, le);
  T th[3] = {T(0), T(0), T(0)};
  T total = T(0);
  for (int64_t j = 0; j < nch + 2; ++j) {
    if (j < nch) theta_chunk(j, N, s, th, total);
    if (j + 1 < nch)
      load_chunk(lane, nlanes, acc, gyr, dts, N, bias, j + 1, s);
    if (j >= 1 && j <= nch) coeff_chunk(lane, nlanes, j - 1, N, s);
    if (j >= 2) propagate_chunk(0, le, j - 2, N, s);
  }
  for (int i = 0; i < 3; ++i) zeta_out[i] = th[i];
  *dT_out = total;
  store_carry(lane, nlanes, N, s, zeta_out, H_out, cov_out);
}
#endif

}  // namespace preint

#ifdef __CUDACC__
namespace {

// warp 0: theta; warp 1: coefficients; warps 2-3: the carry
constexpr int kCarryLanes = 64;
constexpr int kThreads = 64 + kCarryLanes;
constexpr int kMinBlocks = 3;   // blocks an SM must hold (__launch_bounds__)

// Timing hooks of the body below, around each role's share of a chunk:
// nothing in the kernel; tools/probes/preint_roles.cu reads clock64() in
// them.
struct NoTimer {
  __device__ __forceinline__ void loop_start() {}
  __device__ __forceinline__ void role_start() {}
  __device__ __forceinline__ void role_end() {}
  __device__ __forceinline__ void loop_end() {}
};

// The block's work on segment `seg`, its roles by warp.
template <typename T, typename Timer>
__device__ __forceinline__ void tangent_block(
    const T* __restrict__ accs, const T* __restrict__ gyros,
    const T* __restrict__ dts, const T* __restrict__ bias,
    const T* __restrict__ covs, T* __restrict__ zeta, T* __restrict__ H,
    T* __restrict__ cov, T* __restrict__ dT, int64_t N, int64_t seg,
    preint::Carry<T>& s, Timer& timer) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = static_cast<int>(threadIdx.x) - 64;   // the carry's lane
  const T* acc = accs + seg * N * 3;
  const T* gyr = gyros + seg * N * 3;
  const T* dtv = dts + seg * N;
  const T* b = bias + seg * 6;
  const int64_t nch = (N + preint::kChunk - 1) / preint::kChunk;
  if (warp >= 2) preint::init_carry(cl, kCarryLanes, covs, s);
  if (warp == 1 && nch > 0)
    preint::load_chunk(lane, 32, acc, gyr, dtv, N, b, 0, s);
  __syncthreads();
  preint::LaneEntries<kCarryLanes> le;
  if (warp >= 2) preint::lane_entries(cl, le);
  T th[3] = {T(0), T(0), T(0)};
  T total = T(0);
  timer.loop_start();
  for (int64_t j = 0; j < nch + 2; ++j) {
    timer.role_start();
    if (warp == 0) {
      if (lane == 0 && j < nch) preint::theta_chunk(j, N, s, th, total);
    } else if (warp == 1) {
      if (j + 1 < nch)
        preint::load_chunk(lane, 32, acc, gyr, dtv, N, b, j + 1, s);
      if (j >= 1 && j <= nch) preint::coeff_chunk(lane, 32, j - 1, N, s);
    } else if (j >= 2) {
      preint::propagate_chunk(cl, le, j - 2, N, s);
    }
    timer.role_end();
    __syncthreads();   // once a chunk: the roles hand their buffers on
  }
  timer.loop_end();
  if (warp == 0 && lane == 0) {
    for (int i = 0; i < 3; ++i) zeta[seg * 9 + i] = th[i];
    dT[seg] = total;
  } else if (warp >= 2) {
    preint::store_carry(cl, kCarryLanes, N, s, zeta + seg * 9, H + seg * 54,
                        cov + seg * 81);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
preint_tangent_kernel(const T* __restrict__ accs, const T* __restrict__ gyros,
                      const T* __restrict__ dts, const T* __restrict__ bias,
                      const T* __restrict__ covs, T* __restrict__ zeta,
                      T* __restrict__ H, T* __restrict__ cov,
                      T* __restrict__ dT, int64_t N) {
  __shared__ preint::Carry<T> s;
  NoTimer timer;
  tangent_block<T>(accs, gyros, dts, bias, covs, zeta, H, cov, dT, N,
                   blockIdx.x, s, timer);
}

template <typename T>
int launch(const void* accs, const void* gyros, const void* dts,
           const void* bias, const void* covs, void* zeta, void* H, void* cov,
           void* dT, int64_t S, int64_t N, void* stream) {
  if (S > 0) {
    preint_tangent_kernel<T>
        <<<static_cast<unsigned int>(S), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(accs), static_cast<const T*>(gyros),
            static_cast<const T*>(dts), static_cast<const T*>(bias),
            static_cast<const T*>(covs), static_cast<T*>(zeta),
            static_cast<T*>(H), static_cast<T*>(cov), static_cast<T*>(dT), N);
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
