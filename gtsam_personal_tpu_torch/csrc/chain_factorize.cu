// Block-Thomas factorization of a block-tridiagonal SPD system: for the
// diagonal blocks D_i and the couplings O_i (O_i couples i and i+1),
//
//   Uinv_i = inv(D_i - O_{i-1}^T Uinv_{i-1} O_{i-1}),   Uinv_{-1} = 0.
//
// Replaces the lax.scan of gtsam_personal_tpu/nonlinear/isam2.py:
// _chain_factorize (the scan at :904-913) and _chain_factorize_m (:811-820);
// neither is a Pallas kernel: XLA compiles the scan into one program, and
// eager PyTorch has no form of it but a Python loop of `cap` steps. Built for
// sm_90a by gtsam_personal_tpu_torch/ops/_build.py and called through
// gtsam_personal_tpu_torch/ops/chain.py:chain_factorize, which also holds
// the plain version. Damping, the identity blocks of the padding and the
// masking of O are applied by the caller (ops/chain.py:chain_prepare).
//
// Layout: D, O and Uinv are [cap, d, d], contiguous, row-major blocks; D
// and O start on a 16-byte boundary (the wrapper sees to it).
//
// What bounds it: not bytes (3 arrays of cap * d * d entries, 1.8 MB at
// cap = 16384, d = 3 in float32: half a microsecond of HBM time) and not
// operations (about 6 d^3 flop per step), but the dependent chain: step i
// needs Uinv_{i-1}, so the time is cap times the latency of one step, and
// one block of one SM does all the work. The design keeps everything but
// the chain off the chain's warp. One block of three warps, each with one
// role for the whole launch:
//
// - warp 1, the producer, brings D and O into a ring of kStages tiles of
//   kTile steps in shared memory: one cp.async.bulk per array and tile,
//   signalled on the tile's mbarrier (a ragged last tile is copied by the
//   warp's lanes and signalled the same way);
// - warp 2, the drain, writes each finished tile of Uinv out of a second
//   ring, coalesced, and hands the slot back on an mbarrier;
// - warp 0 walks the chain. It waits only on the mbarrier of the tile it
//   is about to use, about once every kTile steps, and joins no block-wide
//   barrier inside the loop.
//
// The chain's step, by block size:
//
// d <= 4 (chain:se2, point2+vel2): one thread, Uinv, O, T and A in
// registers, every loop unrolled, two steps an iteration so that the
// registers alternate without copies. D_{i+1} and O_i are read from shared
// memory while step i computes. A is symmetric: its upper triangle is
// formed and mirrored. The products are explicit fma(), and the inverse is
// the adjugate over one reciprocal (d = 4 expands by 2 x 2 minors).
//
// d > 4 (chain:se3, se3+vel3+imu_bias): one warp, lane c holding column c
// of the working block in registers. Column c of -A_i is formed from
// Uinv_{i-1} (kept row-major in shared memory, read as broadcast rows) and
// O_{i-1}; then the sweep operator inverts it in d pivots. At pivot p every
// lane publishes its entry of row p (one store), the lane that owns the
// pivot publishes the pivot's reciprocal, and after one __syncwarp() every
// lane updates its own column: no __syncthreads() in a step, and each
// reciprocal is computed once.
//
// The reciprocals: MUFU.RCP and Newton steps (one in float32, two in
// float64); __frcp_rn and __drcp_rn take as long as the division they would
// replace (see rcp).
//
// Neither pivots: A is symmetric positive definite (a Schur complement of an
// SPD tridiagonal matrix), for which elimination in the given order is
// stable. The library is built with -fmad=false (see landmark_block_solve.cu);
// the products here call fma() explicitly, which that flag leaves alone:
// these kernels are not held bitwise to the plain version (torch.linalg.inv
// pivots), and a fused multiply-add halves the dependent latency.
//
// Measured on an NVIDIA H100 80GB HBM3 (power limit 700 W) by CUDA events
// (tools/time_kernels.py, PERF.md section 6): in float32 at cap 16384,
// d = 3 2.20 ms (134 ns a step; 3.38 ms before this design), d = 4 3.09
// ms (6.21), d = 6 8.93 ms (22.5); in float64 at cap 512, d = 15 1.18 ms
// (2.03). No instantiation has a stack frame.
//
// The step arithmetic (serial_step, and the warp's warp_form, warp_publish,
// warp_pivot and warp_store) is plain C++ and compiles for the host as well,
// where chain_host runs it with the lanes taken in turn.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CHAIN_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define CHAIN_HD inline
#endif

namespace chainf {

#ifndef __CUDACC__
using std::fma;
#endif

constexpr int kSerialMaxD = 4;

// 1/x. In float32 on the device: MUFU.RCP and one Newton step, within an
// ulp of 1/x; __frcp_rn, which rounds correctly, takes the division's slow
// path check and as long as a division (66.5 cycles on the H100, PERF.md
// section 6).
CHAIN_HD float rcp(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
#else
  return 1.0f / x;
#endif
}

// In float64 on the device: MUFU.RCP64H and two Newton steps (__drcp_rn:
// 62.5 cycles, as long as a division).
CHAIN_HD double rcp(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
#else
  return 1.0 / x;
#endif
}

// a b - c d
template <typename T>
CHAIN_HD T cross(T a, T b, T c, T d) {
  return fma(a, b, -(c * d));
}

// A^{-1} of a symmetric d x d matrix (d = 3, 4) held in registers, by the
// adjugate: the upper triangle is computed and mirrored.
template <typename T, int D>
CHAIN_HD void small_inverse(const T (&A)[D * D], T (&U)[D * D]) {
  if constexpr (D == 3) {
    const T c00 = cross(A[4], A[8], A[5], A[5]);
    const T c01 = cross(A[2], A[5], A[1], A[8]);
    const T c02 = cross(A[1], A[5], A[2], A[4]);
    const T inv = rcp(fma(A[0], c00, fma(A[1], c01, A[2] * c02)));
    U[0] = c00 * inv;
    U[1] = U[3] = c01 * inv;
    U[2] = U[6] = c02 * inv;
    U[4] = cross(A[0], A[8], A[2], A[2]) * inv;
    U[5] = U[7] = cross(A[1], A[2], A[0], A[5]) * inv;
    U[8] = cross(A[0], A[4], A[1], A[1]) * inv;
  } else {
    static_assert(D == 4, "the adjugate is written for d = 3 and 4");
    // 2 x 2 minors of rows 0-1 (s) and rows 2-3 (c)
    const T s0 = cross(A[0], A[5], A[4], A[1]);
    const T s1 = cross(A[0], A[6], A[4], A[2]);
    const T s2 = cross(A[0], A[7], A[4], A[3]);
    const T s3 = cross(A[1], A[6], A[5], A[2]);
    const T s4 = cross(A[1], A[7], A[5], A[3]);
    const T s5 = cross(A[2], A[7], A[6], A[3]);
    const T c5 = cross(A[10], A[15], A[14], A[11]);
    const T c4 = cross(A[9], A[15], A[13], A[11]);
    const T c3 = cross(A[9], A[14], A[13], A[10]);
    const T c2 = cross(A[8], A[15], A[12], A[11]);
    const T c1 = cross(A[8], A[14], A[12], A[10]);
    const T c0 = cross(A[8], A[13], A[12], A[9]);
    const T det = fma(s0, c5, fma(-s1, c4, fma(s2, c3, fma(s3, c2,
                  fma(-s4, c1, s5 * c0)))));
    const T inv = rcp(det);
    // entry (r, c) is (-1)^(r+c) times the minor of (c, r)
    U[0] = fma(A[5], c5, fma(-A[6], c4, A[7] * c3)) * inv;
    U[1] = U[4] = fma(-A[1], c5, fma(A[2], c4, -(A[3] * c3))) * inv;
    U[2] = U[8] = fma(A[13], s5, fma(-A[14], s4, A[15] * s3)) * inv;
    U[3] = U[12] = fma(-A[9], s5, fma(A[10], s4, -(A[11] * s3))) * inv;
    U[5] = fma(A[0], c5, fma(-A[2], c2, A[3] * c1)) * inv;
    U[6] = U[9] = fma(-A[12], s5, fma(A[14], s2, -(A[15] * s1))) * inv;
    U[7] = U[13] = fma(A[8], s5, fma(-A[10], s2, A[11] * s1)) * inv;
    U[10] = fma(A[12], s4, fma(-A[13], s2, A[15] * s0)) * inv;
    U[11] = U[14] = fma(-A[8], s4, fma(A[9], s2, -(A[11] * s0))) * inv;
    U[15] = fma(A[8], s3, fma(-A[9], s1, A[10] * s0)) * inv;
  }
}

// One step of the chain in one thread: U <- inv(Dc - Op^T U Op), with U and
// Op (= O_{i-1}) zero at step 0. A is symmetric: its upper triangle is
// formed (from Dc's upper triangle) and mirrored.
template <typename T, int D>
CHAIN_HD void serial_step(const T (&Op)[D * D], const T (&Dc)[D * D],
                          T (&U)[D * D]) {
  T Tm[D * D], A[D * D];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      T acc = U[r * D] * Op[c];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = fma(U[r * D + k], Op[k * D + c], acc);
      Tm[r * D + c] = acc;
    }
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = r; c < D; ++c) {
      T acc = Dc[r * D + c];
#pragma unroll
      for (int k = 0; k < D; ++k) acc = fma(-Op[k * D + r], Tm[k * D + c], acc);
      A[r * D + c] = A[c * D + r] = acc;
    }
  small_inverse<T, D>(A, U);
}

// The warp's shared scratch for d > 4: Uinv_{i-1} row-major with rows of
// kPad entries, and the published pivot column (its reciprocal at [D]),
// double-buffered by pivot parity.
template <typename T, int D>
struct WarpScratch {
  static constexpr int kPad = ((D + 1) * sizeof(T) + 15) / 16 * 16 / sizeof(T);
  alignas(16) T Us[D * kPad];
  alignas(16) T col[2][kPad];
};

// Lane `c` forms column c of -A_i = O_{i-1}^T Uinv_{i-1} O_{i-1} - D_i; Op
// is O_{i-1}, or null at step 0.
template <typename T, int D>
CHAIN_HD void warp_form(int c, const T* Dp, const T* Op,
                        const WarpScratch<T, D>& s, T (&A)[D]) {
#pragma unroll
  for (int r = 0; r < D; ++r) A[r] = -Dp[r * D + c];
  if (Op == nullptr) return;
  T o[D], Tc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) o[k] = Op[k * D + c];
  // column c of Uinv_{i-1} O_{i-1}, row by row of Uinv
#pragma unroll
  for (int r = 0; r < D; ++r) {
    T acc = s.Us[r * s.kPad] * o[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = fma(s.Us[r * s.kPad + k], o[k], acc);
    Tc[r] = acc;
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int r = 0; r < D; ++r) A[r] = fma(Op[k * D + r], Tc[k], A[r]);
}

// Pivot p of the sweep: every lane publishes its entry of row p, which is
// column p of the symmetric working matrix, and the lane that owns the
// pivot publishes its reciprocal.
template <typename T, int D>
CHAIN_HD void warp_publish(int lane, int p, const T (&A)[D], T* col) {
  if (lane < D) col[lane] = A[p];
  if (lane == p) col[D] = rcp(A[p]);
}

// Pivot p of the sweep operator, applied by lane `c` to its column from
// the published row p: a_pp <- -1/a_pp, a_rp <- a_rp/a_pp, a_pc <-
// a_pc/a_pp, a_rc <- a_rc - a_rp a_pc/a_pp. The sweep keeps the matrix
// symmetric, and sweeping every pivot of -A leaves A^{-1}.
template <typename T, int D>
CHAIN_HD void warp_pivot(int c, int p, T (&A)[D], const T* col) {
  const T piv = col[D];
  const bool own = c == p;
  const T sc = own ? -piv : A[p] * piv;
#pragma unroll
  for (int r = 0; r < D; ++r)
    if (r != p) A[r] = fma(-col[r], sc, own ? T(0) : A[r]);
  A[p] = sc;
}

// Lane `c` stores column c of Uinv_i: into the carried row-major copy and
// into the output block `Uo` (row-major).
template <typename T, int D>
CHAIN_HD void warp_store(int c, const T (&A)[D], WarpScratch<T, D>& s,
                         T* Uo) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    s.Us[r * s.kPad + c] = A[r];
    Uo[r * D + c] = A[r];
  }
}

#ifndef __CUDACC__
// The kernel's arithmetic on the host, step by step, the lanes of the warp
// taken in turn between its __syncwarp()s.
template <typename T, int D>
void chain_host(const T* Dg, const T* Og, T* Ug, int64_t cap) {
  constexpr int DD = D * D;
  if constexpr (D <= kSerialMaxD) {
    T U[DD] = {}, Op[DD] = {}, Dc[DD];
    for (int64_t i = 0; i < cap; ++i) {
      for (int e = 0; e < DD; ++e) Dc[e] = Dg[i * DD + e];
      serial_step<T, D>(Op, Dc, U);
      for (int e = 0; e < DD; ++e) {
        Ug[i * DD + e] = U[e];
        Op[e] = Og[i * DD + e];
      }
    }
  } else {
    WarpScratch<T, D> s;
    T A[D][D];
    for (int64_t i = 0; i < cap; ++i) {
      const T* Op = i > 0 ? Og + (i - 1) * DD : nullptr;
      for (int c = 0; c < D; ++c) warp_form<T, D>(c, Dg + i * DD, Op, s, A[c]);
      for (int p = 0; p < D; ++p) {
        for (int c = 0; c < D; ++c) warp_publish<T, D>(c, p, A[c], s.col[p & 1]);
        for (int c = 0; c < D; ++c) warp_pivot<T, D>(c, p, A[c], s.col[p & 1]);
      }
      for (int c = 0; c < D; ++c) warp_store<T, D>(c, A[c], s, Ug + i * DD);
    }
  }
}
#endif

}  // namespace chainf

#ifdef __CUDACC__
namespace {

using chainf::kSerialMaxD;

constexpr int kStages = 4;
constexpr int kThreads = 96;   // warp 0: the chain; 1: producer; 2: drain

// Steps per tile, a multiple of 4 so that a tile of d*d entries per step is
// a multiple of 16 bytes (cp.async.bulk's unit) for every d and type.
constexpr int tile_steps(int d) { return d <= 4 ? 32 : d <= 6 ? 16 : 4; }

template <typename T, int D>
struct Ring {
  static constexpr int DD = D * D;
  static constexpr int kTile = tile_steps(D);
  alignas(16) T Din[kStages][kTile * DD];
  alignas(16) T Oin[kStages][kTile * DD];   // O_i at step i of the tile
  alignas(16) T Uout[kStages][kTile * DD];
  chainf::WarpScratch<T, D> scratch;
  uint64_t full[kStages];    // a tile of D and O has landed
  uint64_t empty[kStages];   // the chain is done with an input slot
  uint64_t ufull[kStages];   // a tile of Uinv is ready to be written
  uint64_t uempty[kStages];  // the drain is done with an output slot
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int D>
__device__ __forceinline__ int steps_of(int64_t tile, int64_t cap) {
  const int64_t left = cap - tile * Ring<T, D>::kTile;
  return static_cast<int>(left < Ring<T, D>::kTile ? left
                                                   : Ring<T, D>::kTile);
}

template <typename T, int D>
__device__ void produce(Ring<T, D>& ring, const T* __restrict__ Dg,
                        const T* __restrict__ Og, int64_t cap, int lane) {
  constexpr int DD = D * D, kTile = Ring<T, D>::kTile;
  const int64_t ntiles = (cap + kTile - 1) / kTile;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int st = static_cast<int>(t % kStages);
    if (t >= kStages)
      bar_wait(&ring.empty[st], static_cast<uint32_t>((t / kStages - 1) & 1));
    const int steps = steps_of<T, D>(t, cap);
    const int64_t base = t * kTile * DD;
    if (steps == kTile) {
      if (lane == 0) {
        constexpr uint32_t bytes = kTile * DD * sizeof(T);
        bar_expect(&ring.full[st], 2 * bytes);
        bulk_load(ring.Din[st], Dg + base, bytes, &ring.full[st]);
        bulk_load(ring.Oin[st], Og + base, bytes, &ring.full[st]);
      }
    } else {   // the ragged last tile
      for (int e = lane; e < steps * DD; e += 32) {
        ring.Din[st][e] = Dg[base + e];
        ring.Oin[st][e] = Og[base + e];
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) bar_arrive(&ring.full[st]);
    }
  }
}

template <typename T, int D>
__device__ void drain(Ring<T, D>& ring, T* __restrict__ Ug, int64_t cap,
                      int lane) {
  constexpr int DD = D * D, kTile = Ring<T, D>::kTile;
  const int64_t ntiles = (cap + kTile - 1) / kTile;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int st = static_cast<int>(t % kStages);
    bar_wait(&ring.ufull[st], static_cast<uint32_t>((t / kStages) & 1));
    const int n = steps_of<T, D>(t, cap) * DD;
    T* out = Ug + t * kTile * DD;
    for (int e = lane; e < n; e += 32) out[e] = ring.Uout[st][e];
    __syncwarp();
    if (lane == 0) bar_arrive(&ring.uempty[st]);
  }
}

// d <= 4: lane 0 of the chain's warp alone, everything in registers. Step
// g takes D_g and O_{g-1} and reads D_{g+1} and O_g while it computes; the
// ring is read as one circular buffer of kTile * kStages steps.
template <typename T, int D>
__device__ __forceinline__ void serial_half(Ring<T, D>& ring, int64_t g,
                                            int64_t cap, T (&U)[D * D],
                                            const T (&Dc)[D * D],
                                            const T (&Op)[D * D],
                                            T (&Dn)[D * D], T (&On)[D * D]) {
  constexpr int DD = D * D, kTile = Ring<T, D>::kTile;
  constexpr int kRing = kTile * kStages;
  const T* Dr = &ring.Din[0][0];
  const T* Or = &ring.Oin[0][0];
  T* Ur = &ring.Uout[0][0];
  const int64_t t = g / kTile;
  if (g % kTile == 0 && t >= kStages)
    bar_wait(&ring.uempty[t % kStages], static_cast<uint32_t>((t / kStages - 1) & 1));
  if (g + 1 < cap) {
    if ((g + 1) % kTile == 0)
      bar_wait(&ring.full[(t + 1) % kStages],
               static_cast<uint32_t>(((t + 1) / kStages) & 1));
    const int nx = static_cast<int>((g + 1) % kRing) * DD;
#pragma unroll
    for (int e = 0; e < DD; ++e) Dn[e] = Dr[nx + e];
  }
  const int at = static_cast<int>(g % kRing) * DD;
#pragma unroll
  for (int e = 0; e < DD; ++e) On[e] = Or[at + e];
  chainf::serial_step<T, D>(Op, Dc, U);
#pragma unroll
  for (int e = 0; e < DD; ++e) Ur[at + e] = U[e];
  if ((g + 1) % kTile == 0 || g + 1 == cap) {
    bar_arrive(&ring.ufull[t % kStages]);
    bar_arrive(&ring.empty[t % kStages]);   // its D and O are in registers
  }
}

template <typename T, int D>
__device__ void chain_serial(Ring<T, D>& ring, int64_t cap) {
  constexpr int DD = D * D;
  T U[DD], DA[DD], OA[DD], DB[DD], OB[DD];
#pragma unroll
  for (int e = 0; e < DD; ++e) U[e] = OA[e] = T(0);
  bar_wait(&ring.full[0], 0);
#pragma unroll
  for (int e = 0; e < DD; ++e) DA[e] = ring.Din[0][e];
  // two steps an iteration, so that the registers alternate without copies
  for (int64_t g = 0; g < cap; g += 2) {
    serial_half<T, D>(ring, g, cap, U, DA, OA, DB, OB);
    if (g + 1 < cap) serial_half<T, D>(ring, g + 1, cap, U, DB, OB, DA, OA);
  }
}

// d > 4: the whole chain's warp, lane c holding column c
template <typename T, int D>
__device__ void chain_warp(Ring<T, D>& ring, int64_t cap, int lane) {
  constexpr int DD = D * D, kTile = Ring<T, D>::kTile;
  const int64_t ntiles = (cap + kTile - 1) / kTile;
  const int c = lane < D ? lane : D - 1;    // lanes past d mirror the last
  T A[D];
  for (int64_t t = 0; t < ntiles; ++t) {
    const int st = static_cast<int>(t % kStages);
    const int prev = static_cast<int>((t + kStages - 1) % kStages);
    const int steps = steps_of<T, D>(t, cap);
    bar_wait(&ring.full[st], static_cast<uint32_t>((t / kStages) & 1));
    if (t >= kStages)
      bar_wait(&ring.uempty[st], static_cast<uint32_t>((t / kStages - 1) & 1));
    for (int s = 0; s < steps; ++s) {
      const T* Op = s > 0 ? &ring.Oin[st][(s - 1) * DD]
                          : (t > 0 ? &ring.Oin[prev][(kTile - 1) * DD]
                                   : nullptr);
      chainf::warp_form<T, D>(c, &ring.Din[st][s * DD], Op, ring.scratch, A);
#pragma unroll
      for (int p = 0; p < D; ++p) {
        T* col = ring.scratch.col[p & 1];
        chainf::warp_publish<T, D>(lane, p, A, col);
        __syncwarp();
        chainf::warp_pivot<T, D>(c, p, A, col);
      }
      if (lane < D)
        chainf::warp_store<T, D>(c, A, ring.scratch, &ring.Uout[st][s * DD]);
      __syncwarp();
      // the first step of a tile was the last to read the previous slot
      if (s == 0 && t > 0 && lane == 0) bar_arrive(&ring.empty[prev]);
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) bar_arrive(&ring.ufull[st]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
chain_factorize_kernel(const T* __restrict__ Dg, const T* __restrict__ Og,
                       T* __restrict__ Ug, int64_t cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ring<T, D>& ring = *reinterpret_cast<Ring<T, D>*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(&ring.full[st], 1);
      bar_init(&ring.empty[st], 1);
      bar_init(&ring.ufull[st], 1);
      bar_init(&ring.uempty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the only block-wide barrier: before the roles split
  if (warp == 1) {
    produce<T, D>(ring, Dg, Og, cap, lane);
  } else if (warp == 2) {
    drain<T, D>(ring, Ug, cap, lane);
  } else if constexpr (D <= kSerialMaxD) {
    if (lane == 0) chain_serial<T, D>(ring, cap);
  } else {
    chain_warp<T, D>(ring, cap, lane);
  }
}

template <typename T, int D>
int launch_d(const void* Dg, const void* Og, void* Ug, int64_t cap,
             cudaStream_t stream) {
  constexpr int bytes = sizeof(Ring<T, D>);
  auto kernel = chain_factorize_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<1, kThreads, bytes, stream>>>(static_cast<const T*>(Dg),
                                         static_cast<const T*>(Og),
                                         static_cast<T*>(Ug), cap);
  return static_cast<int>(cudaGetLastError());
}

// -1: a block size that is not instantiated (the wrapper raises).
template <typename T>
int launch(const void* Dg, const void* Og, void* Ug, int64_t cap, int d,
           void* stream) {
  if (cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 3: return launch_d<T, 3>(Dg, Og, Ug, cap, s);    // chain:se2
    case 4: return launch_d<T, 4>(Dg, Og, Ug, cap, s);    // point2+vel2
    case 6: return launch_d<T, 6>(Dg, Og, Ug, cap, s);    // chain:se3
    case 15: return launch_d<T, 15>(Dg, Og, Ug, cap, s);  // se3+vel3+imu_bias
    default: return -1;
  }
}

}  // namespace

// C entry points: return cudaGetLastError() after the launch (0 = success),
// or -1 for a block size d that is not one of 3, 4, 6, 15.
extern "C" int chain_factorize_f32(const void* D, const void* O, void* Uinv,
                                   int64_t cap, int d, void* stream) {
  return launch<float>(D, O, Uinv, cap, d, stream);
}

extern "C" int chain_factorize_f64(const void* D, const void* O, void* Uinv,
                                   int64_t cap, int d, void* stream) {
  return launch<double>(D, O, Uinv, cap, d, stream);
}
#endif  // __CUDACC__
