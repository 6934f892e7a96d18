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
// Layout: D, O and Uinv are [cap, d, d], contiguous, row-major blocks.
//
// What bounds it: not bytes (3 arrays of cap * d * d entries, 1.8 MB at
// cap = 16384, d = 3 in float32: half a microsecond of HBM time) and not
// operations (about 6 d^3 flop per step), but the dependent chain: step i
// needs Uinv_{i-1}, so the time is cap times the latency of one step, and
// one block of one SM does all the work. The design shortens the step and
// keeps global memory out of it altogether: D and O of the next tile of
// steps are brought into shared memory with cp.async while the current
// tile is worked on, and the tile's Uinv blocks go to shared memory and are
// written out, coalesced, while the next tile is worked on. Two kernels
// walk the tiles, chosen by the block size:
//
// d <= 4 (chain:se2, point2+vel2), `chain_factorize_serial`: one thread
// walks the chain with Uinv, O, T and A in registers, every loop unrolled:
// a step is about 6 d^3 multiply-adds and one inverse, with no barrier and
// no shared-memory round trip on the critical path; the other lanes of its
// warp only move the tiles. d = 3 inverts by the adjugate (one division),
// d = 4 by Gauss-Jordan (d divisions).
//
// d > 4 (chain:se3, se3+vel3+imu_bias), `chain_factorize_block`: the blocks
// no longer fit one thread's registers, so one thread per entry (r, c), the
// carried Uinv and the scratch blocks in shared memory, and a step is 2 + d
// phases with one __syncthreads() each: T = Uinv O, then A = D - O^T T,
// then d pivots of an in-place Gauss-Jordan inverse that ping-pongs between
// two buffers (one barrier per pivot, not two).
//
// Measured on an NVIDIA H100 80GB HBM3 (power limit 700 W) at cap = 16384
// in float32, by CUDA events around 20 launches (chip_smoke.py phase 8):
// 3.38 ms at d = 3 (206 ns a step), 22.5 ms at d = 6 (1.37 us a step).
//
// Neither pivots: A is symmetric positive definite (a Schur complement of an
// SPD tridiagonal matrix), for which elimination in the given order is
// stable.
// The library is built with -fmad=false (see landmark_block_solve.cu); the
// dot products here call fma() explicitly, which that flag leaves alone:
// these kernels are not held bitwise to the plain version (torch.linalg.inv
// pivots), and a fused multiply-add halves the dependent latency.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSerialMaxD = 4;

// Steps per tile: three double-buffered tiles of d*d entries per step must
// fit the 48 KB of static shared memory in float64.
constexpr int tile_steps(int d) { return d <= 4 ? 32 : d <= 6 ? 16 : 2; }

// The tiles of one kernel: D_i, O_{i-1} and Uinv_i of kTile steps, twice.
template <typename T, int D>
struct Tiles {
  static constexpr int DD = D * D;
  static constexpr int kTile = tile_steps(D);
  T Din[2][kTile * DD];
  T Oin[2][kTile * DD];    // O_{i-1} at step i; zero at step 0
  T Uout[2][kTile * DD];

  // all threads: start the copies of tile `tile` into buffer `buf`
  __device__ void stage(const T* __restrict__ Dg, const T* __restrict__ Og,
                        int64_t tile, int buf, int64_t cap) {
    const int64_t base = tile * kTile;
    for (int e = threadIdx.x; e < kTile * DD; e += blockDim.x) {
      const int64_t step = base + e / DD;
      if (step >= cap) break;
      __pipeline_memcpy_async(&Din[buf][e], &Dg[base * DD + e], sizeof(T));
      if (step >= 1) {     // O_{step-1}: the same offset, one block earlier
        __pipeline_memcpy_async(&Oin[buf][e], &Og[(base - 1) * DD + e],
                                sizeof(T));
      } else {
        Oin[buf][e] = T(0);
      }
    }
    __pipeline_commit();
  }

  // all threads: write the Uinv blocks of tile `tile` out of buffer `buf`
  __device__ void flush(T* __restrict__ Ug, int64_t tile, int buf,
                        int64_t cap) const {
    const int64_t base = tile * kTile;
    for (int e = threadIdx.x; e < kTile * DD; e += blockDim.x) {
      if (base + e / DD >= cap) break;
      Ug[base * DD + e] = Uout[buf][e];
    }
  }

  __device__ static int steps_of(int64_t tile, int64_t cap) {
    const int64_t left = cap - tile * kTile;
    return static_cast<int>(left < kTile ? left : kTile);
  }
};

// A^{-1} of a symmetric positive definite d x d matrix held in registers.
template <typename T, int D>
__device__ __forceinline__ void spd_inverse(const T (&A)[D * D],
                                            T (&U)[D * D]) {
  if constexpr (D == 3) {
    const T c00 = A[4] * A[8] - A[5] * A[7];
    const T c01 = A[5] * A[6] - A[3] * A[8];
    const T c02 = A[3] * A[7] - A[4] * A[6];
    const T inv = T(1) / fma(A[0], c00, fma(A[1], c01, A[2] * c02));
    U[0] = c00 * inv;
    U[1] = (A[2] * A[7] - A[1] * A[8]) * inv;
    U[2] = (A[1] * A[5] - A[2] * A[4]) * inv;
    U[3] = c01 * inv;
    U[4] = (A[0] * A[8] - A[2] * A[6]) * inv;
    U[5] = (A[2] * A[3] - A[0] * A[5]) * inv;
    U[6] = c02 * inv;
    U[7] = (A[1] * A[6] - A[0] * A[7]) * inv;
    U[8] = (A[0] * A[4] - A[1] * A[3]) * inv;
  } else {
#pragma unroll
    for (int e = 0; e < D * D; ++e) U[e] = A[e];
#pragma unroll
    for (int p = 0; p < D; ++p) {            // Gauss-Jordan, in place
      const T piv = T(1) / U[p * D + p];
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r == p) continue;
        const T f = U[r * D + p] * piv;
#pragma unroll
        for (int c = 0; c < D; ++c)
          if (c != p) U[r * D + c] = fma(-f, U[p * D + c], U[r * D + c]);
        U[r * D + p] = -f;
      }
#pragma unroll
      for (int c = 0; c < D; ++c)
        if (c != p) U[p * D + c] *= piv;
      U[p * D + p] = piv;
    }
  }
}

template <typename T, int D>
__global__ void chain_factorize_serial(const T* __restrict__ Dg,
                                       const T* __restrict__ Og,
                                       T* __restrict__ Ug, int64_t cap) {
  constexpr int DD = D * D;
  __shared__ Tiles<T, D> tiles;
  const int64_t ntiles = (cap + tiles.kTile - 1) / tiles.kTile;
  T U[DD];
#pragma unroll
  for (int e = 0; e < DD; ++e) U[e] = T(0);
  tiles.stage(Dg, Og, 0, 0, cap);
  for (int64_t tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    __pipeline_wait_prior(0);
    __syncthreads();   // this tile has landed; the last one is worked off
    if (tile + 1 < ntiles) tiles.stage(Dg, Og, tile + 1, buf ^ 1, cap);
    if (tile > 0) tiles.flush(Ug, tile - 1, buf ^ 1, cap);
    if (threadIdx.x != 0) continue;
    const int steps = tiles.steps_of(tile, cap);
    T O[DD], On[DD];
#pragma unroll
    for (int e = 0; e < DD; ++e) On[e] = tiles.Oin[buf][e];
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int e = 0; e < DD; ++e) O[e] = On[e];
      if (s + 1 < steps) {   // the next step's O, ahead of its use
#pragma unroll
        for (int e = 0; e < DD; ++e) On[e] = tiles.Oin[buf][(s + 1) * DD + e];
      }
      T Tm[DD], A[DD];
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < D; ++k) acc = fma(U[r * D + k], O[k * D + c], acc);
          Tm[r * D + c] = acc;
        }
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < D; ++k) acc = fma(O[k * D + r], Tm[k * D + c], acc);
          A[r * D + c] = tiles.Din[buf][s * DD + r * D + c] - acc;
        }
      spd_inverse<T, D>(A, U);
#pragma unroll
      for (int e = 0; e < DD; ++e) tiles.Uout[buf][s * DD + e] = U[e];
    }
  }
  __syncthreads();
  if (ntiles > 0) tiles.flush(Ug, ntiles - 1, (ntiles - 1) & 1, cap);
}

template <typename T, int D>
__global__ void chain_factorize_block(const T* __restrict__ Dg,
                                      const T* __restrict__ Og,
                                      T* __restrict__ Ug, int64_t cap) {
  constexpr int DD = D * D;
  __shared__ Tiles<T, D> tiles;
  __shared__ T U[DD];      // Uinv_{i-1}
  __shared__ T Ts[DD];     // Uinv_{i-1} O_{i-1}
  __shared__ T A[2][DD];   // Gauss-Jordan ping-pong buffers
  const int t = threadIdx.x;
  const bool on = t < DD;
  const int r = on ? t / D : 0;
  const int c = on ? t % D : 0;
  const int64_t ntiles = (cap + tiles.kTile - 1) / tiles.kTile;
  if (on) U[t] = T(0);
  tiles.stage(Dg, Og, 0, 0, cap);
  for (int64_t tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    __pipeline_wait_prior(0);
    __syncthreads();   // this tile has landed; the last one is worked off
    if (tile + 1 < ntiles) tiles.stage(Dg, Og, tile + 1, buf ^ 1, cap);
    if (tile > 0) tiles.flush(Ug, tile - 1, buf ^ 1, cap);
    const int steps = tiles.steps_of(tile, cap);
    for (int s = 0; s < steps; ++s) {
      const T* Os = &tiles.Oin[buf][s * DD];
      // phase 1: T = U O
      if (on) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) acc = fma(U[r * D + k], Os[k * D + c], acc);
        Ts[t] = acc;
      }
      __syncthreads();
      // phase 2: A = D - O^T T
      if (on) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) acc = fma(Os[k * D + r], Ts[k * D + c], acc);
        A[0][t] = tiles.Din[buf][s * DD + t] - acc;
      }
      __syncthreads();
      // phases 3 .. 2 + D: Gauss-Jordan inverse, pivot p reads buffer
      // p & 1 and writes the other
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const T* src = A[p & 1];
        T* dst = A[(p + 1) & 1];
        if (on) {
          const T piv = T(1) / src[p * D + p];
          T v;
          if (r == p && c == p) {
            v = piv;
          } else if (r == p) {
            v = src[p * D + c] * piv;
          } else if (c == p) {
            v = -src[r * D + p] * piv;
          } else {
            v = fma(-src[r * D + p] * piv, src[p * D + c], src[t]);
          }
          dst[t] = v;
          if (p == D - 1) {              // the inverse: carry it, keep it
            U[t] = v;
            tiles.Uout[buf][s * DD + t] = v;
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  if (ntiles > 0) tiles.flush(Ug, ntiles - 1, (ntiles - 1) & 1, cap);
}

template <typename T, int D>
int launch_d(const void* Dg, const void* Og, void* Ug, int64_t cap,
             cudaStream_t stream) {
  const T* Dp = static_cast<const T*>(Dg);
  const T* Op = static_cast<const T*>(Og);
  T* Up = static_cast<T*>(Ug);
  if constexpr (D <= kSerialMaxD) {
    chain_factorize_serial<T, D><<<1, 32, 0, stream>>>(Dp, Op, Up, cap);
  } else {
    constexpr int threads = ((D * D + 31) / 32) * 32;
    chain_factorize_block<T, D><<<1, threads, 0, stream>>>(Dp, Op, Up, cap);
  }
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
