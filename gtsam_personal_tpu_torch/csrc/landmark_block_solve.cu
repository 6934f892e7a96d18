// Landmark block solve: u = (H + lam I)^{-1} t for P symmetric 3x3 blocks.
//
// Replaces the TPU kernel gtsam_personal_tpu/ops/pallas_kernels.py:
// _block_solve_kernel (launched by landmark_block_solve). Built for sm_90a by
// gtsam_personal_tpu_torch/ops/_build.py and called through
// gtsam_personal_tpu_torch/ops/block_solve.py:landmark_block_solve.
//
// Layout: H is [9, P] (row-major 3x3 per column; only entries 0,1,2,4,5,8
// are read), t and u are [3, P], all contiguous, so thread i reads and
// writes column i and neighbouring threads touch neighbouring addresses.
// lam is read through a device pointer: the BA engine keeps lambda on the
// device, and passing it as a host float would wait for the device on every
// CG iteration.
//
// What bounds it: one thread per landmark moves 6 entries of H, 3 of t and
// 3 of u, about 48 B per landmark in fp32, or about 7.5 MB per call at
// P = 156k (a few microseconds of the H100's 3.35 TB/s). At that size launch
// latency bounds the call, not bandwidth, so the kernel is kept simple: no
// shared memory, no padding (the ragged edge is bounds-checked). Fusing it
// into the Schur matvec's landmark step, which produces t and consumes u, is
// later work (ROADMAP.md, queue 2).
//
// Arithmetic order: the inverse is formed as in the plain torch version
// (ops/block_solve.py:landmark_block_solve_ref, i.e. sfm/ba_kernels.py:
// sym33_inv_T then sym33_matvec_T), entry by entry, and the build passes
// -fmad=false so no multiply-add is contracted. Each operation then rounds
// as the plain version's does, and the two agree bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void landmark_block_solve_kernel(const T* __restrict__ H,
                                            const T* __restrict__ t,
                                            const T* __restrict__ lam,
                                            T* __restrict__ u, int64_t P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const T l = *lam;
  const T a = H[0 * P + i] + l;
  const T b = H[1 * P + i];
  const T c = H[2 * P + i];
  const T d = H[4 * P + i] + l;
  const T e = H[5 * P + i];
  const T f = H[8 * P + i] + l;
  const T A = d * f - e * e;
  const T B = c * e - b * f;
  const T C = b * e - c * d;
  T det = a * A + b * B + c * C;
  // |det| < 1e-30 -> +1e-30, dropping the sign, as the TPU kernel does.
  if (fabs(det) < T(1e-30)) det = T(1e-30);
  const T inv = T(1) / det;
  const T D = a * f - c * c;
  const T E = b * c - a * e;
  const T F = a * d - b * b;
  const T Ai = A * inv, Bi = B * inv, Ci = C * inv;
  const T Di = D * inv, Ei = E * inv, Fi = F * inv;
  const T t0 = t[0 * P + i], t1 = t[1 * P + i], t2 = t[2 * P + i];
  u[0 * P + i] = Ai * t0 + Bi * t1 + Ci * t2;
  u[1 * P + i] = Bi * t0 + Di * t1 + Ei * t2;
  u[2 * P + i] = Ci * t0 + Ei * t1 + Fi * t2;
}

template <typename T>
int launch(const void* H, const void* t, const void* lam, void* u, int64_t P,
           void* stream) {
  if (P > 0) {
    constexpr int kThreads = 256;
    const int64_t blocks = (P + kThreads - 1) / kThreads;
    landmark_block_solve_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(H), static_cast<const T*>(t),
            static_cast<const T*>(lam), static_cast<T*>(u), P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: return cudaGetLastError() after the launch (0 = success).
extern "C" int landmark_block_solve_f32(const void* H, const void* t,
                                        const void* lam, void* u, int64_t P,
                                        void* stream) {
  return launch<float>(H, t, lam, u, P, stream);
}

extern "C" int landmark_block_solve_f64(const void* H, const void* t,
                                        const void* lam, void* u, int64_t P,
                                        void* stream) {
  return launch<double>(H, t, lam, u, P, stream);
}
