// Camera block solve: z = (L L^T)^{-1} r for C lower 9x9 Cholesky factors.
//
// The block-Jacobi preconditioner of the camera-major BA engine's PCG
// (sfm/ba.py:_solve_from_lin, `precond`), applied once before the loop and
// once every iteration. It replaces torch.cholesky_solve there, which on the
// card goes through MAGMA's batched triangular solves: at C = 1723 on an H100,
// six device operations of about 70 us together behind about 0.2 ms of host
// work a call (a column-major copy, an info tensor and pinned pointer
// arrays), where this kernel takes about 4 us. Built for sm_90a by
// gtsam_personal_tpu_torch/ops/_build.py and called through
// gtsam_personal_tpu_torch/ops/block_solve.py:camera_block_solve.
//
// Layout: L is [C, 9, 9], row-major and contiguous (only the lower triangle
// is read); r and z are [9, C], feature-major as the PCG holds its vectors,
// so neighbouring threads touch neighbouring addresses of r and z. One
// thread solves one camera. A block first copies its cameras' factors into
// shared memory with consecutive threads reading consecutive entries, since
// a thread's own 81 entries read straight from global memory would make
// every warp load touch 32 cache lines. The copies are asynchronous
// (cp.async), so all 81 of a thread are in flight at once; a plain load and
// store would wait for each load in turn. 81 is odd, so the threads' rows
// of the copy fall in distinct banks.
//
// What bounds it: (81 + 18) entries a camera, about 0.68 MB at C = 1723 in
// float32 (0.2 us of the H100's 3.35 TB/s), and a dependent chain of 2 x 9
// divisions with their dot products. Both are far below the launch's own
// latency, which bounds the call.
//
// Arithmetic: a textbook forward substitution L y = r, then a back
// substitution L^T z = y, each sum taken in index order and divided by the
// diagonal entry; no inverse is formed and no wider type is used. The build
// passes -fmad=false (csrc/landmark_block_solve.cu, "Arithmetic order"), so
// the host build of `solve_block` below, compiled with -ffp-contract=off,
// rounds as the kernel does.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#define CBS_HD __host__ __device__ __forceinline__
#else
#define CBS_HD inline
#endif

namespace cbs {

constexpr int kN = 9;
constexpr int kNN = kN * kN;

// z = (L L^T)^{-1} r for one camera: L its 81 entries, row-major; r and z
// its 9 entries, `stride` apart.
template <typename T>
CBS_HD void solve_block(const T* L, const T* r, T* z, int64_t stride) {
  T y[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    T s = r[j * stride];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j * kN + k] * y[k];
    y[j] = s / L[j * kN + j];
  }
  // back substitution in place: y[k] for k > j already holds z[k]
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {
    T s = y[j];
#pragma unroll
    for (int k = j + 1; k < kN; ++k) s -= L[k * kN + j] * y[k];
    y[j] = s / L[j * kN + j];
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) z[j * stride] = y[j];
}

}  // namespace cbs

#ifdef __CUDACC__
namespace {

using cbs::kNN;

// 64 cameras a block: the shared copy of 64 float64 factors is 41.5 KB,
// under the 48 KB of static shared memory, and C = 1723 spreads over 27
// multiprocessors.
constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    camera_block_solve_kernel(const T* __restrict__ Ls,
                              const T* __restrict__ r, T* __restrict__ z,
                              int64_t C) {
  __shared__ T Lsh[kThreads * kNN];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int n = static_cast<int>(C - c0 < kThreads ? C - c0 : kThreads);
  const T* src = Ls + c0 * kNN;
  for (int e = threadIdx.x; e < n * kNN; e += kThreads)
    __pipeline_memcpy_async(&Lsh[e], &src[e], sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n) cbs::solve_block(Lsh + t * kNN, r + c0 + t, z + c0 + t, C);
}

template <typename T>
int launch(const void* Ls, const void* r, void* z, int64_t C, void* stream) {
  if (C > 0) {
    const int64_t blocks = (C + kThreads - 1) / kThreads;
    camera_block_solve_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(Ls), static_cast<const T*>(r),
            static_cast<T*>(z), C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: return cudaGetLastError() after the launch (0 = success).
extern "C" int camera_block_solve_f32(const void* Ls, const void* r, void* z,
                                      int64_t C, void* stream) {
  return launch<float>(Ls, r, z, C, stream);
}

extern "C" int camera_block_solve_f64(const void* Ls, const void* r, void* z,
                                      int64_t C, void* stream) {
  return launch<double>(Ls, r, z, C, stream);
}
#endif  // __CUDACC__
