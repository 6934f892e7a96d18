// Cycles that each role of csrc/preint_tangent.cu's pipeline spends on its
// work, one segment of 200 samples in float64: the kernel's own body
// (tangent_block), with clock64() read around each role's share of a
// chunk (the wait at the chunk's __syncthreads() left out). Built and run
// by tools/kernel_probes.py.
#include "../../csrc/preint_tangent.cu"

#include <cstdio>
#include <cstdlib>
#include <vector>

// a warp's busy cycles (its role's share of every chunk, up to its last
// lane) and the whole loop's
struct ClockTimer {
  long long t0 = 0, busy = 0, start = 0, all = 0;
  __device__ void loop_start() { start = clock64(); }
  __device__ void role_start() { t0 = clock64(); }
  __device__ void role_end() {
    __syncwarp();
    busy += clock64() - t0;
  }
  __device__ void loop_end() { all = clock64() - start; }
};

template <typename T>
__global__ void roles(const T* accs, const T* gyros, const T* dts,
                      const T* bias, const T* covs, T* zeta, T* H, T* cov,
                      T* dT, int64_t N, long long* cyc) {
  __shared__ preint::Carry<T> s;
  ClockTimer timer;
  tangent_block<T>(accs, gyros, dts, bias, covs, zeta, H, cov, dT, N, 0, s,
                   timer);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0 && warp < 3) cyc[warp] = timer.busy;
  if (threadIdx.x == 0) cyc[3] = timer.all;
}

int main() {
  const int64_t N = 200;
  std::vector<double> a(N * 3), g(N * 3), d(N, 0.005), bias(6, 0.001);
  std::vector<double> covs(27, 0.0);
  srand(1);
  for (int i = 0; i < N * 3; ++i) {
    a[i] = (i % 3 == 2 ? 9.81 : 0.0) + (rand() / double(RAND_MAX) - 0.5);
    g[i] = 0.3 * (rand() / double(RAND_MAX) - 0.5);
  }
  for (int q = 0; q < 3; ++q)
    for (int i = 0; i < 3; ++i)
      covs[9 * q + 4 * i] = q == 0 ? 0.01 : q == 1 ? 1e-4 : 1e-8;
  double *A, *G, *Dt, *B, *C, *Z, *Hh, *Cv, *T;
  long long* cyc;
  cudaMalloc(&A, N * 24);
  cudaMalloc(&G, N * 24);
  cudaMalloc(&Dt, N * 8);
  cudaMalloc(&B, 48);
  cudaMalloc(&C, 27 * 8);
  cudaMalloc(&Z, 72);
  cudaMalloc(&Hh, 54 * 8);
  cudaMalloc(&Cv, 81 * 8);
  cudaMalloc(&T, 8);
  cudaMalloc(&cyc, 8 * 8);
  cudaMemcpy(A, a.data(), N * 24, cudaMemcpyHostToDevice);
  cudaMemcpy(G, g.data(), N * 24, cudaMemcpyHostToDevice);
  cudaMemcpy(Dt, d.data(), N * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(B, bias.data(), 48, cudaMemcpyHostToDevice);
  cudaMemcpy(C, covs.data(), 27 * 8, cudaMemcpyHostToDevice);
  for (int rep = 0; rep < 3; ++rep)
    roles<double><<<1, kThreads>>>(A, G, Dt, B, C, Z, Hh, Cv, T, N, cyc);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  long long h[4];
  cudaMemcpy(h, cyc, 32, cudaMemcpyDeviceToHost);
  printf("preint_tangent roles, one segment of %lld samples, float64, "
         "cycles a step: theta %.0f, coefficients %.0f, carry %.0f; whole "
         "loop %.0f\n", static_cast<long long>(N), h[0] / double(N),
         h[1] / double(N), h[2] / double(N), h[3] / double(N));
  return 0;
}
