// Dependent latency of single operations on the card, in cycles of the SM
// clock: one warp runs a chain of n copies of an operation, each on the
// result of the last, between two reads of clock64() (and of %globaltimer,
// which gives the clock's rate). Built and run by tools/kernel_probes.py.
#include <cstdint>
#include <cstdio>

__device__ uint64_t ns_now() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int K>
__global__ void probe(float* fio, double* dio, long long* cycles,
                      unsigned long long* ns, int n) {
  __shared__ double dsm[32];
  __shared__ int ism[64];
  if (threadIdx.x < 32) dsm[threadIdx.x] = 0.0;
  for (int i = threadIdx.x; i < 64; i += 32) ism[i] = i;
  __syncwarp();
  float x = fio[0];
  double y = dio[0];
  int idx = 0;
  const long long c0 = clock64();
  const uint64_t t0 = ns_now();
  for (int i = 0; i < n; ++i) {
    if (K == 0) x = fmaf(x, 1.0000001f, 1e-7f);
    if (K == 1) x = __frcp_rn(x);
    if (K == 2) x = 1.0f / x;
    if (K == 3) {   // with an fma after it, which the chain kernels add
      asm volatile("rcp.approx.ftz.f32 %0, %0;" : "+f"(x));
      x = fmaf(x, 1.0000001f, 1e-7f);
    }
    if (K == 4) y = fma(y, 1.0000001, 1e-7);
    if (K == 5) y = __drcp_rn(y);
    if (K == 6) y = 1.0 / y;
    if (K == 7) {
      asm volatile("rcp.approx.ftz.f64 %0, %0;" : "+d"(y));
      y = fma(y, 1.0000001, 1e-7);
    }
    if (K == 8) y = sqrt(y + 1.0);
    if (K == 9) {
      double s, c;
      sincos(y, &s, &c);
      y = s + c * 1e-3;
    }
    if (K == 10) {
      double s, c;
      sincospi(y, &s, &c);
      y = s + c * 1e-3;
    }
    if (K == 11) idx = ism[(idx + 1) & 63];
    if (K == 12) {
      dsm[threadIdx.x] = y;
      __syncwarp();
      y = dsm[(threadIdx.x + 1) & 31] + 1e-9;
      __syncwarp();
    }
  }
  const long long c1 = clock64();
  const uint64_t t1 = ns_now();
  if (threadIdx.x == 0) {
    cycles[K] = c1 - c0;
    ns[K] = t1 - t0;
    fio[1] = x + static_cast<float>(idx);
    dio[1] = y;
  }
}

template <int K>
void run(float* f, double* d, long long* c, unsigned long long* t, int n) {
  probe<K><<<1, 32>>>(f, d, c, t, n);
}

int main() {
  float* f;
  double* d;
  long long* c;
  unsigned long long* t;
  cudaMalloc(&f, 8);
  cudaMalloc(&d, 16);
  cudaMalloc(&c, 8 * 16);
  cudaMalloc(&t, 8 * 16);
  const float f0 = 1.5f;
  const double d0 = 0.5;
  cudaMemcpy(f, &f0, 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d, &d0, 8, cudaMemcpyHostToDevice);
  const int n = 1 << 16;
  run<0>(f, d, c, t, n); run<1>(f, d, c, t, n); run<2>(f, d, c, t, n);
  run<3>(f, d, c, t, n); run<4>(f, d, c, t, n); run<5>(f, d, c, t, n);
  run<6>(f, d, c, t, n); run<7>(f, d, c, t, n); run<8>(f, d, c, t, n);
  run<9>(f, d, c, t, n); run<10>(f, d, c, t, n); run<11>(f, d, c, t, n);
  run<12>(f, d, c, t, n);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  long long hc[16];
  unsigned long long ht[16];
  cudaMemcpy(hc, c, 8 * 16, cudaMemcpyDeviceToHost);
  cudaMemcpy(ht, t, 8 * 16, cudaMemcpyDeviceToHost);
  const char* names[] = {
      "fp32 fma", "fp32 __frcp_rn", "fp32 1/x", "fp32 rcp.approx + fma",
      "fp64 fma", "fp64 __drcp_rn", "fp64 1/x", "fp64 rcp.approx + fma",
      "fp64 sqrt", "fp64 sincos", "fp64 sincospi", "shared load (int)",
      "fp64 store, __syncwarp, load"};
  for (int k = 0; k < 13; ++k)
    printf("latency %-30s %7.2f cycles  (SM clock %.3f GHz)\n", names[k],
           static_cast<double>(hc[k]) / n,
           static_cast<double>(hc[k]) / static_cast<double>(ht[k]));
  return 0;
}
