// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a), plain CUDA C++.
//
// Replaces src/repro/kernels/rglru_scan.py::_rglru_kernel (the Pallas TPU
// kernel behind rglru_scan_fwd). It computes the same function:
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = 0,
// over the sequence axis of a, b: (B, S, R), both fp32 or both bf16, with an
// fp32 carry, the output in b's type. Each step is an fp32 multiply and then
// an fp32 add, both rounded to nearest (no fused multiply-add), so the
// result is bit for bit the plain version's `a[t] * h + b[t]`.
//
// What bounds it: the work is one multiply and one add per element, so it
// is bound by bytes. At the recurrentgemma-2b training shape (2, 2048, 2560)
// fp32 it reads a and b and writes h once, 125.8 MB, which takes 0.0376 ms
// at 3.35 TB/s; its 21 MFLOP are negligible.
//
// Design for Hopper rather than a copy of the TPU grid. On the TPU the grid
// runs in order and the carry passes from one sequence chunk to the next in
// VMEM scratch; on Hopper blocks run in no order, so the sequence loop runs
// inside the thread:
//   * one thread per (batch, channel); consecutive threads own consecutive
//     channels, so each step's loads of a[t] and b[t] and store of h[t] are
//     coalesced across the warp;
//   * the loop goes over S in chunks of U steps: the 2U loads of a chunk do
//     not depend on the carry, so they are issued together before the U
//     dependent steps, and the memory latency is paid once a chunk;
//   * blocks of 32 threads, so that the B * R threads spread over as many
//     SMs as possible.
// B * R = 5,120 threads at the training shape fill only a fraction of the
// card's 132 SMs, so the kernel is limited by how many loads it keeps in
// flight rather than by the memory rate. A chunked two-pass scan over S
// would fill the card; that is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 32;   // threads per block
constexpr int U = 32;    // steps whose loads are issued together

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int S, int R, int BR) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= BR) return;
  const int bi = idx / R;
  const long base = (long)bi * S * R + (idx - bi * R);
  // Pointers step by R elements, so that a chunk's addresses are built one
  // after another instead of all held in registers at once.
  const T* pa = a + base;
  const T* pb = b + base;
  T* ph = h + base;
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int n = min(U, S - t0);
    float ra[U], rb[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        ra[i] = to_float(*pa);
        rb[i] = to_float(*pb);
        pa += R;
        pb += R;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        carry = __fadd_rn(__fmul_rn(ra[i], carry), rb[i]);
        *ph = from_float<T>(carry);
        ph += R;
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int R,
           cudaStream_t stream) {
  const int br = B * R;
  rglru_scan_kernel<T><<<(br + NT - 1) / NT, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, R, br);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, R), contiguous, of one type (dtype 0 = float32,
// 1 = bfloat16). Launches on `stream` and returns the CUDA error code of the
// launch (0 = success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int R, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || (long)B * R > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, S, R, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
