// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a), plain CUDA C++.
//
// Replaces src/repro/kernels/rglru_scan.py::_rglru_kernel (the Pallas TPU
// kernel behind rglru_scan_fwd). It computes the same function:
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = 0,
// over the sequence axis of a, b: (B, S, R), both fp32 or both bf16, with an
// fp32 carry, the output in b's type.
//
// It also runs the op's adjoint (the reverse mode), which the JAX package
// computes with a reverse associative scan (src/repro/kernels/ops.py,
// _rg_bwd): from a, the output gradient g and the saved h,
//   lam_t = g_t + a_{t+1} lam_{t+1}  (t = S-1 down to 0, a_S = 0),
//   db_t = lam_t,  da_t = lam_t h_{t-1}  (h_{-1} = 0),
// written in natural order, in one pass, with no flipped or shifted copies.
//
// What bounds it: one multiply and one add per element, so bytes. At the
// recurrentgemma-2b training shape (2, 2048, 2560) fp32 the forward reads a
// and b and writes h once, 125.8 MB, 0.0376 ms at 3.35 TB/s; the reverse
// reads a, g, h and writes da, db, 209.7 MB.
//
// Design. Blocks on Hopper run in no order, so the TPU kernel's sequential
// grid over sequence chunks (carry in VMEM scratch) becomes a loop inside the
// block, and the sequence is split across the block's warps so that the
// card has enough loads in flight:
//   * a block owns a column of 32 channels of one batch row and walks S in
//     segments of NW * U steps; lane c of every warp owns channel c, so each
//     step's 32 loads and stores of a warp are one coalesced 128-byte row;
//   * warp w owns sub-chunk w (U steps) of each segment, in registers. The
//     next segment's loads are issued before the current one is scanned, so
//     they are in flight during the scan;
//   * pass 1: each warp reduces its sub-chunk to the pair (prod a, h from a
//     zero state); the pairs meet in shared memory; each warp composes the
//     pairs of the warps before it onto the segment's carry-in to get its own
//     carry-in; pass 2 reruns the sub-chunk from that carry-in and writes h;
//     the last warp's final h is the next segment's carry-in;
//   * each input is read once from device memory: there is no second pass
//     over a and b, as a chunked two-pass scan would make (about 0.6 of the
//     bound at best), and no atomics.
// Numerics: pass 2 is the plain loop's arithmetic (a rounded multiply, then
// a rounded add) from its carry-in. Only the carry into each sub-chunk but
// the first of a segment is composed, which rounds in another order than the
// plain loop; the difference stays far inside the reference's 3e-5, as the
// JAX reference's own associative_scan does. The carry from one segment to
// the next is the exact rerun value, so errors do not build up along S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;    // channels per block (one per lane)
constexpr int NW = 8;    // warps per block: sub-chunks per segment
constexpr int U = 16;    // steps per sub-chunk
constexpr int L = NW * U;   // steps per segment

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

// One sub-chunk's inputs, step i of U: coefficient, input, and (reverse
// mode) the saved h_{t-1}. Steps past the sequence are the identity (1, 0).
template <typename T, bool REV>
struct Chunk {
  float c[U], x[U], hp[REV ? U : 1];

  __device__ __forceinline__ void load(const T* __restrict__ a,
                                       const T* __restrict__ x_in,
                                       const T* __restrict__ hs, int u0,
                                       int S, int R, bool ok) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = u0 + i;
      const int t = REV ? S - 1 - u : u;
      const bool in = ok && u < S;
      const long at = (long)t * R;
      c[i] = !in ? 1.f : !REV ? to_float(a[at])
                              : (t + 1 < S ? to_float(a[at + R]) : 0.f);
      x[i] = in ? to_float(x_in[at]) : 0.f;
      if (REV) hp[i] = in && t > 0 ? to_float(hs[at - R]) : 0.f;
    }
  }
};

// Forward (REV = false): a, x = b -> out = h.
// Reverse (REV = true):  a, x = g, hs = h -> out = lam (db), da.
// a, x, hs, out, da point at (batch, channel 0) of their (B, S, R) tensors.
template <typename T, bool REV>
__global__ void __launch_bounds__(NW * 32)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const T* __restrict__ hs, T* __restrict__ out,
                  T* __restrict__ da, int S, int R) {
  __shared__ float pa[2][NW][C];   // per segment parity: prod a of a sub-chunk
  __shared__ float ph[2][NW][C];   // ... and its h from a zero state
  __shared__ float carry[2][C];    // h at the end of a segment

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ch = blockIdx.x * C + lane;
  const bool ok = ch < R;
  const long base = (long)blockIdx.y * S * R + (ok ? ch : 0);
  a += base;
  x += base;
  out += base;
  if (REV) {
    hs += base;
    da += base;
  }

  const int n_seg = (S + L - 1) / L;
  Chunk<T, REV> cur, nxt;
  cur.load(a, x, hs, w * U, S, R, ok);
  for (int g = 0; g < n_seg; ++g) {
    const int p = g & 1;
    const int u0 = g * L + w * U;
    if (g + 1 < n_seg) nxt.load(a, x, hs, u0 + L, S, R, ok);

    // pass 1: the sub-chunk as one affine map h -> A h + H
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      H = __fadd_rn(__fmul_rn(cur.c[i], H), cur.x[i]);
      A = __fmul_rn(A, cur.c[i]);
    }
    pa[p][w][lane] = A;
    ph[p][w][lane] = H;
    __syncthreads();

    // carry-in of this sub-chunk: the segment's, through warps 0 .. w-1
    float h = g > 0 ? carry[p ^ 1][lane] : 0.f;
    for (int j = 0; j < w; ++j)
      h = __fadd_rn(__fmul_rn(pa[p][j][lane], h), ph[p][j][lane]);

    // pass 2: the plain recurrence from the carry-in
#pragma unroll
    for (int i = 0; i < U; ++i) {
      h = __fadd_rn(__fmul_rn(cur.c[i], h), cur.x[i]);
      const int u = u0 + i;
      if (ok && u < S) {
        const long at = (long)(REV ? S - 1 - u : u) * R;
        out[at] = from_float<T>(h);
        if (REV) da[at] = from_float<T>(h * cur.hp[i]);
      }
    }
    if (w == NW - 1) carry[p][lane] = h;
    cur = nxt;
  }
}

template <typename T, bool REV>
int launch(const void* a, const void* x, const void* hs, void* out, void* da,
           int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + C - 1) / C, B);
  rglru_scan_kernel<T, REV><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const T*>(hs), static_cast<T*>(out), static_cast<T*>(da),
      S, R);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int R) {
  return B <= 0 || S <= 0 || R <= 0 || B > 65535;
}

}  // namespace

// a, b, h: (B, S, R), contiguous, of one type (dtype 0 = float32,
// 1 = bfloat16). Launches on `stream` and returns the CUDA error code of the
// launch (0 = success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int R, int dtype, void* stream) {
  if (bad_shape(B, S, R)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(a, b, nullptr, h, nullptr, B, S, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(a, b, nullptr, h, nullptr, B, S, R,
                                        st);
  return (int)cudaErrorInvalidValue;
}

// The adjoint. a, g, h (the forward's output), da, db: (B, S, R),
// contiguous, of one type. Writes db = lam and da = lam_t h_{t-1}.
extern "C" int rglru_scan_bwd(const void* a, const void* g, const void* h,
                              void* da, void* db, int B, int S, int R,
                              int dtype, void* stream) {
  if (bad_shape(B, S, R)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, true>(a, g, h, db, da, B, S, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(a, g, h, db, da, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
