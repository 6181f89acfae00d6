// Flash-attention forward for NVIDIA Hopper (sm_90a), plain CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py::_attn_kernel (the Pallas
// TPU kernel behind flash_attention_fwd). It computes the same function:
// online-softmax attention, causal or not, sliding window (causal only, as
// in the reference), GQA/MQA (kv head = h / (H / Kv)), queries right-aligned
// against keys by T - S, fp32 or bf16 in, fp32 math inside, output in the
// input type, l clamped at 1e-30.
//
// What bounds it: at the gemma-7b training shape (q, k, v of (2, 2048, 16,
// 256) bf16, causal) the kernel does 68.7 GFLOP on 134 MB, about 512
// operations per byte, so it is bound by arithmetic. This first version
// does that arithmetic with fp32 FMAs from shared memory (no wgmma, no TMA):
// it is simple and exact in fp32, and far from the tensor cores' rate.
//
// Design for Hopper rather than a tile-by-tile copy of the TPU grid:
//   * one thread block per (batch, head, 64-row q tile); the kv loop runs
//     inside the block, bounded by the causal and window range, instead of
//     a sequential grid axis whose masked tiles are skipped;
//   * q tiles are handed out heaviest first (the last causal tiles see the
//     most keys), so the tail of the grid is short tiles;
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4)
//     of the tile, so the running (m, l) of a row lives in registers of the
//     16 threads of one half-warp and row reductions are four shuffles;
//   * Q, K, V and P sit in shared memory as fp32 (216 KB at D = 256, which
//     needs the dynamic shared-memory opt-in); rows of Q and K are padded by
//     4 floats so that the 128-bit reads of 8 threads hit 8 distinct groups
//     of banks;
//   * the (64 x D) fp32 accumulator lives in registers: 4 rows x D/16
//     columns per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // kv rows per inner step
constexpr int NT = 256;        // threads per block, 16 x 16
constexpr int PAD = 4;         // fp32 padding of a Q/K/P row in shared memory
constexpr float M_INIT = -1e30f;   // running max before any key (Pallas NEG_INF)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

// Copies `rows` rows of D elements (global row stride `gstride` elements)
// into shared memory as fp32 with row stride `sstride`; rows at or past
// `valid` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* sm, int sstride, const T* g,
                                          long gstride, int valid, int rows) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < rows * V; i += NT) {
    const int r = i / V;
    const int c = (i % V) * 4;
    const float4 x = r < valid ? load4(g + r * gstride + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(sm + r * sstride + c, x);
  }
}

__device__ __forceinline__ float halfwarp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float halfwarp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
         int KV, int window, float scale) {
  constexpr int QS = D + PAD;    // row stride of Qs and Ks
  constexpr int PS = BK + PAD;   // row stride of Ps
  constexpr int NJ = D / 64;     // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * D;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long qstride = (long)H * D;     // elements between positions of q, o
  const long kstride = (long)KV * D;    // ... of k, v
  const int q_valid = min(BQ, S - q0);
  const int off = Tk - S;               // right alignment of the queries

  load_tile<D>(Qs, QS, q + ((long)b * S + q0) * qstride + (long)h * D,
               qstride, q_valid, BQ);
  const T* kb = k + (long)b * Tk * kstride + (long)kvh * D;
  const T* vb = v + (long)b * Tk * kstride + (long)kvh * D;

  float acc[4][NJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = M_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // Keys this tile can see: [kv_lo, kv_hi).
  int kv_lo = 0;
  int kv_hi = Tk;
  if (CAUSAL) {
    kv_hi = min(Tk, q0 + q_valid - 1 + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }

  for (int k0 = (kv_lo / BK) * BK; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // the previous step is done with Ks, Vs and Ps
    const int k_valid = min(BK, Tk - k0);
    load_tile<D>(Ks, QS, kb + (long)k0 * kstride, kstride, k_valid, BK);
    load_tile<D>(Vs, D, vb + (long)k0 * kstride, kstride, k_valid, BK);
    __syncthreads();

    // s = q k^T for rows ty + 16 i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax. A masked entry gets p = 0 and takes no part in the
    // max, which equals the reference's -1e30 logit for every row that sees
    // at least one key.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qa = q0 + r + off;
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ka = k0 + tx + 16 * j;
        bool ok = ka < Tk;
        if (CAUSAL) ok = ok && ka <= qa && (window <= 0 || ka > qa - window);
        x[j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], halfwarp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(x[j] - m_new);   // exp(-inf) = 0
        rs += p;
        Ps[r * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + halfwarp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= corr;
    }
    __syncthreads();

    // acc += p v for columns 64 jj + 4 tx + e.
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (c + cc) * D + 64 * jj + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)b * S + q0 + r) * qstride + (long)h * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      store4(orow + 64 * jj + 4 * tx,
             make_float4(acc[i][jj][0] / li, acc[i][jj][1] / li,
                         acc[i][jj][2] / li, acc[i][jj][3] / li));
  }
}

template <int D, typename T, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + PAD) + BK * (D + PAD) + BK * D + BQ * (BK + PAD));
  auto kernel = attn_fwd<D, T, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int H, int KV, int D, int causal, int window,
             cudaStream_t stream) {
#define FA_CASE(DD)                                                          \
  if (D == DD)                                                               \
    return causal ? launch<DD, T, true>(q, k, v, o, B, S, Tk, H, KV, window, \
                                        stream)                              \
                  : launch<DD, T, false>(q, k, v, o, B, S, Tk, H, KV, 0,     \
                                         stream);
  FA_CASE(64)
  FA_CASE(128)
  FA_CASE(256)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); o: (B, S, H, D); all contiguous, of
// one type (dtype 0 = float32, 1 = bfloat16). Launches on `stream` and
// returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int H, int KV,
                                   int D, int dtype, int causal, int window,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, T, H, KV, D, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, D, causal,
                                   window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
