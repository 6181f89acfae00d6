// Flash-attention forward for NVIDIA Hopper (sm_90a), plain CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py::_attn_kernel (the Pallas
// TPU kernel behind flash_attention_fwd). It computes the same function:
// online-softmax attention, causal or not, sliding window (causal only, as
// in the reference), GQA/MQA (kv head = h / (H / Kv)), queries right-aligned
// against keys by T - S, fp32 math inside, output in the input type, l
// clamped at 1e-30. Two kernels serve the two input types:
//
//   * bf16 -> attn_fwd_tc, on the tensor cores (wgmma + TMA), below;
//   * fp32 -> attn_fwd, fp32 FMAs from shared memory. Tensor cores cannot
//     give the reference's fp32 tolerance (2e-5), and TF32 is off in the
//     port, so the fp32 path stays on the CUDA cores.
//
// What bounds it: at the gemma-7b training shape (q, k, v of (2, 2048, 16,
// 256) bf16, causal) the kernel does 68.7 GFLOP on 134 MB, about 512
// operations per byte, so it is bound by arithmetic: 0.0695 ms at the
// 989 TFLOP/s bf16 tensor-core peak. Only wgmma reaches that rate.
//
// attn_fwd_tc, the bf16 kernel:
//   * one block per (batch, head, 128-row q tile), q tiles handed out
//     heaviest first (the last causal tiles see the most keys); the kv
//     loop runs inside the block over the causal and window range;
//   * three warpgroups: two consumers of 64 q rows each and a producer, of
//     which one thread issues TMA loads. setmaxnreg gives the consumers 240
//     registers and the producer 24;
//   * Q is loaded once; K and V go through a 2-stage ring in shared memory,
//     in bf16, with a "full" mbarrier per stage for K, one for V, and an
//     "empty" one that the 8 consumer warps arrive on;
//   * tiles are 64-column panels of 128-byte rows, swizzled by TMA
//     (CU_TENSOR_MAP_SWIZZLE_128B) exactly as the wgmma descriptors say
//     (layout type B128), since a swizzled TMA box is at most 128 bytes
//     wide; the maps are 4-d over (D, heads, seq, batch), so rows past S or
//     T read as zeros and never as the next batch's;
//   * S = Q K^T is wgmma m64n64k16 from shared memory into fp32 registers;
//     the online softmax runs on that accumulator, where a row's 64 columns
//     sit with the 4 threads of a quad (two shuffles reduce a row); only
//     the tiles the diagonal, the window edge or T cut pay for the mask;
//   * P is rounded to bf16 in registers and is the A operand of
//     O += P V (wgmma m64n{D}k16, V read N-major through its descriptor):
//     the fp32 accumulator layout of S is the A-fragment layout of P;
//   * numerics: Q K^T is exact products with fp32 sums, as the reference's
//     fp32 dot; the one new rounding is P to bf16 before P V, as in every
//     tensor-core flash kernel, within the bf16 tolerance of 2e-2.
//
// attn_fwd, the fp32 kernel:
//   * one thread block per (batch, head, 64-row q tile), heaviest first;
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4)
//     of the tile, so the running (m, l) of a row lives in registers of the
//     16 threads of one half-warp and row reductions are four shuffles;
//   * Q, K, V and P sit in shared memory as fp32 (216 KB at D = 256, which
//     needs the dynamic shared-memory opt-in); rows of Q and K are padded by
//     4 floats so that the 128-bit reads of 8 threads hit 8 distinct groups
//     of banks;
//   * the (64 x D) fp32 accumulator lives in registers: 4 rows x D/16
//     columns per thread.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32: attn_fwd, fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // kv rows per inner step
constexpr int NT = 256;        // threads per block, 16 x 16
constexpr int PAD = 4;         // fp32 padding of a Q/K/P row in shared memory
constexpr float M_INIT = -1e30f;   // running max before any key (Pallas NEG_INF)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Copies `rows` rows of D elements (global row stride `gstride` elements)
// into shared memory as fp32 with row stride `sstride`; rows at or past
// `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* sm, int sstride,
                                          const float* g, long gstride,
                                          int valid, int rows) {
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o, int S, int Tk,
         int H, int KV, int window, float scale) {
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
  const float* kb = k + (long)b * Tk * kstride + (long)kvh * D;
  const float* vb = v + (long)b * Tk * kstride + (long)kvh * D;

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
    float* orow = o + ((long)b * S + q0 + r) * qstride + (long)h * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      store4(orow + 64 * jj + 4 * tx,
             make_float4(acc[i][jj][0] / li, acc[i][jj][1] / li,
                         acc[i][jj][2] / li, acc[i][jj][3] / li));
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + PAD) + BK * (D + PAD) + BK * D + BQ * (BK + PAD));
  auto kernel = attn_fwd<D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, KV,
      window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int H, int KV, int D, int causal, int window,
             cudaStream_t stream) {
#define FA_CASE(DD)                                                          \
  if (D == DD)                                                               \
    return causal ? launch<DD, true>(q, k, v, o, B, S, Tk, H, KV, window,    \
                                     stream)                                 \
                  : launch<DD, false>(q, k, v, o, B, S, Tk, H, KV, 0, stream);
  FA_CASE(64)
  FA_CASE(128)
  FA_CASE(256)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;       // q rows per block: two consumer warpgroups
constexpr int BK = 64;        // kv rows per stage
constexpr int STAGES = 2;     // depth of the K/V ring
constexpr int NT = 384;       // 2 consumer warpgroups + 1 producer warpgroup
constexpr int PANEL = 64;     // bf16 columns in a 128-byte swizzled row
constexpr int ROW = 128;      // bytes of a panel row
constexpr int EMPTY_ARRIVALS = 8;   // one per consumer warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Arrives once and expects `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-d tensor map into shared memory; completion is
// reported to `bar` as bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64 x n64, fp32) += A (m64 x k16) * B (n64 x k16)^T; A and B
// in shared memory, both K-major, described by da and db.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, fp32) += A (m64 x k16, bf16 in registers) * B (k16 x n64);
// B in shared memory, N-major (transposed), described by db.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (m64 x n128, fp32) += A (m64 x k16, bf16 in registers) * B (k16 x n128);
// B in shared memory, N-major (transposed), described by db.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (m64 x n256, fp32) += A (m64 x k16, bf16 in registers) * B (k16 x n256);
// B in shared memory, N-major (transposed), described by db.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
attn_fwd_tc(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            __nv_bfloat16* __restrict__ o, int S, int Tk, int H, int KV,
            int window, float scale_log2) {
  constexpr int NP = D / PANEL;             // panels across a row of D
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;      // K or V, one stage
  constexpr int HALF = 64 * ROW;            // a warpgroup's rows of a panel
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes; TMA and wgmma both want the
  // tiles on that boundary.
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES;                 // + stage * KV_BYTES
  const uint32_t sV = sK + STAGES * KV_BYTES;
  const uint32_t bars = sV + STAGES * KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int kvh = h / (H / KV);
  const int off = Tk - S;               // right alignment of the queries
  const int q_valid = min(BQ, S - q0);
  // Keys this block can see: [kv_lo, kv_hi), in tiles of BK from k_first.
  int kv_lo = 0;
  int kv_hi = Tk;
  if (CAUSAL) {
    kv_hi = min(Tk, q0 + q_valid + off);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int k_first = (kv_lo / BK) * BK;
  const int n_tiles = (kv_hi - k_first + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup: one thread keeps the ring full -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int p = 0; p < NP; ++p)
        for (int w = 0; w < 2; ++w)
          tma_load(sQ + p * BQ * ROW + w * HALF, &qmap, q_full, p * PANEL, h,
                   q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        // the consumers' (i / STAGES)-th release of this slot
        if (i >= STAGES) mbar_wait(empty + 8 * st, ((i / STAGES) - 1) & 1);
        const int k0 = k_first + i * BK;
        mbar_expect_tx(k_full + 8 * st, KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sK + st * KV_BYTES + p * BK * ROW, &kmap, k_full + 8 * st,
                   p * PANEL, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * st, KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(sV + st * KV_BYTES + p * BK * ROW, &vmap, v_full + 8 * st,
                   p * PANEL, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    // This thread holds rows r and r + 8 of its warpgroup's 64, columns
    // 8 j + 2 (lane % 4) + {0, 1} of every accumulator: register 4 j + e is
    // row r + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
    const int r = 16 * warp + lane / 4;
    const int qa = q0 + 64 * wg + r + off;      // key-space position of row r
    const int qa_first = q0 + 64 * wg + off;    // ... of the warpgroup's rows
    const int qa_last = qa_first + 63;
    const uint32_t sQw = sQ + wg * HALF;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m0 = M_INIT, m1 = M_INIT;   // running max (log2 units), rows r, r + 8
    float l0 = 0.f, l1 = 0.f;         // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = k_first + i * BK;

      // s = q k^T (64 x BK), K-major operands, stepping 16 columns of D at
      // a time: 32 bytes inside a panel row, then to the next panel.
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      mbar_wait(k_full + 8 * st, parity);
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk / 4) * BQ * ROW + (kk % 4) * 32;
        const uint32_t bt = (kk / 4) * BK * ROW + (kk % 4) * 32;
        wgmma_ss_n64(s, desc(sQw + at, 16, 1024),
                     desc(sK + st * KV_BYTES + bt, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // Online softmax in log2 units. A masked entry gets p = 0 and takes
      // no part in the max, which equals the reference's -1e30 logit for
      // every row that sees at least one key.
      const bool edge =
          k0 + BK > Tk ||
          (CAUSAL && (k0 + BK - 1 > qa_first ||
                      (window > 0 && k0 <= qa_last - window)));
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float x = s[j] * scale_log2;
        if (edge) {
          const int ka = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
          const int qj = (j & 2) ? qa + 8 : qa;
          bool ok = ka < Tk;
          if (CAUSAL) ok = ok && ka <= qj && (window <= 0 || ka > qj - window);
          if (!ok) x = -INFINITY;
        }
        s[j] = x;
        if (j & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float n0 = fmaxf(m0, mx0);
      const float n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0);
      const float c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      // P in bf16, laid out as the A fragments of four k16 steps.
      uint32_t pa[BK / 16][4];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; j += 2) {
        const float mj = (j & 2) ? n1 : n0;
        const float p0 = exp2f(s[j] - mj);   // exp2(-inf) = 0
        const float p1 = exp2f(s[j + 1] - mj);
        if (j & 2) rs1 += p0 + p1;
        else rs0 += p0 + p1;
        pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? c1 : c0;

      // acc += p v: V is (BK x D) with D contiguous, so B is N-major; its
      // panels are BK rows apart, its 8-row groups 1024 bytes.
      mbar_wait(v_full + 8 * st, parity);
      pin(acc);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 desc(sV + st * KV_BYTES + kk * 16 * ROW, BK * ROW, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float li0 = fmaxf(l0, 1e-30f);
    const float li1 = fmaxf(l1, 1e-30f);
    const int row = q0 + 64 * wg + r;
    const long qstride = (long)H * D;
    __nv_bfloat16* o0 = o + ((long)b * S + row) * qstride + (long)h * D +
                        2 * (lane % 4);
    __nv_bfloat16* o1 = o0 + 8 * qstride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] / li0, acc[4 * j + 1] / li0);
      if (row + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] / li1, acc[4 * j + 3] / li1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over (D, heads, seq, batch) of a contiguous (batch, seq, heads,
// D) bf16 tensor, with 64 x 64 boxes (one panel of 64 rows) swizzled by
// 128 bytes. Coordinates past seq read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int NH, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)L * NH * D * 2};
  const cuuint32_t box[4] = {PANEL, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, int window, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, B, S, H, D);
  if (err == 0) err = make_map(&kmap, k, B, Tk, KV, D);
  if (err == 0) err = make_map(&vmap, v, B, Tk, KV, D);
  if (err != 0) return err;
  const size_t smem = 1024 + (size_t)BQ * D * 2 +
                      2 * (size_t)STAGES * BK * D * 2 + 8 * (1 + 3 * STAGES);
  auto kernel = attn_fwd_tc<D, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(qmap, kmap, vmap,
                                     static_cast<__nv_bfloat16*>(o), S, Tk, H,
                                     KV, window,
                                     1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int H, int KV, int D, int causal, int window,
             cudaStream_t stream) {
#define FA_CASE(DD)                                                          \
  if (D == DD)                                                               \
    return causal ? launch<DD, true>(q, k, v, o, B, S, Tk, H, KV, window,    \
                                     stream)                                 \
                  : launch<DD, false>(q, k, v, o, B, S, Tk, H, KV, 0, stream);
  FA_CASE(64)
  FA_CASE(128)
  FA_CASE(256)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

namespace {

bool bad_shape(int B, int S, int T, int H, int KV) {
  return B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0;
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); o: (B, S, H, D); all contiguous and
// of the entry's type. Each entry launches on `stream` and returns the CUDA
// error code of the launch (0 = success).

// float32 -> attn_fwd, fp32 FMAs on the CUDA cores.
extern "C" int flash_attention_fwd_fp32(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int T, int H, int KV, int D,
                                        int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV)) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, B, S, T, H, KV, D, causal, window,
                  static_cast<cudaStream_t>(stream));
}

// bfloat16 -> attn_fwd_tc, wgmma on the tensor cores, tiles loaded by TMA.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int T, int H, int KV, int D,
                                        int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV)) return (int)cudaErrorInvalidValue;
  return tc::dispatch(q, k, v, o, B, S, T, H, KV, D, causal, window,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
