// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces `_flash_backward` (ray_tpu/ops/attention.py:189-247), the
// custom_vjp backward of the Pallas forward kernel (:251-273).  There it is
// an XLA `lax.scan` over KV blocks; here it is three kernels, launched in
// this order on one stream, with no atomics, so a result repeats bit for bit:
//
//  * flash_bwd_delta: delta[b,h,i] = sum_d o*g in f32 (o and g widened from
//    the input type), one row per warp.
//  * flash_bwd_dkdv: grid (ceil(Sk/64), B*H).  A CTA keeps one 64-key tile of
//    K and V in shared memory and accumulates dK and dV for it in registers.
//    It walks the 64-row query tiles from the first one whose last row can
//    see the tile's first key (the causal arithmetic of the forward's
//    visible_tiles, with q_offset and k_offset).  Per tile it recomputes
//    S = (q*scale) K^T and dP = g V^T, masks keys >= Sk, causal pairs and
//    dead rows (lse <= -5e29 gives P = 0), takes P = exp(S - lse),
//    dS = P * (dP - delta), and accumulates dV += P^T g, dK += dS^T (q*scale).
//  * flash_bwd_dq: grid (ceil(Sq/64), B*H).  A CTA keeps a 64-row tile of
//    q*scale, g, lse and delta, walks the KV tiles its rows can see,
//    recomputes S, P, dP and dS as above, and accumulates dQ += dS K; the
//    epilogue multiplies by sm_scale (dK gets its scale through q*scale).
//
// Every product is exact f32 FMA on the CUDA cores, for f32 and bf16 inputs
// alike: bf16 is widened on load, all tiles live in shared memory as f32,
// and dq, dk, dv are written once, contiguous (B, H, S, D), in the input
// type.  Inputs are strided (batch, head and sequence strides in elements,
// a contiguous head dim): the training path hands q, k, v as views of the
// fused QKV projection and g as a transposed view.  D is 16, 32, 64 or 128.
//
// Shared memory per CTA, in f32: four 64 x (D+4) tiles and the 64 x 68
// score tiles (dkdv: P and dS; dq: dS), plus lse and delta.  At D = 128 that
// is 166.5 KB for dkdv and 149.5 KB for dq, above the 48 KB default, so each
// launch first raises the kernel's dynamic shared-memory limit; a refused
// attribute or launch returns its CUDA error and the wrapper raises.
//
// What bounds it on this card.  The work is 10*D flops per visible
// (query, key) pair (S, dV, dP, dQ and dK, each 2*D, counted once) against
// the bytes of q, k, v, o, g and lse read once and dq, dk, dv written once;
// at the training shape (B 16, H 12, S 1024, D 64, causal, bf16) that is
// 64.5 GFLOP against 0.20 GB.  On the CUDA cores (f32, 67 TFLOP/s) it is
// bound by operations at about 0.96 ms; at the bf16 tensor-core peak
// (989 TFLOP/s) the bound is 0.065 ms, just above the 0.060 ms of bytes at
// 3.35 TB/s.  This design computes S and dP twice (once per kernel), which
// the bound does not count.  Tensor cores (wgmma), TMA and a dQ by atomics
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per CTA: 16 x 16, each a 4 x 4 block
constexpr int PS = BK + 4;  // row stride of the 64 x 64 score tiles
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;    // (B*H, Sq)
  const float* delta;  // (B*H, Sq)
  void* dq;            // (B*H, Sq, D), contiguous
  void* dk;            // (B*H, Sk, D), contiguous
  void* dv;            // (B*H, Sk, D), contiguous
  int H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb, g_sh,
      g_ss;
  float sm_scale;
  int causal, q_offset, k_offset;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + 64) of a strided (S, D) slice into a shared f32 tile with
// row stride D + 4, times `scale`; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int S,
                                          float scale) {
  constexpr int RS = D + 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * RS + c] =
        row < S ? to_f32(src[(int64_t)row * row_stride + c]) * scale : 0.f;
  }
}

// acc[i][c] += sum_d A[4*ty + i][d] * B[tx + 16*c][d]: one 4 x 4 block of a
// 64 x 64 product of two shared tiles with row stride D + 4 (float4 reads;
// the padding keeps the B rows of eight lanes in distinct banks).
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int RS = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * RS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * RS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(a[i].x, b[c].x, acc[i][c]);
        acc[i][c] = fmaf(a[i].y, b[c].y, acc[i][c]);
        acc[i][c] = fmaf(a[i].z, b[c].z, acc[i][c]);
        acc[i][c] = fmaf(a[i].w, b[c].w, acc[i][c]);
      }
  }
}

__device__ __forceinline__ bool key_visible(const Params& p, int key,
                                            int qpos) {
  return key < p.Sk && (!p.causal || qpos >= key + p.k_offset);
}

// P and dS of one 4 x 4 block: rows 4*ty + i of the query tile at q0, keys
// k0 + tx + 16*c.  s holds S, dp holds dP; on return s holds P and dp dS.
__device__ __forceinline__ void probs_and_ds(const Params& p, float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* sL, const float* sD,
                                             int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const float l = sL[r], dl = sD[r];
    const bool live = l > NEG_INF * 0.5f;
    const int qpos = q0 + r + p.q_offset;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float pv = live && key_visible(p, k0 + tx + 16 * c, qpos)
                           ? expf(s[i][c] - l)
                           : 0.f;
      s[i][c] = pv;
      dp[i][c] = pv * (dp[i][c] - dl);
    }
  }
}

// lse and delta of rows [q0, q0 + 64); rows past Sq are dead (P = 0).
__device__ __forceinline__ void load_row_stats(const Params& p, int bh,
                                               int q0, float* sL, float* sD) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    const int64_t r = (int64_t)bh * p.Sq + qi;
    sL[threadIdx.x] = qi < p.Sq ? p.lse[r] : NEG_INF;
    sD[threadIdx.x] = qi < p.Sq ? p.delta[r] : 0.f;
  }
}

// ========================================================== delta kernel
constexpr int DELTA_ROWS = NT / 32;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
                float* __restrict__ delta, int H, int Sq, int D, int rows,
                int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t g_sb,
                int64_t g_sh, int64_t g_ss) {
  const int row = blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / Sq, i = row % Sq;
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * o_sb + h * o_sh + (int64_t)i * o_ss;
  const T* grow = g + b * g_sb + h * g_sh + (int64_t)i * g_ss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// =========================================================== dK/dV kernel
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * PS + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int RS = D + 4;
  constexpr int DC = D / 16;  // columns of dK/dV per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + 64 * RS;
  float* sQ = sV + 64 * RS;  // q * sm_scale
  float* sG = sQ + 64 * RS;
  float* sP = sG + 64 * RS;  // [query][key]
  float* sdS = sP + 64 * PS;
  float* sL = sdS + 64 * PS;
  float* sD = sL + 64;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D>(sK, kp, p.k_ss, k0, p.Sk, 1.f);
  load_tile<T, D>(sV, vp, p.v_ss, k0, p.Sk, 1.f);

  // dK and dV rows 4*ty + j of this key tile, columns tx + 16*c
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[j][c] = dv[j][c] = 0.f;

  // the first query tile holding a row that can see key k0
  int iq = 0;
  if (p.causal) {
    const int first = k0 + p.k_offset - p.q_offset;
    iq = first <= 0 ? 0 : first / BQ;
  }
  const int n_q = (p.Sq + BQ - 1) / BQ;
  for (; iq < n_q; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // every reader of the previous tile is done
    load_tile<T, D>(sQ, qp, p.q_ss, q0, p.Sq, p.sm_scale);
    load_tile<T, D>(sG, gp, p.g_ss, q0, p.Sq, 1.f);
    load_row_stats(p, bh, q0, sL, sD);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    tile_dot<D>(s, sQ, sK, ty, tx);   // S = (q*scale) K^T
    tile_dot<D>(dp, sG, sV, ty, tx);  // dP = g V^T
    probs_and_ds(p, s, dp, sL, sD, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sP[(4 * ty + i) * PS + tx + 16 * c] = s[i][c];
        sdS[(4 * ty + i) * PS + tx + 16 * c] = dp[i][c];
      }
    __syncthreads();

    // dV += P^T g and dK += dS^T (q*scale), summed over the tile's rows
#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + i * PS + 4 * ty);
      const float4 ds =
          *reinterpret_cast<const float4*>(sdS + i * PS + 4 * ty);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float gv = sG[i * RS + tx + 16 * c];
        const float qv = sQ[i * RS + tx + 16 * c];
        dv[0][c] = fmaf(pv.x, gv, dv[0][c]);
        dv[1][c] = fmaf(pv.y, gv, dv[1][c]);
        dv[2][c] = fmaf(pv.z, gv, dv[2][c]);
        dv[3][c] = fmaf(pv.w, gv, dv[3][c]);
        dk[0][c] = fmaf(ds.x, qv, dk[0][c]);
        dk[1][c] = fmaf(ds.y, qv, dk[1][c]);
        dk[2][c] = fmaf(ds.z, qv, dk[2][c]);
        dk[3][c] = fmaf(ds.w, qv, dk[3][c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + 4 * ty + j;
    if (key >= p.Sk) continue;
    const int64_t r = ((int64_t)bh * p.Sk + key) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      static_cast<T*>(p.dk)[r + tx + 16 * c] = from_f32<T>(dk[j][c]);
      static_cast<T*>(p.dv)[r + tx + 16 * c] = from_f32<T>(dv[j][c]);
    }
  }
}

// ============================================================== dQ kernel
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 64 * PS + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int RS = D + 4;
  constexpr int DC = D / 16;  // columns of dQ per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // q * sm_scale
  float* sG = sQ + 64 * RS;
  float* sK = sG + 64 * RS;
  float* sV = sK + 64 * RS;
  float* sdS = sV + 64 * RS;  // [query][key]
  float* sL = sdS + 64 * PS;
  float* sD = sL + 64;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D>(sQ, qp, p.q_ss, q0, p.Sq, p.sm_scale);
  load_tile<T, D>(sG, gp, p.g_ss, q0, p.Sq, 1.f);
  load_row_stats(p, bh, q0, sL, sD);

  // KV tiles that the real rows [q0, min(q0 + 64, Sq)) can see, as the
  // forward's visible_tiles counts them
  int n = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_k = min(q0 + BQ, p.Sq) - 1 + p.q_offset - p.k_offset;
    n = last_k < 0 ? 0 : min(n, last_k / BK + 1);
  }

  // dQ rows 4*ty + i of this query tile, columns tx + 16*c
  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every reader of the previous K/V tile is done
    load_tile<T, D>(sK, kp, p.k_ss, k0, p.Sk, 1.f);
    load_tile<T, D>(sV, vp, p.v_ss, k0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sG, sV, ty, tx);
    probs_and_ds(p, s, dp, sL, sD, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sdS[(4 * ty + i) * PS + tx + 16 * c] = dp[i][c];
    // a dS row is read back only by the 16 lanes of the warp that wrote it
    __syncwarp();

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(4 * ty + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[j * RS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(ds[i], kv, dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
    T* row = static_cast<T*>(p.dq) + ((int64_t)bh * p.Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      row[tx + 16 * c] = from_f32<T>(dq[i][c] * p.sm_scale);
  }
}

// ================================================================ host
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch_dkdv(const Params& p, int BH, cudaStream_t s) {
  constexpr size_t smem = dkdv_smem<D>();
  cudaError_t err = set_smem(flash_bwd_dkdv<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sk + BK - 1) / BK, BH);
  flash_bwd_dkdv<T, D><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Params& p, int BH, cudaStream_t s) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = set_smem(flash_bwd_dq<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, BH);
  flash_bwd_dq<T, D><<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool dkdv, int D, const Params& p, int BH, cudaStream_t s) {
  switch (D) {
    case 16: return dkdv ? launch_dkdv<T, 16>(p, BH, s) : launch_dq<T, 16>(p, BH, s);
    case 32: return dkdv ? launch_dkdv<T, 32>(p, BH, s) : launch_dq<T, 32>(p, BH, s);
    case 64: return dkdv ? launch_dkdv<T, 64>(p, BH, s) : launch_dq<T, 64>(p, BH, s);
    case 128: return dkdv ? launch_dkdv<T, 128>(p, BH, s) : launch_dq<T, 128>(p, BH, s);
  }
  return (int)cudaErrorInvalidValue;
}

int run(bool dkdv, const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int H, int Sq, int Sk, int D, int64_t q_sb,
        int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
        int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh,
        int64_t g_ss, float sm_scale, int causal, int q_offset, int k_offset,
        void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_ss = g_ss;
  p.sm_scale = sm_scale; p.causal = causal;
  p.q_offset = q_offset; p.k_offset = k_offset;
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(dkdv, D, p, B * H, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkdv, D, p, B * H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta (B*H*Sq, f32) = rowsum(o * g);
// strides in elements for the batch, head and sequence dims (the head dim
// contiguous).  Returns cudaGetLastError() after the launch, 0 on success.
extern "C" int ray_flash_bwd_delta(const void* o, const void* g, void* delta,
                                   int dtype, int B, int H, int Sq, int D,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   int64_t g_sb, int64_t g_sh, int64_t g_ss,
                                   void* stream) {
  const int rows = B * H * Sq;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + DELTA_ROWS - 1) / DELTA_ROWS);
  float* out = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_bwd_delta<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(g), out, H, Sq,
        D, rows, o_sb, o_sh, o_ss, g_sb, g_sh, g_ss);
  } else if (dtype == 1) {
    flash_bwd_delta<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(g), out, H, Sq, D, rows, o_sb, o_sh,
        o_ss, g_sb, g_sh, g_ss);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dK and dV (B*H, Sk, D) in the input type from q, k, v, g (strided), lse
// and delta (f32, (B*H, Sq)).  dq is not touched.
extern "C" int ray_flash_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Sk, int D, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh,
    int64_t g_ss, float sm_scale, int causal, int q_offset, int k_offset,
    void* stream) {
  return run(true, q, k, v, g, lse, delta, dq, dk, dv, dtype, B, H, Sq, Sk, D,
             q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb, g_sh,
             g_ss, sm_scale, causal, q_offset, k_offset, stream);
}

// dQ (B*H, Sq, D) in the input type; the same arguments as
// ray_flash_bwd_dkdv, of which dk and dv are not touched.
extern "C" int ray_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Sk, int D, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh,
    int64_t g_ss, float sm_scale, int causal, int q_offset, int k_offset,
    void* stream) {
  return run(false, q, k, v, g, lse, delta, dq, dk, dv, dtype, B, H, Sq, Sk,
             D, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb,
             g_sh, g_ss, sm_scale, causal, q_offset, k_offset, stream);
}
