// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` (ray_tpu/ops/attention.py:66-129,
// launched by `_flash_forward` through pl.pallas_call at :162).  Same function:
// online-softmax attention over q (B,H,Sq,D) and k/v (B,H,Sk,D) with running
// f32 (m, l, acc) per query row; a causal mask on absolute positions
// (q_offset + i >= k_offset + j) with runtime offsets; keys past Sk masked;
// fully masked rows give o = 0 and lse = -1e30; o in the input type and
// lse (B,H,Sq) in f32.
//
// Bound on this card: 4*B*H*D*(visible q,k pairs) FLOPs (4*B*H*Sq*Sk*D
// without a mask, about half that when causal) against the bytes of q, k, v
// and o.  At GPT-2 shapes (D = 64) a 64-row tile does 2*64*64*64 FLOPs per
// 2*64*64 elements of K/V it streams, so a full-sequence prefill is bound by
// arithmetic and a decode (one query row) by the bytes of K/V.
//
// Design.  The Pallas kernel keeps the whole (Sk, D) K/V of one head in VMEM;
// shared memory on Hopper cannot hold that for several blocks, so K/V are
// streamed in 64-row tiles.  One CTA of 256 threads owns one (b*h, 64-row
// q tile); Q (pre-scaled) stays in shared memory, each K/V tile is loaded,
// S = Q K^T is formed as 4x4 register micro-tiles per thread, masked and
// written to shared memory, the online softmax runs four threads per row, and
// acc (64 x D, f32, D/4 values per thread) is rescaled and accumulated in
// registers.  In causal mode the KV loop stops at the last tile that reaches
// the tile's last real query, so blocks past the diagonal cost nothing.
// Ragged Sq and Sk edges are masked here, so the wrapper pads nothing.
// Arithmetic is scalar f32 FMA: simple and exact enough for the 2e-3 bar;
// tensor cores (mma.sync / wgmma) and TMA are later work.  Known weak spot:
// decode has one query row, so 63 of the tile's 64 rows idle (a split-KV
// decode kernel is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // key rows per streamed tile
constexpr int NT = 256;      // threads per CTA
constexpr int PS = BK + 1;   // padded row stride of the score tile
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D], sK [BK][D+1], sV [BK][D], sP [BQ][BK+1], m/l/alpha [BQ]
  return sizeof(float) *
         (BQ * D + BK * (D + 1) + BK * D + BQ * PS + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 float sm_scale, int causal, int q_offset, int k_offset) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int KS = D + 1;   // padded K row: conflict-free column reads
  constexpr int DC = D / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * D;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * D;
  float* sM = sP + BQ * PS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    sQ[idx] = qi < Sq ? to_f32(qp[qi * q_ss + c]) * sm_scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) {
    // last key index any real query of this tile can see
    const int last_k = min(q0 + BQ, Sq) - 1 + q_offset - k_offset;
    n_kv = last_k < 0 ? 0 : min(n_kv, last_k / BK + 1);
  }

  // thread tiling: rows ty*4 .. ty*4+3, columns tx + 16*c
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int ki = k0 + r;
      const bool in = ki < Sk;
      sK[r * KS + c] = in ? to_f32(kp[ki * k_ss + c]) : 0.f;
      sV[idx] = in ? to_f32(vp[ki * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = (Q * sm_scale) K^T, masked
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * D + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const int ki = k0 + col;
        bool valid = ki < Sk;
        if (causal) valid = valid && (q0 + r + q_offset >= ki + k_offset);
        sP[r * PS + col] = valid ? s[i][c] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sP + r * PS;
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      // a row with no visible key so far keeps p = 0 (not exp(0) = 1)
      const bool dead = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = dead ? 0.f : expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

  // o and lse are contiguous (B, H, Sq, D) and (B, H, Sq)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = sL[r];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* orow = o + ((int64_t)bh * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
  if (tid < BQ && q0 + tid < Sq) {
    const float l = sL[tid];
    lse[(int64_t)bh * Sq + q0 + tid] = l == 0.f ? NEG_INF : sM[tid] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk,
                   const int64_t* st, float sm_scale, int causal,
                   int q_offset, int k_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, void* lse, int B, int H, int Sq, int Sk,
                       const int64_t* st, float sm_scale, int causal,
                       int q_offset, int k_offset, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, st, sm_scale, causal, q_offset, k_offset, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, st, sm_scale, causal, q_offset, k_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, st, sm_scale, causal, q_offset, k_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, st, sm_scale, causal, q_offset, k_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the batch,
// head and sequence dims of q, k, v (the head dim must be contiguous).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ray_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int H,
                             int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh,
                             int64_t q_ss, int64_t k_sb, int64_t k_sh,
                             int64_t k_ss, int64_t v_sb, int64_t v_sh,
                             int64_t v_ss, float sm_scale, int causal,
                             int q_offset, int k_offset, void* stream) {
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, o, lse, B, H, Sq, Sk, st,
                                  sm_scale, causal, q_offset, k_offset, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk,
                                          st, sm_scale, causal, q_offset,
                                          k_offset, s);
  return (int)cudaErrorInvalidValue;
}
