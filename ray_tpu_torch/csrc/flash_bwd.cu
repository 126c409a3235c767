// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces `_flash_backward` (ray_tpu/ops/attention.py:189-247), the
// custom_vjp backward of the Pallas forward kernel (:251-273).  There it is
// an XLA `lax.scan` over KV blocks that carries dq; here it is two kernels,
// launched in this order on one stream:
//
//  * dQ: grid (ceil(Sq/64), B*H).  A CTA owns a 64-row query tile.  In its
//    prologue, while its first tile loads are in flight, it computes delta
//    = rowsum(o*g) in f32 for its rows (o and g widened from the input
//    type, read straight from global memory, a warp a row, the loads of
//    many rows in flight before any sum), keeps it for its own dS and writes
//    it to a (B*H, Sq) f32 buffer for dK/dV.  It then
//    walks exactly the KV tiles its rows can see (the causal arithmetic of
//    the forward's visible_tiles, with q_offset and k_offset), recomputes
//    S and dP, masks keys >= Sk, causal pairs and dead rows (lse <= -5e29
//    gives P = 0), takes P = exp(S*scale - lse), dS = P * (dP - delta), and
//    accumulates dQ += dS K; the epilogue multiplies by sm_scale.
//  * dK/dV: grid (ceil(Sk/64), B*H).  A CTA owns one 64-key tile and walks
//    the 64-row query tiles from the first one whose last row can see the
//    tile's first key, with the lse and the delta (written by dQ; stream
//    order makes it visible) of their rows; per query tile it recomputes S
//    and dP, masks as above, and accumulates dV += P^T g and dK += dS^T q;
//    dK takes sm_scale at the end.
//
// delta is RowShare::dot, the very function of the standalone
// flash_bwd_delta kernel (kept for callers that want delta alone): one warp
// per row, lane c summing columns c, c+32, ... by fmaf from 0, then a
// butterfly 16..1, so the delta dQ writes is bit for bit that kernel's,
// and dq, dk, dv are what a separate delta launch would give.
//
// No atomics.  A dQ summed by atomics from the dK/dV CTAs would save the
// second pass, but its summation order would change from run to run; with
// two kernels every CTA owns its outputs, every sum has a fixed order, and a
// gradient repeats bit for bit.  The price is S and dP computed twice.
//
// Each of dK/dV and dQ has two variants, chosen by (dtype, D) alone
// (ops/attention.py:bwd_variant chooses the same):
//
//  * *_wgmma (bf16, D 64 or 128): the tensor cores.  One consumer warpgroup
//    (128 threads) on 64 rows, as the forward's flash_fwd_wgmma.  Tiles
//    arrive by TMA (cp.async.bulk.tensor, 64 x 64 boxes, 128-byte swizzle,
//    completion on mbarriers, thread 0 the only producer): the CTA's own
//    tiles once, the streamed ones through a 2-stage ring that thread 0
//    refills as soon as the warpgroup is done with a stage.  Every product
//    is wgmma with bf16 inputs and f32 accumulators, in a form the forward
//    already uses: S^T = K q^T and dP^T = V g^T (dK/dV), S = q K^T and
//    dP = g V^T (dQ), both operands K-major in shared memory; then P^T (or
//    dS) converted to bf16 in registers as wgmma's A operand for dV += P^T g
//    and dK += dS^T q (dQ += dS K), the B tile read through an MN-major
//    descriptor: the same shared tile that the S product read K-major.
//    Scores never touch shared memory.  In the dK/dV kernel the query index
//    is the accumulator's column, so lse and delta of the query tile are
//    staged in shared memory beside it (a dead or padded row as
//    lse = +inf, which makes exp2 give exactly 0).  S stays f32:
//    sm_scale is applied after the product, never to q in bf16 (1/sqrt(128)
//    is not a power of two), and P = exp2(S*scale*log2(e) - lse*log2(e)).
//    The rounding this variant adds: P and dS go to bf16 (8 significant
//    bits) before the dV, dK and dQ products; S, dP and every accumulation
//    are f32.  Warp specialisation, ping-pong between two warpgroups and
//    setmaxnreg are later work.
//  * *_simt (f32, and bf16 with D 16 or 32): exact f32 FMA on the CUDA
//    cores (the f32 parity bars are 1e-5): bf16 widened on load, all tiles
//    in shared memory as f32, 256 threads each owning a 4 x 4 block of the
//    64 x 64 score tile, P and dS passed through shared memory.
//
// dq, dk, dv are written once, contiguous (B, H, S, D), in the input type.
// Inputs are strided (batch, head and sequence strides in elements, a
// contiguous head dim): the training path hands q, k, v as views of the
// fused QKV projection and g as a transposed view; the tensor-core variant
// needs 16-byte bases and strides (the wrapper copies an input that has
// not).  TMA fills rows past S with zeros; rows past Sq are dead, keys past
// Sk masked, and dK/dV rows past Sk not stored.
//
// What bounds it on this card.  The function needs 10*D flops per visible
// (query, key) pair (S, dV, dP, dQ and dK, each 2*D); this two-pass design
// does 14*D (S and dP in both kernels: 8*D in dK/dV, 6*D in dQ).  At the
// training shape (B 16, H 12, S 1024, D 64, causal, bf16: 1.008e8 visible
// pairs) 10*D is 64.5 GFLOP, 0.065 ms at the bf16 tensor-core peak
// (989 TFLOP/s), and 14*D is 90.3 GFLOP, 0.091 ms; the bytes (q, k, v, o,
// g and lse read once, dq, dk, dv written once, 0.20 GB) take 0.060 ms at
// 3.35 TB/s.  So it is bound by operations, on the tensor cores only: the
// CUDA cores' f32 rate (67 TFLOP/s) would put the floor at 0.96 ms.  The
// dQ kernel's own bytes are q, g, o, k, v and lse read once, delta and dq
// written once: o and delta add 25.2 MB and 0.8 MB to what it moved with a
// separate delta pass, 7.8 us at 3.35 TB/s if none of it hides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per CUDA-core CTA: 16 x 16, each 4 x 4
constexpr int PS = BK + 4;  // row stride of the 64 x 64 score tiles
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const void* o;       // read by dQ only, for delta
  const float* lse;    // (B*H, Sq)
  float* delta;        // (B*H, Sq): written by dQ, read by dK/dV
  void* dq;            // (B*H, Sq, D), contiguous
  void* dk;            // (B*H, Sk, D), contiguous
  void* dv;            // (B*H, Sk, D), contiguous
  int H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb, g_sh,
      g_ss, o_sb, o_sh, o_ss;
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

__device__ __forceinline__ bool key_visible(const Params& p, int key,
                                            int qpos) {
  return key < p.Sk && (!p.causal || qpos >= key + p.k_offset);
}

// The first query tile holding a row that can see key k0.
__device__ __forceinline__ int first_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int first = k0 + p.k_offset - p.q_offset;
  return first <= 0 ? 0 : first / BQ;
}

// KV tiles that the real rows [q0, min(q0 + 64, Sq)) can see, as the
// forward's visible_tiles counts them.
__device__ __forceinline__ int visible_kv_tiles(const Params& p, int q0) {
  int n = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_k = min(q0 + BQ, p.Sq) - 1 + p.q_offset - p.k_offset;
    n = last_k < 0 ? 0 : min(n, last_k / BK + 1);
  }
  return n;
}

// Whether the (query tile q0, key tile k0) pair holds a masked pair: keys
// past Sk, or under the causal mask a key later than the tile's first query.
__device__ __forceinline__ bool pair_needs_mask(const Params& p, int q0,
                                                int k0) {
  return k0 + BK > p.Sk ||
         (p.causal && k0 + BK - 1 + p.k_offset > q0 + p.q_offset);
}

// ======================================================== CUDA-core path
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

// ================================================================ delta
// One lane's share of a row of o and g, widened to f32: columns lane,
// lane + 32, ... (zeros past D, or for a row that is not there).
template <typename T, int D>
struct RowShare {
  static constexpr int PER = (D + 31) / 32;
  float o[PER], g[PER];

  __device__ __forceinline__ void load(const T* orow, const T* grow, bool in,
                                       int lane) {
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      const int c = lane + 32 * x;
      const bool ok = in && c < D;
      o[x] = ok ? to_f32(orow[c]) : 0.f;
      g[x] = ok ? to_f32(grow[c]) : 0.f;
    }
  }

  // rowsum(o*g) in f32, in every lane of the warp: lane c accumulates its
  // columns c, c+32, ... by fmaf from 0, then a butterfly 16..1.  The
  // standalone delta kernel and the dQ kernels sum alike, so the delta
  // each writes is bit for bit the other's.
  __device__ __forceinline__ float dot(int lane) const {
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < PER; ++x)
      if (lane + 32 * x < D) acc = fmaf(o[x], g[x], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
  }
};

// The dQ kernels' prologue: delta of the query tile's rows [q0, q0 + 64)
// into sDelta (0 past Sq) and, for the rows below Sq, into p.delta for
// dK/dV.  NW warps, warp w taking rows w, w + NW, ...; each warp starts the
// loads of RC rows before it sums any, so a tile costs one or two memory
// round trips (o is cold in L2 after the forward), not one a row.
template <typename T, int D, int NW>
__device__ __forceinline__ void tile_delta(const Params& p, int bh, int q0,
                                           float* sDelta) {
  constexpr int RPW = BQ / NW;                          // rows per warp
  constexpr int RC = RPW < 1024 / D ? RPW : 1024 / D;  // 64 floats a lane
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
#pragma unroll
  for (int j0 = 0; j0 < RPW; j0 += RC) {
    RowShare<T, D> share[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int qi = q0 + warp + NW * (j0 + j);
      share[j].load(op + (int64_t)qi * p.o_ss, gp + (int64_t)qi * p.g_ss,
                    qi < p.Sq, lane);
    }
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int r = warp + NW * (j0 + j), qi = q0 + r;
      const float d = share[j].dot(lane);
      if (lane == 0) {
        sDelta[r] = qi < p.Sq ? d : 0.f;
        if (qi < p.Sq) p.delta[(int64_t)bh * p.Sq + qi] = d;
      }
    }
  }
}

// The standalone delta kernel, one warp per row; the backward itself takes
// delta from the dQ kernel's prologue.
constexpr int DELTA_ROWS = NT / 32;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
                float* __restrict__ delta, int H, int Sq, int rows,
                int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t g_sb,
                int64_t g_sh, int64_t g_ss) {
  const int row = blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / Sq, i = row % Sq;
  const int b = bh / H, h = bh % H;
  RowShare<T, D> share;
  share.load(o + b * o_sb + h * o_sh + (int64_t)i * o_ss,
             g + b * g_sb + h * g_sh + (int64_t)i * g_ss, true, lane);
  const float acc = share.dot(lane);
  if (lane == 0) delta[row] = acc;
}

// ============================================== dK/dV kernel, CUDA cores
template <int D>
constexpr size_t dkdv_simt_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * PS + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_simt(const Params p) {
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

  const int n_q = (p.Sq + BQ - 1) / BQ;
  for (int iq = first_q_tile(p, k0); iq < n_q; ++iq) {
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

// ================================================= dQ kernel, CUDA cores
template <int D>
constexpr size_t dq_simt_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 64 * PS + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_simt(const Params p) {
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
  if (tid < BQ)
    sL[tid] = q0 + tid < p.Sq ? p.lse[(int64_t)bh * p.Sq + q0 + tid] : NEG_INF;
  tile_delta<T, D, NT / 32>(p, bh, q0, sD);  // for every row, seen or not
  const int n = visible_kv_tiles(p, q0);

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

// ===================================================== tensor-core path
constexpr int WG_NT = 128;      // one consumer warpgroup
constexpr int WG_STAGES = 2;    // ring depth of the streamed tiles
constexpr int SUB = 64 * 64 * 2;  // one 64 x 64 bf16 sub-tile, 8 KB

// Bytes of dynamic shared memory: two resident 64-row tiles, then two per
// stage; +1024 to align the base for the swizzle.
template <int D>
constexpr size_t wgmma_smem() {
  return (size_t)(D / 64) * SUB * (2 + 2 * WG_STAGES) + 1024;
}

// lse in base 2 of query row qi (a row past Sq, or a dead row with
// lse <= -5e29, as +inf: exp2(x - inf) is exactly 0), and its delta.
__device__ __forceinline__ float row_lse2(const Params& p, int bh, int qi) {
  const float l = qi < p.Sq ? p.lse[(int64_t)bh * p.Sq + qi] : NEG_INF;
  return l > NEG_INF * 0.5f ? l * LOG2E : __int_as_float(0x7f800000);
}
__device__ __forceinline__ float row_delta(const Params& p, int bh, int qi) {
  return qi < p.Sq ? p.delta[(int64_t)bh * p.Sq + qi] : 0.f;
}

// acc (+)= A B^T over the head dim, A and B two 64-row bf16 tiles of
// swizzled 64-column sub-tiles, both K-major (the S and dP products).
template <int D>
__device__ __forceinline__ void wgmma_tile_abt(float (&acc)[32],
                                               const unsigned char* a,
                                               const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * SUB + (kk % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a + off, 16, 1024),
                       desc_sw128(b + off, 16, 1024), 1);
  }
}

// acc += A B, A a 64 x 64 bf16 fragment in registers (16 columns per
// a[kk]), B a 64-row tile read MN-major (the dV, dK and dQ products).
template <int D>
__device__ __forceinline__ void wgmma_frag_b(float (&acc)[D / 2],
                                             const uint32_t (&a)[4][4],
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 rows of B a step
    wgmma_rs<D>(acc, a[kk], desc_sw128(b + kk * 2048, SUB, 1024));
}

// A 64 x 64 f32 accumulator fragment as bf16 register A operands.
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4],
                                        const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

template <int D>
__global__ void __launch_bounds__(WG_NT)
flash_bwd_dkdv_wgmma(const Params p, const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g) {
  static_assert(D == 64 || D == 128, "the tensor-core path takes D 64 or 128");
  constexpr int NH = D / 64;      // 64-column sub-tiles (128-byte rows)
  constexpr int TILE = NH * SUB;  // bytes of one 64-row tile
  constexpr int NA = D / 2;       // dK (and dV) registers per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  __shared__ __align__(8) uint64_t kvbar;
  // per stage: lse * log2(e) (+inf for dead rows) and delta of the q tile
  __shared__ __align__(16) float sL2[WG_STAGES][BQ];
  __shared__ __align__(16) float sDl[WG_STAGES][BQ];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sK = base;
  unsigned char* sV = base + TILE;
  auto sQ = [&](int st) { return base + TILE * (2 + 2 * st); };
  auto sG = [&](int st) { return base + TILE * (3 + 2 * st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const int iq0 = first_q_tile(p, k0);
  const int n = max((p.Sq + BQ - 1) / BQ - iq0, 0);

  auto issue_qg = [&](int it) {  // thread 0 only
    const int st = it % WG_STAGES;
    const int q0 = (iq0 + it) * BQ;
    mbar_arrive_expect_tx(&full[st], 2 * TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tma_load_4d(sQ(st) + hh * SUB, &tm_q, &full[st], hh * 64, q0, h, b);
      tma_load_4d(sG(st) + hh * SUB, &tm_g, &full[st], hh * 64, q0, h, b);
    }
  };
  // threads 0-63 stage the lse of a tile's rows, threads 64-127 its delta
  auto fetch_row = [&](int it) {
    const int qi = (iq0 + it) * BQ + tid % BQ;
    return tid < BQ ? row_lse2(p, bh, qi) : row_delta(p, bh, qi);
  };
  auto put_row = [&](int st, float x) {
    (tid < BQ ? sL2[st] : sDl[st])[tid % BQ] = x;
  };

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(&kvbar, 1);
    fence_barrier_init();
  }
  for (int it = 0; it < min(n, WG_STAGES); ++it) put_row(it, fetch_row(it));
  __syncthreads();
  if (tid == 0 && n > 0) {  // a key tile no query sees loads nothing
    mbar_arrive_expect_tx(&kvbar, 2 * TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tma_load_4d(sK + hh * SUB, &tm_k, &kvbar, hh * 64, k0, h, b);
      tma_load_4d(sV + hh * SUB, &tm_v, &kvbar, hh * 64, k0, h, b);
    }
    for (int it = 0; it < min(n, WG_STAGES); ++it) issue_qg(it);
  }

  // accumulator fragments: this thread's key rows r0 and r0 + 8; register
  // 4c + e holds column 8c + 2*(lane % 4) + (e & 1) of row r0 + 8*(e >> 1)
  // (a query for S^T and dP^T, a head-dim index for dK and dV)
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = p.sm_scale * LOG2E;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;

  if (n > 0) mbar_wait(&kvbar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % WG_STAGES;
    const int q0 = (iq0 + it) * BQ;
    // the row stats of a later tile, stored once this stage is free
    const float next = it + WG_STAGES < n ? fetch_row(it + WG_STAGES) : 0.f;
    mbar_wait(&full[st], (it / WG_STAGES) & 1);

    // S^T = K q^T and dP^T = V g^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_tile_abt<D>(s, sK, sQ(st));
    wgmma_tile_abt<D>(dp, sV, sG(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T*scale - lse) and dS^T = P^T (dP^T - delta), lse and
    // delta taken per column (query)
    const bool masked = pair_needs_mask(p, q0, k0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(&sL2[st][8 * c + cq]);
      const float2 dl =
          *reinterpret_cast<const float2*>(&sDl[st][8 * c + cq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        float pv = exp2f(fmaf(s[i], scale2, -((e & 1) ? l2.y : l2.x)));
        if (masked && !key_visible(p, k0 + r0 + 8 * (e >> 1),
                                   q0 + 8 * c + cq + (e & 1) + p.q_offset))
          pv = 0.f;
        s[i] = pv;
        dp[i] = pv * (dp[i] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P^T g and dK += dS^T q, P^T and dS^T as bf16 register A
    uint32_t pa[4][4], da[4][4];
    to_frag(pa, s);
    to_frag(da, dp);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    wgmma_frag_b<D>(dv, pa, sG(st));
    wgmma_frag_b<D>(dk, da, sQ(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);

    __syncthreads();  // the warpgroup is done with stage st and its stats
    if (it + WG_STAGES < n) {
      put_row(st, next);
      if (tid == 0) issue_qg(it + WG_STAGES);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + 8 * hr;
    if (key >= p.Sk) continue;
    const int64_t row = ((int64_t)bh * p.Sk + key) * D;
    __nv_bfloat16* dkrow = static_cast<__nv_bfloat16*>(p.dk) + row;
    __nv_bfloat16* dvrow = static_cast<__nv_bfloat16*>(p.dv) + row;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * c + cq) =
          __floats2bfloat162_rn(dk[4 * c + 2 * hr] * p.sm_scale,
                                dk[4 * c + 2 * hr + 1] * p.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * c + cq) =
          __floats2bfloat162_rn(dv[4 * c + 2 * hr], dv[4 * c + 2 * hr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WG_NT)
flash_bwd_dq_wgmma(const Params p, const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g) {
  static_assert(D == 64 || D == 128, "the tensor-core path takes D 64 or 128");
  constexpr int NH = D / 64;
  constexpr int TILE = NH * SUB;
  constexpr int NA = D / 2;  // dQ registers per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  __shared__ __align__(8) uint64_t qbar;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sQ = base;
  unsigned char* sG = base + TILE;
  auto sK = [&](int st) { return base + TILE * (2 + 2 * st); };
  auto sV = [&](int st) { return base + TILE * (3 + 2 * st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int n = visible_kv_tiles(p, q0);

  auto issue_kv = [&](int it) {  // thread 0 only
    const int st = it % WG_STAGES;
    mbar_arrive_expect_tx(&full[st], 2 * TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tma_load_4d(sK(st) + hh * SUB, &tm_k, &full[st], hh * 64, it * BK, h, b);
      tma_load_4d(sV(st) + hh * SUB, &tm_v, &full[st], hh * 64, it * BK, h, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {  // rows that see no key load nothing
    mbar_arrive_expect_tx(&qbar, 2 * TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tma_load_4d(sQ + hh * SUB, &tm_q, &qbar, hh * 64, q0, h, b);
      tma_load_4d(sG + hh * SUB, &tm_g, &qbar, hh * 64, q0, h, b);
    }
    for (int it = 0; it < min(n, WG_STAGES); ++it) issue_kv(it);
  }
  // delta of every row of the tile, seen or not, while the loads fly
  __shared__ __align__(16) float sDelta[BQ];
  tile_delta<__nv_bfloat16, D, WG_NT / 32>(p, bh, q0, sDelta);
  __syncthreads();

  // this thread's query rows r0 and r0 + 8; register 4c + e holds key (for
  // S, dP) or head-dim index (for dQ) 8c + 2*(lane % 4) + (e & 1) of row
  // r0 + 8*(e >> 1)
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = p.sm_scale * LOG2E;
  const float l2[2] = {row_lse2(p, bh, q0 + r0), row_lse2(p, bh, q0 + r0 + 8)};
  const float dl[2] = {sDelta[r0], sDelta[r0 + 8]};
  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;

  if (n > 0) mbar_wait(&qbar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % WG_STAGES;
    const int k0 = it * BK;
    mbar_wait(&full[st], (it / WG_STAGES) & 1);

    // S = q K^T and dP = g V^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_tile_abt<D>(s, sQ, sK(st));
    wgmma_tile_abt<D>(dp, sG, sV(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - delta), P = exp(S*scale - lse)
    const bool masked = pair_needs_mask(p, q0, k0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      float pv = exp2f(fmaf(s[i], scale2, -l2[hr]));
      if (masked && !key_visible(p, k0 + 8 * (i / 4) + cq + (i & 1),
                                 q0 + r0 + 8 * hr + p.q_offset))
        pv = 0.f;
      dp[i] = pv * (dp[i] - dl[hr]);
    }

    // dQ += dS K, dS as bf16 register A, K read MN-major
    uint32_t da[4][4];
    to_frag(da, dp);
    fence_regs(dq);
    wgmma_fence();
    wgmma_frag_b<D>(dq, da, sK(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);

    __syncthreads();  // the warpgroup is done with stage st
    if (tid == 0 && it + WG_STAGES < n) issue_kv(it + WG_STAGES);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + 8 * hr;
    if (qi >= p.Sq) continue;
    __nv_bfloat16* row =
        static_cast<__nv_bfloat16*>(p.dq) + ((int64_t)bh * p.Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + cq) =
          __floats2bfloat162_rn(dq[4 * c + 2 * hr] * p.sm_scale,
                                dq[4 * c + 2 * hr + 1] * p.sm_scale);
  }
}

// ================================================================ host
template <typename T, int D>
int launch_simt(bool dkdv, const Params& p, int BH, cudaStream_t s) {
  const size_t smem = dkdv ? dkdv_simt_smem<D>() : dq_simt_smem<D>();
  const dim3 grid(((dkdv ? p.Sk : p.Sq) + 63) / 64, BH);
  cudaError_t err;
  if (dkdv) {
    err = set_smem(flash_bwd_dkdv_simt<T, D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_simt<T, D><<<grid, NT, smem, s>>>(p);
  } else {
    err = set_smem(flash_bwd_dq_simt<T, D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_simt<T, D><<<grid, NT, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(bool dkdv, const Params& p, int B, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tg;
  int e = make_map(&tq, p.q, D, p.Sq, p.H, B, p.q_sb, p.q_sh, p.q_ss);
  if (e == 0) e = make_map(&tk, p.k, D, p.Sk, p.H, B, p.k_sb, p.k_sh, p.k_ss);
  if (e == 0) e = make_map(&tv, p.v, D, p.Sk, p.H, B, p.v_sb, p.v_sh, p.v_ss);
  if (e == 0) e = make_map(&tg, p.g, D, p.Sq, p.H, B, p.g_sb, p.g_sh, p.g_ss);
  if (e != 0) return e;
  constexpr size_t smem = wgmma_smem<D>();
  const dim3 grid(((dkdv ? p.Sk : p.Sq) + 63) / 64, B * p.H);
  cudaError_t err;
  if (dkdv) {
    err = set_smem(flash_bwd_dkdv_wgmma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_wgmma<D><<<grid, WG_NT, smem, s>>>(p, tq, tk, tv, tg);
  } else {
    err = set_smem(flash_bwd_dq_wgmma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_wgmma<D><<<grid, WG_NT, smem, s>>>(p, tq, tk, tv, tg);
  }
  return (int)cudaGetLastError();
}

// The variant is a function of (dtype, D) alone: bf16 with D 64 or 128 on
// the tensor cores, the rest on the CUDA cores.
int dispatch(bool dkdv, int dtype, int D, const Params& p, int B,
             cudaStream_t s) {
  const int BH = B * p.H;
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_simt<__nv_bfloat16, 16>(dkdv, p, BH, s);
      case 32: return launch_simt<__nv_bfloat16, 32>(dkdv, p, BH, s);
      case 64: return launch_wgmma<64>(dkdv, p, B, s);
      case 128: return launch_wgmma<128>(dkdv, p, B, s);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return launch_simt<float, 16>(dkdv, p, BH, s);
      case 32: return launch_simt<float, 32>(dkdv, p, BH, s);
      case 64: return launch_simt<float, 64>(dkdv, p, BH, s);
      case 128: return launch_simt<float, 128>(dkdv, p, BH, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_delta(const void* o, const void* g, void* delta, int H, int Sq,
                 int D, int rows, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                 int64_t g_sb, int64_t g_sh, int64_t g_ss, cudaStream_t s) {
  const dim3 grid((rows + DELTA_ROWS - 1) / DELTA_ROWS);
  const T* op = static_cast<const T*>(o);
  const T* gp = static_cast<const T*>(g);
  float* out = static_cast<float*>(delta);
  switch (D) {
    case 16: flash_bwd_delta<T, 16><<<grid, NT, 0, s>>>(op, gp, out, H, Sq, rows, o_sb, o_sh, o_ss, g_sb, g_sh, g_ss); break;
    case 32: flash_bwd_delta<T, 32><<<grid, NT, 0, s>>>(op, gp, out, H, Sq, rows, o_sb, o_sh, o_ss, g_sb, g_sh, g_ss); break;
    case 64: flash_bwd_delta<T, 64><<<grid, NT, 0, s>>>(op, gp, out, H, Sq, rows, o_sb, o_sh, o_ss, g_sb, g_sh, g_ss); break;
    case 128: flash_bwd_delta<T, 128><<<grid, NT, 0, s>>>(op, gp, out, H, Sq, rows, o_sb, o_sh, o_ss, g_sb, g_sh, g_ss); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int run(bool dkdv, const void* q, const void* k, const void* v, const void* g,
        const void* o, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int dtype, int B, int H, int Sq, int Sk, int D,
        int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
        int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t g_sb,
        int64_t g_sh, int64_t g_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
        float sm_scale, int causal, int q_offset, int k_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.g = g; p.o = o;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_ss = g_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.sm_scale = sm_scale; p.causal = causal;
  p.q_offset = q_offset; p.k_offset = k_offset;
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  return dispatch(dkdv, dtype, D, p, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The standalone delta kernel (the backward takes delta from its dQ launch).
// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}.  delta
// (B*H*Sq, f32) = rowsum(o * g); strides in elements for the batch, head
// and sequence dims (the head dim contiguous).  Returns cudaGetLastError()
// after the launch, 0 on success.
extern "C" int ray_flash_bwd_delta(const void* o, const void* g, void* delta,
                                   int dtype, int B, int H, int Sq, int D,
                                   int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   int64_t g_sb, int64_t g_sh, int64_t g_ss,
                                   void* stream) {
  const int rows = B * H * Sq;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_delta<float>(o, g, delta, H, Sq, D, rows, o_sb, o_sh, o_ss,
                               g_sb, g_sh, g_ss,
                               static_cast<cudaStream_t>(stream));
  if (dtype == 1)
    return launch_delta<__nv_bfloat16>(o, g, delta, H, Sq, D, rows, o_sb,
                                       o_sh, o_ss, g_sb, g_sh, g_ss,
                                       static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

// The backward is two launches on one stream: ray_flash_bwd_dq first, which
// also writes delta, then ray_flash_bwd_dkdv, which reads it.  Both take the
// same arguments.  dtype: 0 = float32, 1 = bfloat16.  q, k, v, g and o are
// strided (strides in elements for the batch, head and sequence dims, the
// head dim contiguous); lse is f32 (B*H, Sq), delta an f32 (B*H, Sq)
// buffer.  bf16 with D 64 or 128 takes the tensor-core kernels, whose TMA
// maps need every base and stride of q, k, v, g 16-byte aligned (o is read
// without TMA); a refused map returns 10000 + its CUresult.  Otherwise the
// entries return cudaGetLastError() after the launch, 0 on success.

// dQ (B*H, Sq, D) in the input type, and delta = rowsum(o * g) of every
// row; o is read, dk and dv are not touched.
extern "C" int ray_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* g, const void* o,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh, int64_t g_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int causal,
    int q_offset, int k_offset, void* stream) {
  return run(false, q, k, v, g, o, lse, delta, dq, dk, dv, dtype, B, H, Sq,
             Sk, D, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb,
             g_sh, g_ss, o_sb, o_sh, o_ss, sm_scale, causal, q_offset,
             k_offset, stream);
}

// dK and dV (B*H, Sk, D) in the input type, from delta as the dQ launch
// wrote it; o and dq are not touched.
extern "C" int ray_flash_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* g, const void* o,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t g_sb, int64_t g_sh, int64_t g_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale, int causal,
    int q_offset, int k_offset, void* stream) {
  return run(true, q, k, v, g, o, lse, delta, dq, dk, dv, dtype, B, H, Sq,
             Sk, D, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb,
             g_sh, g_ss, o_sb, o_sh, o_ss, sm_scale, causal, q_offset,
             k_offset, stream);
}
