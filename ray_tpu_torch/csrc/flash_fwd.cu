// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` (ray_tpu/ops/attention.py:66-129,
// launched by `_flash_forward` through pl.pallas_call at :162).  Same function:
// online-softmax attention over q (B,H,Sq,D) and k/v (B,H,Sk,D) with running
// f32 (m, l, acc) per query row; a causal mask on absolute positions
// (q_offset + i >= k_offset + j) with runtime offsets; keys past Sk masked;
// fully masked rows give o = 0 and lse = -1e30; o in the input type and lse
// (B,H,Sq) in f32; strided q/k/v with a contiguous head dim, D in
// {16, 32, 64, 128}.
//
// What bounds each case on this card.  The work is 4*D flops per visible
// (query, key) pair against the bytes of q, k, v, o and lse.  A 64-row query
// tile does 4*64*64*D flops per 2*64*D elements of K/V it streams: in bf16
// that is 128 flops a byte, under the H100's 295 flops/byte ridge, so a bf16
// prefill is bound by bytes once it runs on the tensor cores; on the CUDA
// cores (f32, 67 TFLOP/s, ridge 20 flops/byte) the same tile is bound by
// operations.  A decode (Sq <= 16) reads all of K/V for a handful of rows:
// bound by bytes, and at serving sizes (B*H = 12, Sk = 600) by latency,
// since 12 heads give the card 12 independent pieces of work for 132 SMs.
//
// Design, one kernel per case, all with the same epilogue:
//
//  * flash_fwd_wgmma (bf16, D 64 or 128): the tensor-core path.  One CTA is
//    one consumer warpgroup (128 threads) owning 64 query rows.  Q is loaded
//    once by TMA; K/V tiles of 64 keys pass through a 3-stage ring in shared
//    memory, loaded by TMA (cp.async.bulk.tensor, 128-byte swizzle) and
//    signalled on one mbarrier per stage; thread 0 is the only producer and
//    refills a stage as soon as the warpgroup has finished with it, so the
//    next two tiles are in flight while one is computed.  S = Q K^T is
//    wgmma m64n64k16 (bf16 in, f32 accumulate) with both operands read from
//    swizzled shared memory (K-major).  The online softmax runs on the
//    accumulator fragment in registers (each thread holds 2 rows; row max by
//    quad shuffles; exp2 with the scale folded in; row sums stay per thread
//    until the end).  P is converted to bf16 in registers and is wgmma's
//    register A operand for O += P V; V is read through a transposed
//    (MN-major) descriptor.  S never touches shared memory.  Tensor maps are
//    encoded on the host for each call with cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint, so the library links no -lcuda.  Warp
//    specialisation, ping-pong between two warpgroups, setmaxnreg and fp8
//    are later work.
//
//  * flash_fwd_simt (f32, and bf16 with D 16 or 32): exact f32 FMA on the
//    CUDA cores (TF32 would break the serving path's 1e-4 logits bar).  256
//    threads own 64 query rows, each thread a 4x4 block of S and 4 rows x
//    D/16 columns of O.  K/V tiles are double-buffered with cp.async so the
//    next tile's load overlaps this tile's arithmetic; K is read as 16-byte
//    vectors from rows padded by 16 bytes (conflict-free).  The softmax runs
//    in registers, reduced over the 16 lanes that share a row; P goes through
//    shared memory only inside the warp that wrote it, so a tile costs one
//    __syncthreads (for the buffer hand-over) and two __syncwarp.
//
//  * flash_fwd_decode (Sq <= 16, both dtypes): a tile of 64 keys is spread
//    over the CTA's 128 threads instead of a 64-row query tile with one live
//    row.  For S, thread t takes key t % 64 and half t / 64 of the head dim
//    for every query row (partial dots summed through shared memory); the
//    softmax runs one warp per query row, a lane per two keys; for O += P V,
//    thread t owns 4 adjacent columns and a 1/(128/(D/4)) slice of the keys,
//    and the slices are summed once at the end.  K/V double-buffered with
//    cp.async as above.
//
//  * Split-KV, all three kernels: when B*H*ceil(Sq/block_q) CTAs would not
//    fill the 132 SMs, the wrapper (split_plan in ops/attention.py) cuts the
//    visible KV tiles of each query tile into `num_splits` contiguous runs.
//    CTA (q tile, b*h, split) walks its run and writes un-normalised f32
//    partials (m, l, acc); an empty or fully masked run writes m = -1e30,
//    l = 0.  The merge happens in the same launch, by a serial fix-up: each
//    split CTA, once its partials are written, meets at a barrier and
//    thread 0 bumps an int32 counter of its (q tile, b*h) with one acq_rel
//    atomic at GPU scope; the CTA that sees splits - 1 is the last, reads
//    every split's partials of its rows through L2 (__ldcg: L1 is not
//    coherent across SMs), merges them in the fixed order 0..splits-1 with
//    all its threads (merge_rows: a warp a row for the weights, a thread an
//    element for o) and writes o and lse, and sets the counter back to 0
//    for the next launch.  No CTA waits for another, so the splits need not
//    be co-resident.  merge_rows is the very function the standalone
//    flash_fwd_combine kernel runs, so o and lse are bit for bit the
//    combine kernel's on the same partials, whichever split arrives last,
//    and repeat run to run.  The wrapper keeps one zeroed buffer of num_sms
//    counters per (device, stream): splits are taken only when the tiles
//    are fewer than the SMs.
//    Thread-block clusters with DSMEM are not used: a cluster holds at most
//    8 portable (16 non-portable) CTAs, and the serving decode's 10 splits
//    of a head would not fit one.  With one split the kernels write o and
//    lse themselves.
//
// Ragged Sq and Sk edges are masked (TMA fills out-of-range rows with zeros,
// cp.async zero-fills them), so the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;  // keys per streamed tile, every kernel
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  float* part_acc;  // (B*H, splits, Sq, D), un-normalised
  float* part_m;    // (B*H, splits, Sq)
  float* part_l;    // (B*H, splits, Sq)
  int* counters;    // splits done, one per (q tile, b*h); 0 between launches
  int H, Sq, Sk, num_splits;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
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

// four consecutive elements from shared memory as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Number of KV tiles that the real rows [q0, q_end) of a query tile can see;
// ops/attention.py:_visible_tiles computes the same.
__device__ __forceinline__ int visible_tiles(const Params& p, int q0,
                                             int q_end) {
  int n = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_k = q_end - 1 + p.q_offset - p.k_offset;
    n = last_k < 0 ? 0 : min(n, last_k / BK + 1);
  }
  return n;
}

// This split's run [t0, t1) of the n visible tiles (split_plan's runs).
__device__ __forceinline__ void split_run(int n, int split, int splits,
                                          int& t0, int& t1) {
  t0 = (int)((int64_t)split * n / splits);
  t1 = (int)((int64_t)(split + 1) * n / splits);
}

// A tile needs the mask when it holds keys past Sk or, under the causal
// mask, keys later than the tile's first query.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int t,
                                                int q0) {
  return (t + 1) * BK > p.Sk ||
         (p.causal && t * BK + BK - 1 + p.k_offset > q0 + p.q_offset);
}

__device__ __forceinline__ bool key_visible(const Params& p, int key,
                                            int qpos) {
  return key < p.Sk && (!p.causal || qpos >= key + p.k_offset);
}

// Row epilogue: with one split, o = acc / l and lse; otherwise the partials.
// `m` is in natural-log units.
__device__ __forceinline__ int64_t part_row(const Params& p, int bh, int qi) {
  return ((int64_t)bh * p.num_splits + blockIdx.z) * p.Sq + qi;
}
__device__ __forceinline__ void store_stats(const Params& p, int bh, int qi,
                                            float m, float l) {
  if (p.num_splits == 1) {
    p.lse[(int64_t)bh * p.Sq + qi] = l == 0.f ? NEG_INF : m + logf(l);
  } else {
    const int64_t r = part_row(p, bh, qi);
    p.part_m[r] = l == 0.f ? NEG_INF : m;
    p.part_l[r] = l;
  }
}

// Shared memory merge_rows needs for n rows: the weights, then 1/l.
constexpr int MAX_SPLITS = 32;  // ops/attention.py MAX_SPLITS
__host__ __device__ constexpr int merge_floats(int n) {
  return n * MAX_SPLITS + n;
}

// Merge of the splits of the rows [row0, row0 + n) (row = b*h*Sq + qi, at
// most ROWS of them) into o and lse by the CTA's NT threads, in the fixed
// order 0..splits-1.  First the weights, a warp to every NT/32-th row, all
// its rows at once: lane s reads split s's m and l, the row max is a
// butterfly of fmaxf (exact, so any order gives it), lane s puts the
// weight exp(m_s - max) into sW, and l is summed over the splits in order
// by fmaf (every lane alike, from shuffles).  Then o, a thread to groups of
// four columns: for each split in order, acc = fmaf(partial, weight, acc).
// The loads never wait on a sum: a thread starts those of GC groups and U
// splits (16 float4 at 128 threads, 8 at 256) before it adds any, so the
// merge costs a few L2 round trips, not one per row or per split.  Partials
// are read through L2 (__ldcg): in the fused merge other SMs wrote them in
// this launch, and L1 is not coherent across SMs.  flash_fwd_combine and
// the split kernels' last CTA both run this function, and every element's
// sums are the same operations in the same order whatever the ROWS, NT or
// grouping, so their o and lse agree bit for bit.  sW holds n * splits
// floats and sInv n; splits <= MAX_SPLITS = 32; part_acc 16-byte aligned.
template <typename T, int D, int NT, int ROWS>
__device__ __forceinline__ void merge_rows(const float* part_acc,
                                           const float* part_m,
                                           const float* part_l, T* o,
                                           float* lse, int row0, int n,
                                           int Sq, int splits, float* sW,
                                           float* sInv) {
  constexpr int NW = NT / 32;
  constexpr int RA = (ROWS + NW - 1) / NW;  // rows a warp weighs, <= 32
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool in = lane < splits;
  // all of a warp's rows at once, so that their loads, shuffles and
  // arithmetic overlap; a row past n reads nothing and writes nothing
  float m[RA], l[RA], mx[RA], lsum[RA];
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = warp + NW * j, row = row0 + r;
    const int64_t at = ((int64_t)(row / Sq) * splits + lane) * Sq + row % Sq;
    m[j] = in && r < n ? __ldcg(part_m + at) : NEG_INF;
    l[j] = in && r < n ? __ldcg(part_l + at) : 0.f;
    mx[j] = m[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < RA; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
#pragma unroll
  for (int j = 0; j < RA; ++j) {
    const int r = warp + NW * j;
    m[j] = in ? expf(m[j] - mx[j]) : 0.f;  // now the weight
    if (in && r < n) sW[r * splits + lane] = m[j];
    lsum[j] = 0.f;
  }
  for (int s = 0; s < splits; ++s)
#pragma unroll
    for (int j = 0; j < RA; ++j)
      lsum[j] = fmaf(__shfl_sync(0xffffffffu, l[j], s),
                     __shfl_sync(0xffffffffu, m[j], s), lsum[j]);
  // every lane holds every row's sum: lane j finishes row j
  float my_l = 0.f, my_mx = NEG_INF;
#pragma unroll
  for (int j = 0; j < RA; ++j)
    if (lane == j) {
      my_l = lsum[j];
      my_mx = mx[j];
    }
  const int r_own = warp + NW * lane;
  if (lane < RA && r_own < n) {
    sInv[r_own] = my_l == 0.f ? 0.f : 1.f / my_l;
    lse[row0 + r_own] = my_l == 0.f ? NEG_INF : my_mx + logf(my_l);
  }
  __syncthreads();

  constexpr int DG = D / 4;                       // 4-column groups a row
  constexpr int GT = (ROWS * DG + NT - 1) / NT;   // groups a thread, at most
  constexpr int GC = GT < 8 ? GT : 8;             // of them at once
  constexpr int U = (2048 / NT) / GC > 0 ? (2048 / NT) / GC : 1;  // splits
  const int ng = n * DG;
#pragma unroll 1
  for (int g0 = 0; g0 < GT; g0 += GC) {
    int64_t src[GC];  // split 0's partial of the group; split s: + s*Sq*D
    int rr[GC];
    float4 acc[GC];
#pragma unroll
    for (int i = 0; i < GC; ++i) {
      const int gi = threadIdx.x + (g0 + i) * NT;
      const int r = gi / DG, row = row0 + r;
      rr[i] = r;
      src[i] = ((int64_t)(row / Sq) * splits * Sq + row % Sq) * D +
               (gi % DG) * 4;
      acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < splits; s0 += U) {
      float4 v[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < GC; ++i)
          v[u][i] = s0 + u < splits && threadIdx.x + (g0 + i) * NT < ng
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part_acc + src[i] + (int64_t)(s0 + u) * Sq * D))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= splits) break;
#pragma unroll
        for (int i = 0; i < GC; ++i) {
          if (threadIdx.x + (g0 + i) * NT >= ng) continue;
          const float w = sW[rr[i] * splits + s0 + u];
          acc[i].x = fmaf(v[u][i].x, w, acc[i].x);
          acc[i].y = fmaf(v[u][i].y, w, acc[i].y);
          acc[i].z = fmaf(v[u][i].z, w, acc[i].z);
          acc[i].w = fmaf(v[u][i].w, w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GC; ++i) {
      const int gi = threadIdx.x + (g0 + i) * NT;
      if (gi >= ng) continue;
      const float inv = sInv[rr[i]];
      T* out = o + (int64_t)(row0 + rr[i]) * D + (gi % DG) * 4;
      out[0] = from_f32<T>(acc[i].x * inv);
      out[1] = from_f32<T>(acc[i].y * inv);
      out[2] = from_f32<T>(acc[i].z * inv);
      out[3] = from_f32<T>(acc[i].w * inv);
    }
  }
}

// After a split CTA has written its partials: whether it is the last of its
// (q tile, b*h) to finish, in every thread.  The CTA meets (its partial
// stores ordered before thread 0's next operation), and thread 0 adds one
// to the tile's counter with an acq_rel atomic at GPU scope: the release
// publishes the CTA's partials with the count, the acquire makes the other
// splits' partials visible to a CTA that sees splits - 1, and the second
// barrier hands that on to its threads (the pattern of CUTLASS's
// GenericBarrier, with no fence in every thread).  The last CTA puts the
// counter back to 0: every other split of the tile has counted, and the
// next launch on the stream starts after this one ends.
__device__ __forceinline__ bool last_split(const Params& p) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                 : "=r"(prev)
                 : "l"(counter), "r"(1)
                 : "memory");
    s_last = prev == p.num_splits - 1;
    if (s_last) *counter = 0;
  }
  __syncthreads();
  return s_last;
}

// The last split CTA of a tile merges rows [q0, q_end) of its b*h, with
// `scratch` (merge_floats(q_end - q0) floats of the kernel's shared memory,
// free once the partials are written) for the weights.
template <typename T, int D, int NT, int ROWS>
__device__ __forceinline__ void merge_tile(const Params& p, int bh, int q0,
                                           int q_end, float* scratch) {
  const int n = q_end - q0;
  merge_rows<T, D, NT, ROWS>(p.part_acc, p.part_m, p.part_l,
                             static_cast<T*>(p.o), p.lse, bh * p.Sq + q0, n,
                             p.Sq, p.num_splits, scratch,
                             scratch + n * MAX_SPLITS);
}

// cp.async one (BK x D) tile of K or V (rows past Sk zero-filled) into a
// shared tile with row stride KS elements.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int64_t row_stride, int k0,
                                                int Sk, int KS) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / VE;          // chunks per row
  for (int idx = threadIdx.x; idx < BK * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int ki = k0 + r;
    const bool in = ki < Sk;
    cp_async16(dst + r * KS + c * VE, src + (in ? ki * row_stride : 0) + c * VE,
               in ? 16 : 0);
  }
}

// ===================================================== CUDA-core kernel
constexpr int SIMT_BQ = 64;
constexpr int SIMT_NT = 256;
constexpr int SIMT_PS = BK + 1;  // padded row stride of P

template <typename T, int D>
__host__ __device__ constexpr int simt_ks() { return D + 16 / (int)sizeof(T); }

template <typename T, int D>
constexpr size_t simt_smem() {
  return sizeof(float) * (SIMT_BQ * D + SIMT_BQ * SIMT_PS) +
         sizeof(T) * 4 * BK * simt_ks<T, D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(SIMT_NT)
flash_fwd_simt(const Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int KS = simt_ks<T, D>();
  constexpr int DC = D / 16;  // O columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = sQ + SIMT_BQ * D;
  T* sK = reinterpret_cast<T*>(sP + SIMT_BQ * SIMT_PS);  // [2][BK][KS]
  T* sV = sK + 2 * BK * KS;                              // [2][BK][KS]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * SIMT_BQ;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  int t0, t1;
  split_run(visible_tiles(p, q0, min(q0 + SIMT_BQ, p.Sq)), blockIdx.z,
            p.num_splits, t0, t1);
  if (t0 < t1) {
    load_tile_async<T, D, SIMT_NT>(sK, kp, p.k_ss, t0 * BK, p.Sk, KS);
    load_tile_async<T, D, SIMT_NT>(sV, vp, p.v_ss, t0 * BK, p.Sk, KS);
    cp_async_commit();
  }
  for (int idx = tid; idx < SIMT_BQ * D; idx += SIMT_NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    sQ[idx] = qi < p.Sq ? to_f32(qp[qi * p.q_ss + c]) * p.sm_scale : 0.f;
  }

  // thread tiling: rows ty*4 .. ty*4+3, columns tx + 16*c; the 16 threads
  // of a row group are 16 adjacent lanes of one warp
  const int ty = tid / 16, tx = tid % 16;
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    cp_async_wait_all();
    // tile t is visible to all; everyone is done with the other buffer
    __syncthreads();
    if (t + 1 < t1) {
      load_tile_async<T, D, SIMT_NT>(sK + (buf ^ 1) * BK * KS, kp, p.k_ss,
                                     (t + 1) * BK, p.Sk, KS);
      load_tile_async<T, D, SIMT_NT>(sV + (buf ^ 1) * BK * KS, vp, p.v_ss,
                                     (t + 1) * BK, p.Sk, KS);
      cp_async_commit();
    }
    const T* tK = sK + buf * BK * KS;
    const T* tV = sV + buf * BK * KS;

    // S = (Q * sm_scale) K^T
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(sQ + (ty * 4 + i) * D + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = load4(tK + (tx + 16 * c) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }
    if (tile_needs_mask(p, t, q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!key_visible(p, t * BK + tx + 16 * c,
                           q0 + ty * 4 + i + p.q_offset))
            s[i][c] = NEG_INF;
    }

    // online softmax in registers, reduced over the row's 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key so far keeps p = 0 (not exp(0) = 1)
      const bool dead = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = dead ? 0.f : expf(s[i][c] - m_new);
        sP[(ty * 4 + i) * SIMT_PS + tx + 16 * c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows are read only by the lanes that wrote them

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * SIMT_PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = to_f32(tV[kk * KS + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncwarp();  // before the next tile overwrites this warp's P rows
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    if (p.num_splits == 1) {
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
      T* orow = static_cast<T*>(p.o) + ((int64_t)bh * p.Sq + qi) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    } else {
      float* prow = p.part_acc + part_row(p, bh, qi) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) prow[tx + 16 * c] = acc[i][c];
    }
    if (tx == 0) store_stats(p, bh, qi, m[i], l[i]);
  }
  if (p.num_splits > 1 && last_split(p))
    merge_tile<T, D, SIMT_NT, SIMT_BQ>(p, bh, q0, min(q0 + SIMT_BQ, p.Sq),
                                        sQ);
}

// ======================================================== decode kernel
constexpr int DEC_NT = 128;

template <typename T, int D, int NQ>
constexpr size_t decode_smem() {
  // sQ [NQ][D], sS [2][NQ][BK], sP [NQ][BK], sRed [NKP][NQ][D]
  // (NKP * D = 512), sA/sM/sL [NQ] each (padded to 16 bytes together),
  // sK/sV [2][BK][KS]
  return sizeof(float) * (NQ * D + 3 * NQ * BK + 512 * NQ +
                          (3 * NQ + 3) / 4 * 4) +
         sizeof(T) * 4 * BK * (D + 16 / sizeof(T));
}

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(DEC_NT)
flash_fwd_decode(const Params p) {
  constexpr int KS = D + 16 / (int)sizeof(T);
  constexpr int HALF = D / 2;        // head-dim half of one S thread
  constexpr int NCV = D / 4;         // 4-column groups of O
  constexpr int NKP = DEC_NT / NCV;  // key slices of O += P V
  constexpr int KPS = BK / NKP;      // keys per slice
  constexpr int RPW = (NQ + 3) / 4;  // softmax rows per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sS = sQ + NQ * D;       // [2][NQ][BK]
  float* sP = sS + 2 * NQ * BK;  // [NQ][BK]
  float* sRed = sP + NQ * BK;    // [NKP][NQ][D]
  float* sA = sRed + NKP * NQ * D;
  float* sM = sA + NQ;
  float* sL = sM + NQ;
  T* sK = reinterpret_cast<T*>(sA + (3 * NQ + 3) / 4 * 4);
  T* sV = sK + 2 * BK * KS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  int t0, t1;
  split_run(visible_tiles(p, 0, p.Sq), blockIdx.z, p.num_splits, t0, t1);
  if (t0 < t1) {
    load_tile_async<T, D, DEC_NT>(sK, kp, p.k_ss, t0 * BK, p.Sk, KS);
    load_tile_async<T, D, DEC_NT>(sV, vp, p.v_ss, t0 * BK, p.Sk, KS);
    cp_async_commit();
  }
  for (int idx = tid; idx < NQ * D; idx += DEC_NT) {
    const int i = idx / D, c = idx % D;
    sQ[idx] = i < p.Sq ? to_f32(qp[i * p.q_ss + c]) * p.sm_scale : 0.f;
  }

  // S: key j = tid % BK, head-dim half tid / BK
  const int sj = tid % BK, shalf = tid / BK;
  // O: columns 4*ocv .. 4*ocv+3, keys okp*KPS .. +KPS
  const int ocv = tid % NCV, okp = tid / NCV;
  float m[RPW], l[RPW];  // softmax rows warp + 4*r, held by every lane
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  float acc[NQ][4];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t visible; the other buffer and sP are free
    if (t + 1 < t1) {
      load_tile_async<T, D, DEC_NT>(sK + (buf ^ 1) * BK * KS, kp, p.k_ss,
                                    (t + 1) * BK, p.Sk, KS);
      load_tile_async<T, D, DEC_NT>(sV + (buf ^ 1) * BK * KS, vp, p.v_ss,
                                    (t + 1) * BK, p.Sk, KS);
      cp_async_commit();
    }
    const T* tK = sK + buf * BK * KS;
    const T* tV = sV + buf * BK * KS;

    // partial dots over one half of the head dim, every query row
    {
      float s[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) s[i] = 0.f;
      const T* krow = tK + sj * KS + shalf * HALF;
      const float* qh = sQ + shalf * HALF;
#pragma unroll 4
      for (int d = 0; d < HALF; d += 4) {
        const float4 kv = load4(krow + d);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const float4 qv = load4(qh + i * D + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) sS[(shalf * NQ + i) * BK + sj] = s[i];
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w+4, ...; a lane takes two keys
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + 4 * r;
      if (i >= NQ) break;
      float sv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        sv[e] = sS[i * BK + j] + sS[(NQ + i) * BK + j];
        if (!key_visible(p, t * BK + j, i + p.q_offset)) sv[e] = NEG_INF;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const bool dead = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = dead ? 0.f : expf(sv[e] - m_new);
        sP[i * BK + lane + 32 * e] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      if (lane == 0) sA[i] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's key slice
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float a = sA[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int x = 0; x < KPS; ++x) {
      const int kk = okp * KPS + x;
      const float4 vv = load4(tV + kk * KS + ocv * 4);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float pv = sP[i * BK + kk];
        acc[i][0] = fmaf(pv, vv.x, acc[i][0]);
        acc[i][1] = fmaf(pv, vv.y, acc[i][1]);
        acc[i][2] = fmaf(pv, vv.z, acc[i][2]);
        acc[i][3] = fmaf(pv, vv.w, acc[i][3]);
      }
    }
  }

  // sum the key slices in a fixed order, then the epilogue
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    *reinterpret_cast<float4*>(sRed + (okp * NQ + i) * D + ocv * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + 4 * r;
      if (i < NQ) {
        sM[i] = m[r];
        sL[i] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NQ * D; idx += DEC_NT) {
    const int i = idx / D, c = idx % D;
    if (i >= p.Sq) continue;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < NKP; ++s) a += sRed[(s * NQ + i) * D + c];
    const float li = sL[i];
    if (p.num_splits == 1) {
      T* orow = static_cast<T*>(p.o) + ((int64_t)bh * p.Sq + i) * D;
      orow[c] = from_f32<T>(li == 0.f ? 0.f : a / li);
    } else {
      p.part_acc[part_row(p, bh, i) * D + c] = a;
    }
    if (c == 0) store_stats(p, bh, i, sM[i], li);
  }
  if (p.num_splits > 1 && last_split(p))
    merge_tile<T, D, DEC_NT, NQ>(p, bh, 0, p.Sq, sQ);
}

// ==================================================== tensor-core kernel
constexpr int WG_BQ = 64;
constexpr int WG_NT = 128;
constexpr int WG_STAGES = 3;
constexpr int SUB = 64 * 64 * 2;  // one 64 x 64 bf16 sub-tile, 8 KB

template <int D>
constexpr size_t wgmma_smem() {
  // Q, then per stage K and V; +1024 to align the base for the swizzle
  return (size_t)(D / 64) * SUB * (1 + 2 * WG_STAGES) + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_NT)
flash_fwd_wgmma(const Params p, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  static_assert(D == 64 || D == 128, "the tensor-core path takes D 64 or 128");
  constexpr int NH = D / 64;         // 64-column sub-tiles (128-byte rows)
  constexpr int TILE = NH * SUB;     // bytes of one 64-row tile
  constexpr int NO = D / 2;          // O accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  __shared__ __align__(8) uint64_t qbar;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sQ = base;
  auto sK = [&](int st) { return base + TILE * (1 + 2 * st); };
  auto sV = [&](int st) { return base + TILE * (2 + 2 * st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * WG_BQ;
  int t0, t1;
  split_run(visible_tiles(p, q0, min(q0 + WG_BQ, p.Sq)), blockIdx.z,
            p.num_splits, t0, t1);
  const int n = t1 - t0;

  auto issue_kv = [&](int it) {  // thread 0 only
    const int st = it % WG_STAGES;
    const int k0 = (t0 + it) * BK;
    mbar_arrive_expect_tx(&full[st], 2 * TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      tma_load_4d(sK(st) + hh * SUB, &tm_k, &full[st], hh * 64, k0, h, b);
      tma_load_4d(sV(st) + hh * SUB, &tm_v, &full[st], hh * 64, k0, h, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {  // an empty run loads nothing
    mbar_arrive_expect_tx(&qbar, TILE);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      tma_load_4d(sQ + hh * SUB, &tm_q, &qbar, hh * 64, q0, h, b);
    for (int it = 0; it < min(n, WG_STAGES); ++it) issue_kv(it);
  }

  // accumulator fragment: this thread's rows r0 and r0 + 8; register
  // 4c + e holds column 8c + 2*(lane % 4) + (e & 1) of row r0 + 8*(e >> 1)
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale2 = p.sm_scale * LOG2E;  // softmax in base 2
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  if (n > 0) mbar_wait(&qbar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % WG_STAGES;
    const int t = t0 + it;
    mbar_wait(&full[st], (it / WG_STAGES) & 1);

    // S = Q K^T, both K-major in swizzled shared memory
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * SUB + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, desc_sw128(sQ + off, 16, 1024),
                         desc_sw128(sK(st) + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment
    const bool masked = tile_needs_mask(p, t, q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale2;
      if (masked) {
        const int key = t * BK + 8 * (i / 4) + cq + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + p.q_offset;
        if (!key_visible(p, key, qpos)) x = NEG_INF;
      }
      s[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        mx = fmaxf(mx, fmaxf(s[4 * c + 2 * hr], s[4 * c + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[hr], mx);
      const bool dead = m_new <= NEG_INF * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * c + 2 * hr + e];
          x = dead ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      alpha[hr] = exp2f(m2[hr] - m_new);
      l[hr] = l[hr] * alpha[hr] + sum;  // this thread's columns only
      m2[hr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P (bf16, registers) as the A operand of O += P V
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys a step; V MN-major
      wgmma_rs<D>(o, a[kk], desc_sw128(sV(st) + kk * 2048, SUB, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    __syncthreads();  // the warpgroup is done with stage st
    if (tid == 0 && it + WG_STAGES < n) issue_kv(it + WG_STAGES);
  }

  // row sums across the quad, then the epilogue
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + 8 * hr;
    if (qi >= p.Sq) continue;
    if (p.num_splits == 1) {
      const float inv = l[hr] == 0.f ? 0.f : 1.f / l[hr];
      __nv_bfloat16* orow =
          static_cast<__nv_bfloat16*>(p.o) + ((int64_t)bh * p.Sq + qi) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + cq) =
            __floats2bfloat162_rn(o[4 * c + 2 * hr] * inv,
                                  o[4 * c + 2 * hr + 1] * inv);
    } else {
      float* prow = p.part_acc + part_row(p, bh, qi) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(prow + 8 * c + cq) =
            make_float2(o[4 * c + 2 * hr], o[4 * c + 2 * hr + 1]);
    }
    if (lane % 4 == 0) store_stats(p, bh, qi, m2[hr] * LN2, l[hr]);
  }
  if (p.num_splits > 1 && last_split(p))
    merge_tile<__nv_bfloat16, D, WG_NT, WG_BQ>(
        p, bh, q0, min(q0 + WG_BQ, p.Sq), reinterpret_cast<float*>(base));
}

// ======================================================= combine kernel
// The split kernels merge their own partials (last_split); this standalone
// kernel merges partials handed to it, CMB_ROWS rows a CTA, with the same
// merge_rows.
constexpr int CMB_ROWS = 4;  // one warp per row for the row sums

template <typename T, int D>
__global__ void __launch_bounds__(32 * CMB_ROWS)
flash_fwd_combine(const float* __restrict__ part_acc,
                  const float* __restrict__ part_m,
                  const float* __restrict__ part_l, T* __restrict__ o,
                  float* __restrict__ lse, int rows, int Sq, int splits) {
  __shared__ float scratch[merge_floats(CMB_ROWS)];
  const int row0 = blockIdx.x * CMB_ROWS;
  const int n = min(CMB_ROWS, rows - row0);
  merge_rows<T, D, 32 * CMB_ROWS, CMB_ROWS>(part_acc, part_m, part_l, o, lse,
                                           row0, n, Sq, splits, scratch,
                                           scratch + n * MAX_SPLITS);
}

// ================================================================ host
enum Variant { SIMT = 0, WGMMA = 1, DECODE = 2 };

template <typename T, int D>
cudaError_t launch_simt(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = simt_smem<T, D>();
  cudaError_t err = set_smem(flash_fwd_simt<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_simt<T, D><<<grid, SIMT_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int NQ>
cudaError_t launch_decode(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = decode_smem<T, D, NQ>();
  cudaError_t err = set_smem(flash_fwd_decode<T, D, NQ>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_decode<T, D, NQ><<<grid, DEC_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_wgmma(const Params& p, int B, dim3 grid, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, p.q, D, p.Sq, p.H, B, p.q_sb, p.q_sh, p.q_ss);
  if (e == 0) e = make_map(&tk, p.k, D, p.Sk, p.H, B, p.k_sb, p.k_sh, p.k_ss);
  if (e == 0) e = make_map(&tv, p.v, D, p.Sk, p.H, B, p.v_sb, p.v_sh, p.v_ss);
  if (e != 0) return e;
  constexpr size_t smem = wgmma_smem<D>();
  cudaError_t err = set_smem(flash_fwd_wgmma<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<D><<<grid, WG_NT, smem, stream>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int variant, int D, const Params& p, dim3 grid,
             cudaStream_t s) {
  if (variant == SIMT) {
    switch (D) {
      case 16: return (int)launch_simt<T, 16>(p, grid, s);
      case 32: return (int)launch_simt<T, 32>(p, grid, s);
      case 64: return (int)launch_simt<T, 64>(p, grid, s);
      case 128: return (int)launch_simt<T, 128>(p, grid, s);
    }
  } else if (variant == DECODE) {
    if (p.Sq > 16) return (int)cudaErrorInvalidValue;
    const bool one = p.Sq == 1;
    switch (D) {
      case 16: return (int)(one ? launch_decode<T, 16, 1>(p, grid, s) : launch_decode<T, 16, 16>(p, grid, s));
      case 32: return (int)(one ? launch_decode<T, 32, 1>(p, grid, s) : launch_decode<T, 32, 16>(p, grid, s));
      case 64: return (int)(one ? launch_decode<T, 64, 1>(p, grid, s) : launch_decode<T, 64, 16>(p, grid, s));
      case 128: return (int)(one ? launch_decode<T, 128, 1>(p, grid, s) : launch_decode<T, 128, 16>(p, grid, s));
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int combine(int D, const float* acc, const float* m, const float* l, void* o,
            float* lse, int rows, int Sq, int splits, cudaStream_t s) {
  const dim3 grid((rows + CMB_ROWS - 1) / CMB_ROWS);
  T* out = static_cast<T*>(o);
  switch (D) {
    case 16: flash_fwd_combine<T, 16><<<grid, 32 * CMB_ROWS, 0, s>>>(acc, m, l, out, lse, rows, Sq, splits); break;
    case 32: flash_fwd_combine<T, 32><<<grid, 32 * CMB_ROWS, 0, s>>>(acc, m, l, out, lse, rows, Sq, splits); break;
    case 64: flash_fwd_combine<T, 64><<<grid, 32 * CMB_ROWS, 0, s>>>(acc, m, l, out, lse, rows, Sq, splits); break;
    case 128: flash_fwd_combine<T, 128><<<grid, 32 * CMB_ROWS, 0, s>>>(acc, m, l, out, lse, rows, Sq, splits); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = CUDA cores (Sq > 16),
// 1 = tensor cores (bf16, D 64 or 128), 2 = decode (Sq <= 16).  Strides are
// in elements, for the batch, head and sequence dims of q, k, v (the head dim
// must be contiguous; every stride and base 16-byte aligned).  With
// num_splits == 1 the kernel writes o and lse; otherwise its CTAs write the
// f32 partials part_acc (B*H, splits, Sq, D), part_m and part_l (B*H,
// splits, Sq), and the last split CTA of each (q tile, b*h) merges them
// into o and lse in the same launch.  `counters` then holds num_counters
// int32 zeros, at least one per (q tile, b*h), and holds zeros again when
// the kernel ends.  Returns cudaGetLastError() after the launch (0 on
// success), or 10000 + the CUresult of cuTensorMapEncodeTiled when it
// refuses a TMA tensor map.
extern "C" int ray_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* part_acc, void* part_m,
                             void* part_l, void* counters, int num_counters,
                             int dtype, int variant, int num_splits, int B,
                             int H, int Sq, int Sk, int D, int64_t q_sb,
                             int64_t q_sh, int64_t q_ss, int64_t k_sb,
                             int64_t k_sh, int64_t k_ss, int64_t v_sb,
                             int64_t v_sh, int64_t v_ss, float sm_scale,
                             int causal, int q_offset, int k_offset,
                             void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.counters = static_cast<int*>(counters);
  p.H = H; p.Sq = Sq; p.Sk = Sk; p.num_splits = num_splits;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.sm_scale = sm_scale; p.causal = causal;
  p.q_offset = q_offset; p.k_offset = k_offset;
  if (num_splits < 1 || num_splits > MAX_SPLITS || B * H < 1)
    return (int)cudaErrorInvalidValue;
  const int bq = variant == DECODE ? 16 : 64;
  const dim3 grid((Sq + bq - 1) / bq, B * H, num_splits);
  if (num_splits > 1 &&
      (part_acc == nullptr || part_m == nullptr || part_l == nullptr ||
       counters == nullptr || (int64_t)grid.x * grid.y > num_counters))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == WGMMA) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_wgmma<64>(p, B, grid, s);
    if (D == 128) return launch_wgmma<128>(p, B, grid, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch<float>(variant, D, p, grid, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(variant, D, p, grid, s);
  return (int)cudaErrorInvalidValue;
}

// Merges the splits of each of the B*H*Sq rows in a fixed order into o (the
// input type, contiguous (B*H, Sq, D)) and lse (f32, (B*H, Sq)): the merge
// that ray_flash_fwd's split kernels do in their last CTA, on partials
// handed to it.
extern "C" int ray_flash_fwd_combine(const void* part_acc, const void* part_m,
                                     const void* part_l, void* o, void* lse,
                                     int dtype, int BH, int Sq, int D,
                                     int num_splits, void* stream) {
  const float* acc = static_cast<const float*>(part_acc);
  const float* m = static_cast<const float*>(part_m);
  const float* l = static_cast<const float*>(part_l);
  float* out_lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_splits < 1 || num_splits > MAX_SPLITS || BH * Sq < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return combine<float>(D, acc, m, l, o, out_lse, BH * Sq, Sq, num_splits, s);
  if (dtype == 1)
    return combine<__nv_bfloat16>(D, acc, m, l, o, out_lse, BH * Sq, Sq,
                                  num_splits, s);
  return (int)cudaErrorInvalidValue;
}
