// K11: the decode-layer tail, everything a ParallelAttentionLayer decode step
// does after its self-attention: two cross-attentions over the projected
// visual K/V, their post-LN residuals, two sigmoid gates, the fused sum, the
// ReLU FFN and its post-LN residual, with the three pad multiplies.
//
// Replaces the TPU's grit_tpu/ops/decode_layer.py::_kernel (reached through
// _call / fused_decode_layer_tail).  What it computes is that module's _ref:
// operands of every product in the compute type with f32 accumulation, the q
// scaling, mask, softmax, LayerNorm (var = E[x^2] - mu^2), gates and residuals
// in f32, one rounding to the output type at the end.  The gate
// [x, enc] @ W is computed as x @ Ws + enc @ We.
//
// What bounds it on an H100: bytes.  One call reads one layer's 12 matrices
// (4.2 M values, 8.4 MB in bf16) and the K/V of its images (0.43 MB an image):
// ~12 MB at 8 images, ~63 MB at 128, against ~0.35 / 5.5 GFLOP.  The TPU
// kernel packs all heads into one block-diagonal product per image and takes
// 8 images a grid step to feed a 128 x 128 matrix unit from VMEM; none of that
// carries over.  40 rows (8 images x 5 beams) cannot fill 132 SMs by rows and
// no block can hold the weights, so the tail is one C entry point that issues
// a fixed chain of eight launches on the caller's stream:
//   1. q = (x Wq + bq) / sqrt(d) for both attentions        [R, 2D]
//   2. attention core, one block per (image, attention, head)  [R, 2D]
//   3. pre_i = x + o_i Wo_i + bo_i                             f32 [2, R, D]
//   4. enc_i = LN_i(pre_i) * pad                               f32 and T [2, R, D]
//   5. enc = (enc_1 s(x Ws_1 + enc_1 We_1 + b_1)
//             + enc_2 s(x Ws_2 + enc_2 We_2 + b_2)) / sqrt(2) * pad   f32 and T
//   6. h = relu(enc W1 + b1)                                   [R, F]
//   7. pre = enc + h W2 + b2                                   f32 [R, D]
//   8. out = LN_f(pre) * pad                                   [R, D]
// Intermediates go through device memory (they stay in L2: ~1 MB at 40 rows).
//
// Tensor parallel (grit_tpu's model axis): a rank holds F / tp of fc1's
// columns and fc2's rows, and the sum over the ranks must sit between fc2 and
// the final LayerNorm.  The entry's partial mode runs launches 1-7 on the
// rank's slice, fc2 writing its f32 sum without bias or residual (7'.
// part = h W2), the gated enc left in the f32 scratch for the residual, and
// skips launch 8; the caller all-reduces `part` in f32, and a second entry,
// grit_decode_tail_finish, does the rest in one launch:
//   9. out = LN_f(enc + (part + b2)) * pad                     [R, D]
// At tp 1 the eight-launch chain is unchanged.
//
// The five products (1, 3, 5, 6, 7) stream weights: a few rows against a
// weight read once.  They share one block routine, `product`:
// - a block owns 8 output columns (the n of mma.sync m16n8k16) and one tile of
//   up to 64 rows (m16 fragments: 40 rows take 48); the weight is spread over
//   64 (fc2, the gates) to 256 (fc1) blocks at 40 rows, and more row tiles
//   come in at 80 rows.  Past 128 rows (640 at b128) a block owns 32 columns,
//   so that each row tile of A is read by a quarter as many blocks;
// - its 8 warps split K: each walks its own contiguous run of 64-byte chunks
//   of K (32 bf16 or 16 f32 values) through its own 3-stage ring of 16-byte
//   cp.async copies (A rows and the weight rows, rows of 80 bytes so that
//   ldmatrix and float4 reads hit distinct banks), the next chunk issued
//   before the current one's product, with no block barrier in the loop;
// - up to 128 rows the gates' and fc2's K (2048) is split over a cluster of
//   two blocks as well (128 blocks each at 40 rows, half the bytes a block);
// - each warp leaves its f32 partial tile in shared memory and the epilogue
//   sums the warps of the block, or of the cluster through distributed
//   shared memory, in a fixed order (the gates: the first half of the warps
//   the first gate), so the outputs are the same bit for bit from call to
//   call: no atomics;
// - bf16 runs mma.sync m16n8k16 on ldmatrix fragments; fp32 (the parity path
//   and the fp32 trainers' decoding) the same blocks, staging and split with
//   SIMT fmaf on float4 reads, 16 rows a lane, in full f32;
// - A is always of the compute type: launches 4 and 5 also write a
//   compute-type copy of enc_i and enc (in fp32 the f32 rows themselves).
// The attention launch (2) keeps one block per (image, attention, head) and
// the image's `fold` query rows, 8 warps: it stages the head's K and V
// columns (T x d each, rows padded by 16 bytes) in shared memory with 16-byte
// cp.async, V's copy in flight during the scores and softmax; scores take a
// thread a key, with q broadcast from shared memory; softmax a warp a row,
// one reciprocal a row, probabilities rounded to the compute type; P V takes
// the lanes over the head's channel pairs and the warps over the keys, the
// warps' partials summed in order.
// Timed by chip_smoke.py (device time by CUDA-graph replay, each launch by
// the profiler); kernel_variants.py times variants of this source.
#include <cooperative_groups.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace grit {
// internal linkage: a variant library built from this source (kernel_variants.py)
// loads beside the kernel library without sharing its kernels or statics
namespace {

constexpr int DT_THREADS = 128;   // the LayerNorm launches
constexpr float DT_NEG = -1e30f;  // additive mask: exp underflows to exactly 0
constexpr size_t DT_SMEM_MAX = 232448;  // a block's shared memory on Hopper, 227 KB

// products: 8 warps, 8 columns and up to 64 rows a block, K in chunks of 64
// bytes, a 3-stage cp.async ring a warp
constexpr int PR_WARPS = 8, PR_THREADS = PR_WARPS * 32, PR_STAGES = 3;
constexpr int PR_MAXM = 64, PR_KB = 64, PR_RB = PR_KB + 16;
// past PR_WIDE_ROWS rows a block takes 8 * PR_WIDE_NF columns: each A row tile is
// then read by a quarter as many blocks
constexpr int PR_WIDE_ROWS = 128, PR_WIDE_NF = 4;
// up to PR_WIDE_ROWS rows the gates' and fc2's K (4D and F) is split over a
// cluster of PR_SPLIT blocks too: twice the blocks, half the bytes a block
constexpr int PR_SPLIT = 2;

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One operand pair of a product: A [R, k] rows of the compute type (leading
// dimension lda) times W [N, k] in torch's Linear layout (leading dimension ldw).
struct Seg {
  const void* a;
  int lda;
  const void* w;
  int ldw;
  int k;
};

// A warp's partial 16*mf x 8*NF tile over its chunks; a stage holds the
// chunk's A rows then its 8*NF W rows, PR_RB bytes apart.
template <typename T, int NF> struct Chunk;

template <int NF> struct Chunk<bf16, NF> {
  float acc[4][NF][4];  // m16n8 accumulators of fragments 0..mf-1, n-fragment f
  __device__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][f][i] = 0.0f;
  }
  __device__ void run(const unsigned char* A, const unsigned char* W, int mf) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k0 = 0; k0 < PR_KB; k0 += 64) {  // 32 values of k at a time
      uint32_t b[NF][4];  // k 0-7, 8-15, 16-23, 24-31 of each 8 columns
#pragma unroll
      for (int f = 0; f < NF; ++f)
        ldsm_x4(b[f], smem_u32(W + (f * 8 + (lane & 7)) * PR_RB + k0 + (lane >> 3) * 16));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m < mf) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, smem_u32(A + (m * 16 + (lane & 15)) * PR_RB + k0 + kk * 32 +
                                (lane >> 4) * 16));
#pragma unroll
            for (int f = 0; f < NF; ++f) mma16816(acc[m][f], a, b[f][2 * kk], b[f][2 * kk + 1]);
          }
        }
      }
    }
  }
  __device__ void store(float* red, int mf) {  // red: f32 [16 mf][8 NF]
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m < mf) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          *reinterpret_cast<float2*>(red + (m * 16 + g) * 8 * NF + f * 8 + 2 * t4) =
              make_float2(acc[m][f][0], acc[m][f][1]);
          *reinterpret_cast<float2*>(red + (m * 16 + g + 8) * 8 * NF + f * 8 + 2 * t4) =
              make_float2(acc[m][f][2], acc[m][f][3]);
        }
      }
    }
  }
};

template <int NF> struct Chunk<float, NF> {
  float acc[16][NF];  // rows rb + 4 i, columns c + 8 f (lane = 8 rb + c)
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][f] = 0.0f;
  }
  __device__ void run(const unsigned char* A, const unsigned char* W, int mf) {
    const int lane = threadIdx.x & 31, c = lane & 7, rb = lane >> 3;
#pragma unroll
    for (int k4 = 0; k4 < PR_KB / 16; ++k4) {
      float4 w[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f)
        w[f] = *reinterpret_cast<const float4*>(W + (c + 8 * f) * PR_RB + k4 * 16);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < 4 * mf) {
          const float4 a = *reinterpret_cast<const float4*>(A + (rb + 4 * i) * PR_RB + k4 * 16);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            acc[i][f] = fmaf(a.x, w[f].x, acc[i][f]);
            acc[i][f] = fmaf(a.y, w[f].y, acc[i][f]);
            acc[i][f] = fmaf(a.z, w[f].z, acc[i][f]);
            acc[i][f] = fmaf(a.w, w[f].w, acc[i][f]);
          }
        }
      }
    }
  }
  __device__ void store(float* red, int mf) {
    const int lane = threadIdx.x & 31, c = lane & 7, rb = lane >> 3;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < 4 * mf)
#pragma unroll
        for (int f = 0; f < NF; ++f) red[(rb + 4 * i) * 8 * NF + c + 8 * f] = acc[i][f];
  }
};

__host__ __device__ constexpr int pr_stage_bytes(int mf, int nf) {
  return (mf * 16 + 8 * nf) * PR_RB;
}
__host__ __device__ constexpr int pr_warp_bytes(int mf, int nf) {
  return PR_STAGES * pr_stage_bytes(mf, nf);
}

// The block's rows [row0, row0 + nrows) (nrows <= 16 mf) times columns
// [col0, col0 + 8 NF) of this warp's output: the K of s0 then s1 (s1.k may
// be 0).  The wpz warps that share an output split its chunks into
// contiguous runs; this warp is the wl-th of them.  Leaves each warp's f32
// partial [16 mf][8 NF] at the start of its ring and ends with a block barrier.
template <typename T, int NF>
__device__ __forceinline__ void product(const Seg& s0, const Seg& s1, int wl, int wpz, int row0,
                                        int nrows, int mf, int col0, unsigned char* smem) {
  constexpr int KC = PR_KB / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mrows = mf * 16, sb = pr_stage_bytes(mf, NF);
  unsigned char* ring = smem + warp * pr_warp_bytes(mf, NF);
  const int n0 = s0.k / KC, nch = n0 + s1.k / KC;
  const int c0 = wl * nch / wpz, c1 = (wl + 1) * nch / wpz;
  auto issue = [&](int c, int stage) {
    if (c < c1) {
      const Seg& s = c < n0 ? s0 : s1;
      const int cc = c < n0 ? c : c - n0;
      const unsigned char* A = static_cast<const unsigned char*>(s.a) + (size_t)cc * PR_KB;
      const unsigned char* W = static_cast<const unsigned char*>(s.w) + (size_t)cc * PR_KB;
      const size_t lda = (size_t)s.lda * sizeof(T), ldw = (size_t)s.ldw * sizeof(T);
      const uint32_t dst = smem_u32(ring + stage * sb);
      constexpr int P = PR_KB / 16;  // 16-byte pieces a row
      for (int i = lane; i < mrows * P; i += 32) {
        const int r = i / P, q = i % P;
        const bool ok = r < nrows;  // rows past the tile read zeros
        cp_async16_zfill(dst + r * PR_RB + q * 16, A + (row0 + (ok ? r : 0)) * lda + q * 16, ok);
      }
      for (int i = lane; i < 8 * NF * P; i += 32) {  // the 8 NF W rows
        const int r = i / P, q = i % P;
        cp_async16(dst + (mrows + r) * PR_RB + q * 16, W + (size_t)(col0 + r) * ldw + q * 16);
      }
    }
    cp_async_commit();  // empty past the run: the group count stays uniform
  };
  Chunk<T, NF> acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < PR_STAGES - 1; ++s) issue(c0 + s, s);
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<PR_STAGES - 2>();
    __syncwarp();  // chunk c visible to the warp; chunk c - 1's stage free
    issue(c + PR_STAGES - 1, (c - c0 + PR_STAGES - 1) % PR_STAGES);
    const unsigned char* st = ring + ((c - c0) % PR_STAGES) * sb;
    acc.run(st, st + mrows * PR_RB, mf);
  }
  cp_async_wait<0>();
  __syncwarp();
  acc.store(reinterpret_cast<float*>(ring), mf);
  __syncthreads();
}

// The partial tiles of a block's cluster of KS blocks (a product whose K is
// split over KS blocks as well as over their warps): virtual warp v = rank *
// PR_WARPS + warp.  Output z's sum at element idx adds its wpz virtual warps in
// order, the same order whichever block of the cluster reads them.
template <int NF, int KS> struct Partials {
  const unsigned char* base[KS];
  __device__ explicit Partials(unsigned char* smem) {
    if constexpr (KS > 1) {
      cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
      cl.sync();  // every block's partials are written
#pragma unroll
      for (int r = 0; r < KS; ++r)
        base[r] = static_cast<const unsigned char*>(cl.map_shared_rank(static_cast<void*>(smem), r));
    } else {
      base[0] = smem;
    }
  }
  __device__ float sum(int mf, int wpz, int z, int idx) const {
    float s = 0.0f;
    for (int v = z * wpz; v < (z + 1) * wpz; ++v)
      s += reinterpret_cast<const float*>(base[v / PR_WARPS] +
                                          (v % PR_WARPS) * pr_warp_bytes(mf, NF))[idx];
    return s;
  }
  // the other blocks' reads are done before this block's shared memory goes
  __device__ void done() const {
    if constexpr (KS > 1) cooperative_groups::this_cluster().sync();
  }
};

// The row tile of a product block: `per` rows a tile, the last one ragged.
struct RowTile {
  int row0, nrows;
  __device__ RowTile(int R, int per) : row0(blockIdx.y * per), nrows(min(per, R - blockIdx.y * per)) {}
};

// 1. q projections: blockIdx.z picks the attention.  q [R, 2D].
template <typename T, int NF>
__global__ void __launch_bounds__(PR_THREADS) dt_qproj_kernel(
    const T* __restrict__ x, const T* wq1, const T* bq1, const T* wq2, const T* bq2,
    T* __restrict__ q, int R, int D, int per, int mf, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z, col0 = blockIdx.x * 8 * NF;
  const RowTile t(R, per);
  const Seg s{x, D, z ? wq2 : wq1, D, D};
  product<T, NF>(s, Seg{nullptr, 0, nullptr, 0, 0}, threadIdx.x >> 5, PR_WARPS, t.row0, t.nrows,
                 mf, col0, smem);
  const Partials<NF, 1> parts(smem);
  const T* bias = z ? bq2 : bq1;
  for (int idx = threadIdx.x; idx < t.nrows * 8 * NF; idx += PR_THREADS) {
    const int r = idx / (8 * NF), c = idx % (8 * NF);
    q[(size_t)(t.row0 + r) * 2 * D + z * D + col0 + c] =
        from_f<T>((parts.sum(mf, PR_WARPS, 0, idx) + to_f<T>(bias[col0 + c])) * scale);
  }
}

// 2. attention core.  grid (B, 2, H); dynamic shared memory (attn_smem): K
// and V rows [tmax][d + 16 bytes], q [fold][d] f32, scores / probabilities
// [fold][tmax] f32 (rounded up to 4), P V partials [4 warps][fold][d] f32.
constexpr int AT_THREADS = 256, AT_WARPS = AT_THREADS / 32, AT_ROWS = 8;  // rows a pass

template <typename T> __host__ __device__ constexpr int attn_ld(int d) {
  return d + 16 / (int)sizeof(T);
}
template <typename T> size_t attn_smem(int fold, int d, int tmax) {
  return (size_t)2 * tmax * attn_ld<T>(d) * sizeof(T) +
         ((size_t)fold * d + ((size_t)fold * tmax + 3) / 4 * 4 + (size_t)AT_WARPS * fold * d) *
             sizeof(float);
}

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__global__ void __launch_bounds__(AT_THREADS) dt_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k1, const T* __restrict__ v1,
    const unsigned char* __restrict__ m1, const T* __restrict__ k2, const T* __restrict__ v2,
    const unsigned char* __restrict__ m2, T* __restrict__ o, int fold, int T1, int T2, int D,
    int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, a = blockIdx.y, h = blockIdx.z;
  const int d = D / H, Tk = a ? T2 : T1, tmax = T1 > T2 ? T1 : T2, ld = attn_ld<T>(d);
  const T* kg = (a ? k2 : k1) + (size_t)b * Tk * D + h * d;
  const T* vg = (a ? v2 : v1) + (size_t)b * Tk * D + h * d;
  const unsigned char* mask = a ? m2 : m1;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)tmax * ld;
  float* qs = reinterpret_cast<float*>(vs + (size_t)tmax * ld);
  float* s = qs + fold * d;
  float* part = s + (fold * tmax + 3) / 4 * 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int PE = 16 / sizeof(T);  // values a 16-byte piece
  const int pieces = d / PE;
  for (int i = tid; i < Tk * pieces; i += AT_THREADS) {
    const int j = i / pieces, p = i - j * pieces;
    cp_async16(smem_u32(ks + (size_t)j * ld + p * PE), kg + (size_t)j * D + p * PE);
  }
  cp_async_commit();
  for (int i = tid; i < Tk * pieces; i += AT_THREADS) {
    const int j = i / pieces, p = i - j * pieces;
    cp_async16(smem_u32(vs + (size_t)j * ld + p * PE), vg + (size_t)j * D + p * PE);
  }
  cp_async_commit();
  for (int idx = tid; idx < fold * d; idx += AT_THREADS) {
    const int i = idx / d, dd = idx - i * d;
    qs[idx] = to_f<T>(q[(size_t)(b * fold + i) * 2 * D + a * D + h * d + dd]);
  }
  cp_async_wait<1>();  // K has landed; V is still in flight
  __syncthreads();
  // scores: a thread a key, q broadcast from shared memory
  for (int j = tid; j < Tk; j += AT_THREADS) {
    const float madd = (mask != nullptr && mask[(size_t)b * Tk + j]) ? DT_NEG : 0.0f;
    for (int i0 = 0; i0 < fold; i0 += AT_ROWS) {
      float acc[AT_ROWS];
#pragma unroll
      for (int r = 0; r < AT_ROWS; ++r) acc[r] = 0.0f;
      for (int dd = 0; dd < d; dd += 8) {
        float kf[8];
        load8(ks + (size_t)j * ld + dd, kf);
#pragma unroll
        for (int r = 0; r < AT_ROWS; ++r) {
          if (i0 + r < fold) {
            float qf[8];
            load8(qs + (i0 + r) * d + dd, qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r] = fmaf(qf[e], kf[e], acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < AT_ROWS; ++r)
        if (i0 + r < fold) s[(i0 + r) * Tk + j] = acc[r] + madd;
    }
  }
  __syncthreads();
  // softmax: a warp a query row; probabilities rounded to the compute type
  for (int i = warp; i < fold; i += AT_WARPS) {
    float mx = -INFINITY;
    for (int j = lane; j < Tk; j += 32) mx = fmaxf(mx, s[i * Tk + j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(s[i * Tk + j] - mx);
      s[i * Tk + j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < Tk; j += 32) s[i * Tk + j] = to_f<T>(from_f<T>(s[i * Tk + j] * inv));
  }
  cp_async_wait<0>();
  __syncthreads();
  // o = P V: lanes over the head's channel pairs, warps over the keys
  for (int i0 = 0; i0 < fold; i0 += AT_ROWS) {
    for (int c2 = lane; c2 < d / 2; c2 += 32) {
      float acc[AT_ROWS][2];
#pragma unroll
      for (int r = 0; r < AT_ROWS; ++r) acc[r][0] = acc[r][1] = 0.0f;
      for (int j = warp; j < Tk; j += AT_WARPS) {
        const float2 v = load2(vs + (size_t)j * ld + 2 * c2);
#pragma unroll
        for (int r = 0; r < AT_ROWS; ++r) {
          if (i0 + r < fold) {
            const float p = s[(i0 + r) * Tk + j];
            acc[r][0] = fmaf(p, v.x, acc[r][0]);
            acc[r][1] = fmaf(p, v.y, acc[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < AT_ROWS; ++r)
        if (i0 + r < fold)
          *reinterpret_cast<float2*>(part + ((size_t)warp * fold + i0 + r) * d + 2 * c2) =
              make_float2(acc[r][0], acc[r][1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < fold * d; idx += AT_THREADS) {
    const int i = idx / d, dd = idx - i * d;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < AT_WARPS; ++w) acc += part[(size_t)w * fold * d + idx];
    o[(size_t)(b * fold + i) * 2 * D + a * D + h * d + dd] = from_f<T>(acc);
  }
}

// 3. out projections with the residual: pre[z] = x + o_z Wo_z + bo_z (f32).
template <typename T, int NF>
__global__ void __launch_bounds__(PR_THREADS) dt_oproj_kernel(
    const T* __restrict__ o, const T* __restrict__ x, const T* wo1, const T* bo1, const T* wo2,
    const T* bo2, float* __restrict__ pre, int R, int D, int per, int mf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z, col0 = blockIdx.x * 8 * NF;
  const RowTile t(R, per);
  const Seg s{o + z * D, 2 * D, z ? wo2 : wo1, D, D};
  product<T, NF>(s, Seg{nullptr, 0, nullptr, 0, 0}, threadIdx.x >> 5, PR_WARPS, t.row0, t.nrows,
                 mf, col0, smem);
  const Partials<NF, 1> parts(smem);
  const T* bias = z ? bo2 : bo1;
  for (int idx = threadIdx.x; idx < t.nrows * 8 * NF; idx += PR_THREADS) {
    const int r = idx / (8 * NF), c = idx % (8 * NF), row = t.row0 + r, col = col0 + c;
    pre[((size_t)z * R + row) * D + col] =
        to_f<T>(x[(size_t)row * D + col]) +
        (parts.sum(mf, PR_WARPS, 0, idx) + to_f<T>(bias[col]));
  }
}

// 4 and 8. LayerNorm of f32 rows times pad, one warp per row; blockIdx.y
// picks the problem.  Writes f32 (out_f) and / or the output type (out_t).
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_ln_kernel(
    const float* __restrict__ pre, const float* g0, const float* b0, const float* g1,
    const float* b1, const T* __restrict__ pad, float* out_f, T* out_t, int R, int D,
    float eps) {
  const int z = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (DT_THREADS / 32) + warp;
  if (row >= R) return;
  const float* g = z ? g1 : g0;
  const float* b = z ? b1 : b0;
  const float* xr = pre + ((size_t)z * R + row) * D;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float v = xr[c];
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / D;
  const float rs = rsqrtf(sq / D - mu * mu + eps);
  const float p = to_f<T>(pad[row]);
  for (int c = lane; c < D; c += 32) {
    const float v = ((xr[c] - mu) * rs * g[c] + b[c]) * p;
    if (out_f != nullptr) out_f[((size_t)z * R + row) * D + c] = v;
    if (out_t != nullptr) out_t[((size_t)z * R + row) * D + c] = from_f<T>(v);
  }
}

// 5. both gates and the fused sum.  enc: f32 [2, R, D] and its compute-type
// copy enc_t; ws/we: [D, K = D] with leading dimension ldg (the two halves of
// one [D, 2D] Linear weight).  Warps 0-3 take the first gate's K (x Ws_1 then
// enc_1 We_1), warps 4-7 the second's.  Writes encf (f32) and, unless null,
// its compute-type copy encf_t.
template <typename T, int NF, int KS>
__global__ void __launch_bounds__(PR_THREADS) dt_gate_kernel(
    const T* __restrict__ x, const float* __restrict__ enc, const T* __restrict__ enc_t,
    const T* wsa, const T* wea, const T* ba, const T* wsb, const T* web, const T* bb,
    const T* __restrict__ pad, float* __restrict__ encf, T* __restrict__ encf_t, int R, int D,
    int ldg, int per, int mf) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the cluster's KS * PR_WARPS virtual warps: the first half the first gate's K
  const int rank = blockIdx.x % KS, col0 = blockIdx.x / KS * 8 * NF;
  const int v = rank * PR_WARPS + (threadIdx.x >> 5), wpz = KS * PR_WARPS / 2, z = v / wpz;
  const RowTile t(R, per);
  const Seg sx{x, D, z ? wsb : wsa, ldg, D};
  const Seg se{enc_t + (size_t)z * R * D, D, z ? web : wea, ldg, D};
  product<T, NF>(sx, se, v % wpz, wpz, t.row0, t.nrows, mf, col0, smem);
  const Partials<NF, KS> parts(smem);
  for (int idx = rank * PR_THREADS + threadIdx.x; idx < t.nrows * 8 * NF;
       idx += KS * PR_THREADS) {
    const int r = idx / (8 * NF), c = idx % (8 * NF), row = t.row0 + r, col = col0 + c;
    const float s1 = parts.sum(mf, wpz, 0, idx), s2 = parts.sum(mf, wpz, 1, idx);
    const float a1 = 1.0f / (1.0f + expf(-(s1 + to_f<T>(ba[col]))));
    const float a2 = 1.0f / (1.0f + expf(-(s2 + to_f<T>(bb[col]))));
    const float e1 = enc[(size_t)row * D + col], e2 = enc[((size_t)R + row) * D + col];
    const float e = (e1 * a1 + e2 * a2) * 0.70710678118654752440f * to_f<T>(pad[row]);
    encf[(size_t)row * D + col] = e;
    if (encf_t != nullptr) encf_t[(size_t)row * D + col] = from_f<T>(e);
  }
  parts.done();
}

// 6. h = relu(enc W1 + b1), rounded to the compute type.
template <typename T, int NF>
__global__ void __launch_bounds__(PR_THREADS) dt_fc1_kernel(
    const T* __restrict__ enc_t, const T* w1, const T* b1, T* __restrict__ hbuf, int R, int D,
    int F, int per, int mf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int col0 = blockIdx.x * 8 * NF;
  const RowTile t(R, per);
  product<T, NF>(Seg{enc_t, D, w1, D, D}, Seg{nullptr, 0, nullptr, 0, 0}, threadIdx.x >> 5,
                 PR_WARPS, t.row0, t.nrows, mf, col0, smem);
  const Partials<NF, 1> parts(smem);
  for (int idx = threadIdx.x; idx < t.nrows * 8 * NF; idx += PR_THREADS) {
    const int r = idx / (8 * NF), c = idx % (8 * NF), row = t.row0 + r, col = col0 + c;
    hbuf[(size_t)row * F + col] =
        from_f<T>(fmaxf(parts.sum(mf, PR_WARPS, 0, idx) + to_f<T>(b1[col]), 0.0f));
  }
}

// 7. pre = enc + h W2 + b2 (f32); with `partial`, pre = h W2 alone (7').
template <typename T, int NF, int KS>
__global__ void __launch_bounds__(PR_THREADS) dt_fc2_kernel(
    const T* __restrict__ hbuf, const float* __restrict__ encf, const T* w2, const T* b2,
    float* __restrict__ pre, int R, int D, int F, int per, int mf, int partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % KS, col0 = blockIdx.x / KS * 8 * NF;
  const RowTile t(R, per);
  product<T, NF>(Seg{hbuf, F, w2, F, F}, Seg{nullptr, 0, nullptr, 0, 0},
                 rank * PR_WARPS + (threadIdx.x >> 5), KS * PR_WARPS, t.row0, t.nrows, mf, col0,
                 smem);
  const Partials<NF, KS> parts(smem);
  for (int idx = rank * PR_THREADS + threadIdx.x; idx < t.nrows * 8 * NF;
       idx += KS * PR_THREADS) {
    const int r = idx / (8 * NF), c = idx % (8 * NF), row = t.row0 + r, col = col0 + c;
    const float s = parts.sum(mf, KS * PR_WARPS, 0, idx);
    pre[(size_t)row * D + col] =
        partial ? s : encf[(size_t)row * D + col] + (s + to_f<T>(b2[col]));
  }
  parts.done();
}

// 9. the tensor-parallel finish: out = LN_f(enc + (part + b2)) * pad, one warp
// a row, the sum in launch 7's order and the LayerNorm as launch 8's.
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_finish_kernel(
    const float* __restrict__ part, const float* __restrict__ enc, const T* __restrict__ b2,
    const float* __restrict__ g, const float* __restrict__ b, const T* __restrict__ pad,
    T* __restrict__ out, int R, int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (DT_THREADS / 32) + warp;
  if (row >= R) return;
  const float* pr = part + (size_t)row * D;
  const float* er = enc + (size_t)row * D;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float v = er[c] + (pr[c] + to_f<T>(b2[c]));
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / D;
  const float rs = rsqrtf(sq / D - mu * mu + eps);
  const float p = to_f<T>(pad[row]);
  for (int c = lane; c < D; c += 32) {
    const float v = er[c] + (pr[c] + to_f<T>(b2[c]));
    out[(size_t)row * D + c] = from_f<T>(((v - mu) * rs * g[c] + b[c]) * p);
  }
}

// the largest dynamic shared memory for a kernel, asked for once
template <auto K> int opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      K, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(DT_SMEM_MAX));
  return static_cast<int>(err);
}

// a launch of PR_THREADS-thread blocks in clusters of ks along x
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t st, int ks,
                   A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(PR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// weights: the 24 pointers in grit_tpu/ops/decode_layer.py::_ref's order;
// the products' blocks take 8 * NF columns.  `partial`: launches 1-7 only,
// fc2's f32 sum without bias or residual into `out` (f32 [R, D])
template <typename T, int NF>
int decode_tail(const void* x_, const void* k1, const void* v1, const void* m1, const void* k2,
                const void* v2, const void* m2, const void* pad_, void* out,
                const void* const* w, float* sf, void* st_, int R, int B, int fold, int T1,
                int T2, int D, int F, int H, int ldg, float eps, int partial,
                cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KS = NF == 1 ? PR_SPLIT : 1;
  const T* x = static_cast<const T*>(x_);
  const T* pad = static_cast<const T*>(pad_);
  auto wt = [&](int i) { return static_cast<const T*>(w[i]); };
  auto wf = [&](int i) { return static_cast<const float*>(w[i]); };
  float* pre = sf;                         // [2, R, D]
  float* enc = sf + (size_t)2 * R * D;     // [2, R, D]
  float* encf = sf + (size_t)4 * R * D;    // [R, D]
  T* q = static_cast<T*>(st_);             // [R, 2D]
  T* o = q + (size_t)R * 2 * D;            // [R, 2D]
  T* hbuf = o + (size_t)R * 2 * D;         // [R, F]
  T* enc_t = hbuf + (size_t)R * F;         // [2, R, D] (bf16; fp32 reads enc)
  T* encf_t = enc_t + (size_t)2 * R * D;   // [R, D] (bf16; fp32 reads encf)
  const T* enc_a = kF32 ? reinterpret_cast<const T*>(enc) : enc_t;
  const T* encf_a = kF32 ? reinterpret_cast<const T*>(encf) : encf_t;
  // row tiles of up to 64 rows, as even as they can be, each 16 * mf rows padded
  const int rt = (R + PR_MAXM - 1) / PR_MAXM, per = (R + rt - 1) / rt, mf = (per + 15) / 16;
  const size_t pr_smem = (size_t)PR_WARPS * pr_warp_bytes(mf, NF);
  const int cw = 8 * NF;
  const int lr = (R + DT_THREADS / 32 - 1) / (DT_THREADS / 32);
  const int d = D / H, tmax = T1 > T2 ? T1 : T2;
  const size_t at_smem = attn_smem<T>(fold, d, tmax);
  if (at_smem > DT_SMEM_MAX || d % 8 || D % cw || F % cw || R != B * fold)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int err : {opt_in<dt_qproj_kernel<T, NF>>(), opt_in<dt_attn_kernel<T>>(),
                  opt_in<dt_oproj_kernel<T, NF>>(), opt_in<dt_gate_kernel<T, NF, KS>>(),
                  opt_in<dt_fc1_kernel<T, NF>>(), opt_in<dt_fc2_kernel<T, NF, KS>>()})
    if (err != 0) return err;

  dt_qproj_kernel<T, NF><<<dim3(D / cw, rt, 2), PR_THREADS, pr_smem, stream>>>(
      x, wt(0), wt(1), wt(6), wt(7), q, R, D, per, mf, 1.0f / sqrtf((float)d));
  dt_attn_kernel<T><<<dim3(B, 2, H), AT_THREADS, at_smem, stream>>>(
      q, static_cast<const T*>(k1), static_cast<const T*>(v1),
      static_cast<const unsigned char*>(m1), static_cast<const T*>(k2),
      static_cast<const T*>(v2), static_cast<const unsigned char*>(m2), o, fold, T1, T2, D, H);
  dt_oproj_kernel<T, NF><<<dim3(D / cw, rt, 2), PR_THREADS, pr_smem, stream>>>(
      o, x, wt(2), wt(3), wt(8), wt(9), pre, R, D, per, mf);
  dt_ln_kernel<T><<<dim3(lr, 2), DT_THREADS, 0, stream>>>(
      pre, wf(4), wf(5), wf(10), wf(11), pad, enc, kF32 ? nullptr : enc_t, R, D, eps);
  int err = launch_cluster(dt_gate_kernel<T, NF, KS>, dim3(D / cw * KS, rt), pr_smem, stream, KS,
                           x, static_cast<const float*>(enc), enc_a, wt(12), wt(13), wt(14),
                           wt(15), wt(16), wt(17), pad, encf, kF32 ? nullptr : encf_t, R, D, ldg,
                           per, mf);
  if (err != 0) return err;
  dt_fc1_kernel<T, NF><<<dim3(F / cw, rt), PR_THREADS, pr_smem, stream>>>(
      encf_a, wt(18), wt(19), hbuf, R, D, F, per, mf);
  err = launch_cluster(dt_fc2_kernel<T, NF, KS>, dim3(D / cw * KS, rt), pr_smem, stream, KS,
                       static_cast<const T*>(hbuf), static_cast<const float*>(encf), wt(20),
                       wt(21), partial ? static_cast<float*>(out) : pre, R, D, F, per, mf,
                       partial);
  if (err != 0) return err;
  if (partial) return static_cast<int>(cudaGetLastError());
  dt_ln_kernel<T><<<dim3(lr, 1), DT_THREADS, 0, stream>>>(
      pre, wf(22), wf(23), wf(22), wf(23), pad, nullptr, static_cast<T*>(out), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace grit

// x [R, D], k_i / v_i [B, T_i, D], m_i uint8 [B, T_i] (non-zero = masked) or
// null, pad [R], out [R, D]; w: host array of the 24 weight pointers (matrices
// as [N, K] rows: q, o and FFN matrices with leading dimension K, the four gate
// matrices with ldg); sf: f32 scratch [5, R, D]; st: scratch of the compute
// type [R, 7D + F].  D and F are multiples of 64, D / H of 8, R = B * fold,
// and the attention launch's shared memory (attn_smem) at most 227 KB.
// partial != 0: F is this rank's slice of d_ff (fc1 / fc2 its columns / rows),
// out is f32 [R, D] and receives fc2's sum alone; the gated enc, the residual,
// is left in sf[4R D, 5R D); the final LayerNorm is not launched.
extern "C" int grit_decode_tail(const void* x, const void* k1, const void* v1, const void* m1,
                                const void* k2, const void* v2, const void* m2,
                                const void* pad, void* out, const void* const* w, void* sf,
                                void* st, int R, int B, int fold, int T1, int T2, int D, int F,
                                int H, int ldg, float eps, int dtype, int partial,
                                void* stream) {
  using namespace grit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(sf);
  auto run = [&](auto tail) {
    return tail(x, k1, v1, m1, k2, v2, m2, pad, out, w, f, st, R, B, fold, T1, T2, D, F, H, ldg,
                eps, partial, s);
  };
  const bool wide = R > PR_WIDE_ROWS;
  if (dtype == 0)
    return wide ? run(decode_tail<float, PR_WIDE_NF>) : run(decode_tail<float, 1>);
  return wide ? run(decode_tail<bf16, PR_WIDE_NF>) : run(decode_tail<bf16, 1>);
}

// The tensor-parallel finish (launch 9): part, enc f32 [R, D] (part the sum
// over the ranks of the partial mode's out, enc its sf[4R D, 5R D)), b2 [D] of
// the compute type, g / b f32 [D] (LN_f), pad [R], out [R, D].
extern "C" int grit_decode_tail_finish(const void* part, const void* enc, const void* b2,
                                       const void* g, const void* b, const void* pad, void* out,
                                       int R, int D, float eps, int dtype, void* stream) {
  using namespace grit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + DT_THREADS / 32 - 1) / (DT_THREADS / 32);
  auto run = [&](auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    dt_finish_kernel<T><<<blocks, DT_THREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<const float*>(enc),
        static_cast<const T*>(b2), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const T*>(pad), static_cast<T*>(out), R, D, eps);
    return static_cast<int>(cudaGetLastError());
  };
  return dtype == 0 ? run(static_cast<float*>(nullptr)) : run(static_cast<bf16*>(nullptr));
}
