// Swin block kernels: K1 (attention half-block), K2 (MLP half-block), K4 (the
// training block's attention branch) and K5 (window-attention backward).
//
// Replaces the TPU's grit_tpu/ops/window_attention.py::_band_kernel (K1,
// reached through fused_block_step / fused_block_mlp_step) and ::_mlp_kernel
// (K2, through fused_mlp).  _step_kernel (GRIT_WA_BAND=0) computes K1's
// function too and maps onto the same launches.
//
// K1 is four launches on the padded stage map x [B, Hp, Wp, C]:
//   1. ln_rows (window mode): masked LN1 (f32 stats, var = E[x^2] - mu^2),
//      gathering tokens in window-partitioned order with the cyclic shift and
//      the window padding folded into the load address; pad tokens are zero
//      before the statistics and after the affine.
//   2. gemm (EPI_BIAS): qkv = xn W^T + b, q columns scaled by d^-1/2.
//   3. the attention core (bf16: window_attn_mma.cu, a window and two heads
//      a block on mma.sync tiles; fp32: win_attn_f32.cu, one (window, head)
//      a block on SIMT register micro-tiles): an exact f32 row max and
//      softmax per query row, with
//      the relative-position bias read from its [(2w-1)^2, heads] table and
//      the shifted-window region derived from token coordinates (neither
//      [nW, h, N, N] tensor is ever materialised).
//   4. gemm (EPI_RESID_MAP): proj + bias + the pad-masked residual, stored
//      through the window-reverse + unshift address.
// K2 is three launches on rows [R, C]: ln_rows (row mode), gemm (EPI_GELU,
// exact-erf GELU; the TPU's rational/A&S approximations existed only because
// Mosaic has no erf), gemm (EPI_RESID).  fused_block_mlp_step is K1 then K2.
// K2's backward is torch's products around two memory passes of this file,
// gelu_bwd_kernel and ln_rows_bwd_kernel (design notes there).
//
// K4 replaces ::_block_kernel (through fused_block_attention, forward with
// save_attn): on the LayerNorm'd, zero-padded map it is K1's launches 2-4
// without LN, pad masking or residual.  The qkv GEMM gathers its A rows from
// the map in window order (a_gather), the attention core's output IS the
// pre-projection attention output that the backward wants, and the proj GEMM
// stores through the window-reverse + unshift address (EPI_MAP).
//
// K5 replaces ::_bwd_kernel (through _backward): in bf16 on
// win_attn_bwd_mma.cu (mma.sync tiles), in fp32 on win_attn_f32.cu (SIMT
// register micro-tiles), both with the batch split over blocks and the bias
// gradient summed without atomics into per-chunk slices.
//
// K8 replaces ::_kernel and, for its gradient, ::_bwd_kernel on a dense bias
// (through fused_window_attention): the same two attention kernels, given q, k
// and v as three [rows, C] tensors (q unscaled: the load scales and rounds
// it), and the additive bias as a dense f32 [1 or nW, heads, N, N] tensor read
// row by row in place of the table and the shift regions.
//
// K10a replaces ::_lnlin_kernel (through fused_ln_linear; PatchMerging's norm
// -> reduction): ln_merge gathers the 2x2 neighbourhood of each output token
// from the stage map, zero beyond an odd edge, and normalises the 4C values
// (f32 statistics, var = E[x^2] - mu^2) into the storage type; then the
// GEMM without a bias.  On already merged rows the first launch is ln_rows.
// The TPU kernel keeps the whole weight in VMEM and walks row blocks; here the
// product's column tiles spread over the SMs and the weight comes through L2.
// K10b replaces ::_ln_kernel (through fused_layernorm; the patch-embed norm):
// ln_rows in row mode.  Both LayerNorm kernels are memory passes: a row read
// once into registers in 16-byte chunks, its lanes sized to its width (see
// ln_rows_kernel).
//
// What bounds them on an H100: the GEMMs are tensor-core work and the
// attention core a memory pass; in bf16 both run on kernels designed for
// Hopper, in their own files: the GEMM on TMA + an mbarrier ring + wgmma
// (gemm_sm90.cu), the attention core on mma.sync tiles with the softmax in
// registers (window_attn_mma.cu).  In fp32 (no TF32: the parity runs compare
// with the plain path in full f32) both are bound by operations at 67
// TFLOP/s, the card's f32 rate outside the tensor cores: the attention core
// runs on SIMT register micro-tiles in its own file (win_attn_f32.cu), the
// GEMM on the SIMT tile below.  The GEMM is built to reach that rate (see
// gemm_f32_kernel): 8 x 8 outputs a thread for four 16-byte shared-memory
// reads a k, and the next k step's global loads in flight during this one's
// FMAs.  LN is a memory pass.  Every intermediate (xn, qkv, the
// attention output, the 4C-wide MLP hidden) goes to device memory and back;
// keeping them on chip, as the TPU kernels keep them in VMEM, is later work.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace grit {

__device__ __forceinline__ size_t a_row(const Epi& e, int row) {
  bool pad;
  return e.a_gather ? win_row_to_token(e.map, row, &pad) : (size_t)row;
}

// the fp32 GEMM's epilogue on four neighbouring columns col.. of one row
// (the map modes remap only the row): v = epilogue(acc) per column, one
// 16-byte store
__device__ __forceinline__ void epi_store4(const Epi& e, int row, int col, int N, float (&v)[4]) {
  if (e.bias) {
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(e.bias) + col);
    v[0] = v[0] + b.x;
    v[1] = v[1] + b.y;
    v[2] = v[2] + b.z;
    v[3] = v[3] + b.w;
  }
  size_t orow = (size_t)row;
  bool pad = false;
  if (e.mode == EPI_RESID_MAP || e.mode == EPI_MAP) orow = win_row_to_token(e.map, row, &pad);
  if (e.mode == EPI_BIAS) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < e.scale_cols) v[j] *= e.scale;
  } else if (e.mode == EPI_GELU) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 0.5f * v[j] * (1.0f + erff(v[j] * 0.7071067811865476f));
  } else if (e.mode == EPI_RESID || (e.mode == EPI_RESID_MAP && !pad)) {
    const float4 r = *reinterpret_cast<const float4*>(static_cast<const float*>(e.resid) +
                                                      orow * N + col);
    v[0] += r.x;
    v[1] += r.y;
    v[2] += r.z;
    v[3] += r.w;
  }
  *reinterpret_cast<float4*>(static_cast<float*>(e.out) + orow * N + col) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// LayerNorm over rows (ln_rows_kernel: K10b, the norms of K1 and K2, K10a's
// on merged rows) and over PatchMerging's 4C rows gathered from the map
// (ln_merge_kernel: K10a).  f32 statistics, var = E[x^2] - mu^2, one rounding
// to the storage type.  Both are memory passes: what bounds them is each
// input byte read once and each output byte written once.  A row is read
// once from device memory into registers in 16-byte chunks (8 bf16 or 4 f32
// values), normalised from the registers and stored in 16-byte chunks; g and
// b come as float4s.  A row takes G lanes, K chunks each: chunk j in lane
// j % G, slot j / G, so that each load instruction of a lane group reads G
// neighbouring chunks.  G is the fewest lanes that hold the row at most
// LN_CHUNKS_ROWS chunks a lane where rows are read in place, and
// LN_CHUNKS_GATHER where a warp first works out where its rows come from
// (window mode's win_row_to_token, PatchMerging's 2x2 gather): integer work
// that a warp pays once for all the chunks it holds.  G is a power of two
// up to a warp (a warp holds 32 / G rows) and whole warps past it, at most
// LN_MAX_LANES: a longer row gives each lane more chunks (up to LN_MAX_K).
// These were the fastest choices at the caption and detector shapes
// (kernel_variants.py); they serve every width of the presets (C 64 ..
// 1536, 4C up to 6144), and the instance is chosen at launch by K.  The
// statistics are summed in the first design's order (one warp a row, lane l
// taking every 32nd element; ln_stats) from a copy of the block's rows in
// shared memory, so the outputs are the same bits as that design's: the
// redesign changes no result downstream.  A block holds LN_THREADS / G rows
// (one row of more lanes), and no lane walks rows: every load of the grid is
// issued as soon as its block is resident.
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 128;      // a block's threads (a row of more lanes: its lanes)
constexpr int LN_MAX_LANES = 256;    // lanes a row takes at most
constexpr int LN_CHUNKS_ROWS = 2;    // 16-byte chunks a lane holds at most, rows read in
constexpr int LN_CHUNKS_GATHER = 4;  // place / gathered, in a row of up to LN_MAX_LANES lanes
constexpr int LN_MAX_K = 6;          // ... and in a longer one (fp32 4C = 6144: 6 a lane)
constexpr int LN_BLOCK = LN_MAX_LANES > LN_THREADS ? LN_MAX_LANES : LN_THREADS;

// a 16-byte chunk of the storage type as V floats, and V floats rounded back
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void to_f(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 from_f(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Chunk<bf16> {
  static constexpr int V = 8;
  __device__ static void to_f(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static uint4 from_f(const float* v) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// A staged row's statistics in the first design's order, so that the
// outputs are that design's bits: lane l of a warp adds elements l, l + 32,
// ... of each of the row's `quarters` blocks of C in turn, then warp_sum.
// Called by a whole warp.
template <typename T>
__device__ __forceinline__ float2 ln_warp_sums(const T* x, int C, int quarters, int l) {
  float s = 0.0f, s2 = 0.0f;
  for (int q = 0; q < quarters; ++q) {
#pragma unroll 8
    for (int c = l; c < C; c += 32) {
      const float v = to_f<T>(x[q * C + c]);
      s += v;
      s2 += v * v;
    }
  }
  return make_float2(warp_sum(s), warp_sum(s2));
}

// A row's K chunks a lane (zero where nothing was read) -> its mean and
// rsqrt(var + eps) in every lane of its group.  The block's rows are staged
// in shared memory, G * K chunks apart; a warp of up to 32 lanes a row sums
// each of its 32 / G rows in turn (ln_warp_sums), the first warp of a longer
// row sums it and hands the sums on through shared memory.  `need`: the row
// is normalised (not padding, not past the last row), else it is not summed;
// every thread of the block takes part.
template <typename T, int K>
__device__ __forceinline__ float2 ln_stats(const uint4 (&raw)[K], bool need, int lane, int G,
                                           int n, int C, int quarters, float eps) {
  extern __shared__ uint4 ln_staged[];
  __shared__ float2 red[LN_BLOCK / 32];
  const int slot = threadIdx.x / G;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + k * G < n) ln_staged[slot * G * K + lane + k * G] = raw[k];
  const T* rows = reinterpret_cast<const T*>(ln_staged);
  const int stride = G * K * Chunk<T>::V;
  float2 sums = make_float2(0.0f, 0.0f);
  if (G <= 32) {
    const unsigned needs = __ballot_sync(0xffffffffu, need);
    const int first = (threadIdx.x & ~31) / G;
    __syncwarp();
    for (int i = 0; i < 32 / G; ++i) {
      if ((needs >> (i * G)) & (0xffffffffu >> (32 - G))) {
        const float2 t = ln_warp_sums(rows + (first + i) * stride, C, quarters, threadIdx.x & 31);
        if (slot == first + i) sums = t;
      }
    }
  } else {
    __syncthreads();
    if (lane < 32 && need) {
      const float2 t = ln_warp_sums(rows + slot * stride, C, quarters, lane);
      if (lane == 0) red[slot] = t;
    }
    __syncthreads();
    sums = red[slot];
  }
  const int width = quarters * C;
  const float mu = sums.x / width;
  return make_float2(mu, rsqrtf(sums.y / width - mu * mu + eps));
}

// The row's n chunks normalised (st: mean, rsqrt) from the K chunks each lane
// holds and stored at o; a window-padding row (zero_row) is stored as zeros.
template <typename T, int K>
__device__ __forceinline__ void ln_store(const uint4 (&raw)[K], float2 st, int lane, int G, int n,
                                         bool zero_row, const float* __restrict__ g,
                                         const float* __restrict__ b, T* __restrict__ o) {
  constexpr int V = Chunk<T>::V;
  const float mu = st.x, rs = st.y;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    if (j >= n) break;
    float v[V];
    Chunk<T>::to_f(raw[k], v);
    if (zero_row) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.0f;
    } else {
      const float4* g4 = reinterpret_cast<const float4*>(g + j * V);
      const float4* b4 = reinterpret_cast<const float4*>(b + j * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 gq = __ldg(g4 + q), bq = __ldg(b4 + q);
        v[4 * q] = (v[4 * q] - mu) * rs * gq.x + bq.x;
        v[4 * q + 1] = (v[4 * q + 1] - mu) * rs * gq.y + bq.y;
        v[4 * q + 2] = (v[4 * q + 2] - mu) * rs * gq.z + bq.z;
        v[4 * q + 3] = (v[4 * q + 3] - mu) * rs * gq.w + bq.w;
      }
    }
    *reinterpret_cast<uint4*>(o + (size_t)j * V) = Chunk<T>::from_f(v);
  }
}

// Row r of x [rows, C], or in window mode the map token win_row_to_token(r)
// (a pad token: a zero row, not read).
template <typename T, int K>
__global__ void __launch_bounds__(LN_BLOCK, 1024 / LN_BLOCK) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ out, int rows, int C, int G, int window_mode, WinMap m, float eps) {
  constexpr int V = Chunk<T>::V;
  const int n = C / V, lane = threadIdx.x % G;
  const int r = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = r < rows;
  bool pad = false;
  size_t src = 0;
  if (live) src = window_mode ? win_row_to_token(m, r, &pad) : (size_t)r;
  const uint4* xr = reinterpret_cast<const uint4*>(x + src * C);
  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    raw[k] = live && !pad && j < n ? __ldg(xr + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  const float2 st = ln_stats<T, K>(raw, live && !pad, lane, G, n, C, 1, eps);
  if (live) ln_store<T, K>(raw, st, lane, G, n, pad, g, b, out + (size_t)r * C);
}

// K10a's first launch: row (b, y2, x2) of the output [B ceil(H/2) ceil(W/2),
// 4C] is the concatenation of the map x [B, H, W, C]'s tokens (2y2, 2x2),
// (2y2+1, 2x2), (2y2, 2x2+1), (2y2+1, 2x2+1), zeros where an odd H or W ends
// the map (they count in the statistics, as the zero pad before the norm
// does); g, b: f32 [4C].
template <typename T, int K>
__global__ void __launch_bounds__(LN_BLOCK, 1024 / LN_BLOCK) ln_merge_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ out, int rows, int H, int W, int C, int G, float eps) {
  constexpr int V = Chunk<T>::V;
  const int nq = C / V, n = 4 * nq, lane = threadIdx.x % G;
  const int r = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = r < rows;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int bi = r / (H2 * W2), rem = r - bi * (H2 * W2);
  const int y2 = rem / W2, x2 = rem - y2 * W2;
  const bool y_in = 2 * y2 + 1 < H, x_in = 2 * x2 + 1 < W;  // the second row / column exists
  const T* base = x + (((size_t)bi * H + 2 * y2) * W + 2 * x2) * C;
  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G, q = j / nq;  // quarter q: token (2y2 + (q & 1), 2x2 + (q >> 1))
    const bool in = live && j < n && (y_in || !(q & 1)) && (x_in || !(q & 2));
    const uint4* src =
        reinterpret_cast<const uint4*>(base + ((size_t)(q & 1) * W + (q >> 1)) * C) + (j - q * nq);
    raw[k] = in ? __ldg(src) : make_uint4(0u, 0u, 0u, 0u);
  }
  const float2 st = ln_stats<T, K>(raw, live, lane, G, n, C, 4, eps);
  if (live) ln_store<T, K>(raw, st, lane, G, n, false, g, b, out + (size_t)r * 4 * C);
}

// lanes a row of n 16-byte chunks takes: the fewest that hold it at most
// `most` a lane, a power of two up to a warp and whole warps past it, at
// most LN_MAX_LANES
inline int ln_lanes(int n, int most) {
  const int need = (n + most - 1) / most;
  if (need > 32) return std::min(32 * ((need + 31) / 32), LN_MAX_LANES);
  int g = 1;
  while (g < need) g *= 2;
  return g;
}

// dynamic shared memory of a block: its rows staged, K chunks a thread
inline size_t ln_smem_bytes(int G, int per_block, int K) {
  return (size_t)G * per_block * K * sizeof(uint4);
}

// launch(std::integral_constant<int, k>) for the instance of k chunks a lane
template <int K = 1, class F>
int ln_dispatch(int k, F&& launch) {
  if (k == K) return launch(std::integral_constant<int, K>{});
  if constexpr (K < LN_MAX_K) return ln_dispatch<K + 1>(k, launch);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// out = epilogue(A W^T): A [M, K] row-major, W [N, K] (torch Linear layout).
// fp32 (the parity path; bf16: gemm_sm90.cu): SIMT FMA, no TF32, bound by
// operations at 67 TFLOP/s.  A 128 x BN block tile (BN = 128, or 64 where the
// product has too few 128-wide tiles to fill the SMs) over 16-deep k steps,
// 256 threads, two blocks an SM.  Each thread holds 8 x (BN / 16) outputs as
// 4 x 4 sub-tiles 64 rows and 64 columns apart, so that every operand read
// from shared memory is a float4; a warp's threads read 4 neighbouring A and
// 8 neighbouring W float4s (one bank wavefront each) for 64 FMAs a thread.
// A and W tiles are stored k-major, transposed on the store (rows padded to
// 132 floats), in two buffers: the next k step's 16-byte global loads are
// issued before this step's FMAs and stored after them, one barrier a step.
// K4's window gather keeps the source rows a thread loads, computed once.
// Each output is one fmaf chain over k = 0 .. K-1 in order from 0, as in the
// 64 x 64 tile this replaces, so fp32 results are bit-identical to it; no
// split-K.  The epilogue stores 4 neighbouring columns at once.  Tried and
// slower at the detector step's shapes (kernel_variants.py): 8-deep k steps,
// 8 x 16 outputs a thread, one block an SM, 4-byte cp.async copies into the
// transposed tiles with 2-4 steps in flight, 256 x 128 tiles.
// ---------------------------------------------------------------------------
constexpr int GF_BM = 128, GF_BK = 16, GF_LDA = GF_BM + 4;

// BN: the tile's columns, 128 or 64; a thread holds TQ = BN / 64 groups of 4
// columns 64 apart (256 threads: a warp is 4 rows of threads by 8 columns)
template <int BN>
__global__ void __launch_bounds__(256, 2) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K, Epi e) {
  constexpr int NT = 256, TQ = BN / 64, CS = 64, WX = 2, LDW = BN + 4, BK = GF_BK, RQ = BK / 4;
  constexpr int LA = GF_BM * RQ / NT, LW = (BN * RQ + NT - 1) / NT;  // float4 loads a thread
  __shared__ __align__(16) float As[2][BK][GF_LDA];
  __shared__ __align__(16) float Ws[2][BK][LDW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / WX) * 4 + (lane >> 3), tx = (warp % WX) * 8 + (lane & 7);
  const int m0 = blockIdx.x * GF_BM, n0 = blockIdx.y * BN;
  // load l = tid + NT it: row l / RQ, k (l % RQ) * 4 .. + 3 of the tile
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* ap[LA];
  const float* wp[LW];
  bool a_ok[LA], w_ok[LW];
#pragma unroll
  for (int it = 0; it < LA; ++it) {
    const int l = tid + NT * it, r = m0 + l / RQ;
    a_ok[it] = r < M;
    ap[it] = A + (a_ok[it] ? a_row(e, r) : 0) * K + (l % RQ) * 4;
  }
#pragma unroll
  for (int it = 0; it < LW; ++it) {
    const int l = tid + NT * it, r = n0 + l / RQ;
    w_ok[it] = l < BN * RQ && r < N;
    wp[it] = W + (w_ok[it] ? (size_t)r : 0) * K + (l % RQ) * 4;
  }

  float acc[8][4 * TQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * TQ; ++j) acc[i][j] = 0.0f;

  float4 ra[LA], rw[LW];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < LA; ++it)
      ra[it] = a_ok[it] ? *reinterpret_cast<const float4*>(ap[it] + k0) : zero;
#pragma unroll
    for (int it = 0; it < LW; ++it)
      rw[it] = w_ok[it] ? *reinterpret_cast<const float4*>(wp[it] + k0) : zero;
  };
  // the fetched float4s, stored transposed (k-major) into buffer buf
  auto stage = [&](int buf) {
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int l = tid + NT * it, r = l / RQ, k = (l % RQ) * 4;
      As[buf][k][r] = ra[it].x;
      As[buf][k + 1][r] = ra[it].y;
      As[buf][k + 2][r] = ra[it].z;
      As[buf][k + 3][r] = ra[it].w;
    }
#pragma unroll
    for (int it = 0; it < LW; ++it) {
      const int l = tid + NT * it, r = l / RQ, k = (l % RQ) * 4;
      if (l < BN * RQ) {
        Ws[buf][k][r] = rw[it].x;
        Ws[buf][k + 1][r] = rw[it].y;
        Ws[buf][k + 2][r] = rw[it].z;
        Ws[buf][k + 3][r] = rw[it].w;
      }
    }
  };
  fetch(0);
  stage(0);
  __syncthreads();
  const int kt_n = K / BK;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < kt_n) fetch((kt + 1) * BK);  // in flight during this step's FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(&Ws[cur][kk][q * CS + tx * 4]);
        b[4 * q] = bv.x, b[4 * q + 1] = bv.y, b[4 * q + 2] = bv.z, b[4 * q + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * TQ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) stage(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const int col = n0 + q * CS + tx * 4;  // N % 4 == 0: the four columns are all in or out
      if (col >= N) continue;
      float v[4] = {acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]};
      epi_store4(e, row, col, N, v);
    }
  }
}

// the fp32 GEMM's launch: 128-wide tiles where they give two blocks for every SM
int launch_gemm_f32(const float* A, const float* W, int M, int N, int K, const Epi& e,
                    cudaStream_t st) {
  if (N % 4 || K % GF_BK) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int mt = (M + GF_BM - 1) / GF_BM;
  if ((long long)mt * ((N + 127) / 128) >= 2LL * sms) {
    gemm_f32_kernel<128><<<dim3(mt, (N + 127) / 128), 256, 0, st>>>(A, W, M, N, K, e);
  } else {
    gemm_f32_kernel<64><<<dim3(mt, (N + 63) / 64), 256, 0, st>>>(A, W, M, N, K, e);
  }
  return (int)cudaGetLastError();
}

// ln_rows_kernel over rows of C values (C % 8 in bf16, C % 4 in f32: whole
// 16-byte chunks; the rows 16-byte aligned)
template <typename T>
int launch_ln(const void* x, const void* g, const void* b, void* out, int rows, int C,
              int window_mode, WinMap m, float eps, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  if (C <= 0 || C % V) return (int)cudaErrorInvalidValue;
  const int n = C / V, G = ln_lanes(n, window_mode ? LN_CHUNKS_GATHER : LN_CHUNKS_ROWS);
  const int per_block = G < LN_THREADS ? LN_THREADS / G : 1;
  return ln_dispatch((n + G - 1) / G, [&](auto k) {
    constexpr int K = decltype(k)::value;
    ln_rows_kernel<T, K><<<(rows + per_block - 1) / per_block, G * per_block,
                           ln_smem_bytes(G, per_block, K), st>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(out), rows, C, G, window_mode, m, eps);
    return (int)cudaGetLastError();
  });
}

// the attention core in the storage type of `dtype` (1: bf16, on the tensor cores)
int launch_win_attn(int dtype, const void* q, const void* k, const void* v, size_t ld,
                    float qscale, const void* table, const void* dense, int dense_windows,
                    void* out, int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  if (dtype == 1)
    return launch_win_attn_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), ld, qscale,
                                static_cast<const float*>(table), static_cast<const float*>(dense),
                                dense_windows, static_cast<bf16*>(out), num_windows, C, heads, m,
                                st);
  return launch_win_attn_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), ld, qscale,
                             static_cast<const float*>(table), static_cast<const float*>(dense),
                             dense_windows, static_cast<float*>(out), num_windows, C, heads, m, st);
}

// ln_merge_kernel over the 4C rows of the map's 2x2 neighbourhoods (C as
// launch_ln's)
template <typename T>
int launch_ln_merge(const void* x, const void* g, const void* b, void* out, int rows, int H,
                    int W, int C, float eps, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  if (C <= 0 || C % V) return (int)cudaErrorInvalidValue;
  const int n = 4 * C / V, G = ln_lanes(n, LN_CHUNKS_GATHER);
  const int per_block = G < LN_THREADS ? LN_THREADS / G : 1;
  return ln_dispatch((n + G - 1) / G, [&](auto k) {
    constexpr int K = decltype(k)::value;
    ln_merge_kernel<T, K><<<(rows + per_block - 1) / per_block, G * per_block,
                            ln_smem_bytes(G, per_block, K), st>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(out), rows, H, W, C, G, eps);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// K2's backward (ops/window_attention.py::_mlp_backward).  The TPU's
// _mlp_bwd is jax.vjp of the plain recompute, which XLA fuses into a few
// passes; here the five products stay on torch's matmul and the element-wise
// work between them is two memory passes, each bound by its bytes:
//   gelu_bwd_kernel over the hidden rows [R, H]: reads the pre-activation u
//   and dg = dy fc2_w, writes g = gelu(u) over u and du = dg gelu'(u) over
//   dg (f32 arithmetic, each rounded once to the storage type), and its
//   block's f32 column sums of the rounded du (fc1's bias gradient).  Four
//   storage values an element, 16-byte accesses: a warp spans 32 chunks of a
//   row, a block's 8 warps walk 8 rows each.
//   ln_rows_bwd_kernel over the rows [R, C]: a row held in registers as
//   ln_rows_kernel holds it (G lanes, K 16-byte chunks a lane); recomputes
//   the row's mean and rsqrt(var + eps) with var = E[x^2] - mu^2, reads d_xn
//   (and dy where the residual was added), writes dx = rsqrt * (d_xn w -
//   mean(d_xn w) - xhat mean(d_xn w xhat)) (+ dy) rounded once, and its
//   block's f32 column sums of d_xn xhat and d_xn (the norm's scale and bias
//   gradients).  A lane group walks LNB_ROWS rows, so a block's partial row
//   covers LNB_ROWS row groups.  Every MLP width of the Swin presets (C 64
//   .. 1536) takes K <= 2 chunks a lane, without spills; the K >= 3
//   instances (past 4096 bf16 / 2048 fp32 values) spill registers.
// col_sums_kernel then sums the blocks' partial rows in a fixed order: no
// atomics, the same bits from call to call.
// ---------------------------------------------------------------------------
constexpr int GB_CHUNKS = 32;  // 16-byte chunks of a row a block spans (a warp's lanes)
constexpr int GB_WARPS = 8;    // a block's warps, each on its own rows
constexpr int GB_ROWS = 8;     // rows a warp walks, loaded all at once
constexpr int GB_TILE_ROWS = GB_WARPS * GB_ROWS;
constexpr int LNB_ROWS = 8;    // rows a lane group of ln_rows_bwd_kernel walks
constexpr int CS_COLS = 32, CS_SPLIT = 16;  // col_sums_kernel: columns x row ranges a block

template <typename T>
__global__ void __launch_bounds__(GB_CHUNKS * GB_WARPS) gelu_bwd_kernel(
    T* u, T* dg, float* __restrict__ part, int rows, int H) {
  constexpr int V = Chunk<T>::V;
  __shared__ float red[GB_WARPS][GB_CHUNKS * V];
  const int n = H / V, tx = threadIdx.x % GB_CHUNKS, ty = threadIdx.x / GB_CHUNKS;
  const int j = blockIdx.y * GB_CHUNKS + tx;
  const int r0 = blockIdx.x * GB_TILE_ROWS + ty;
  uint4* u4 = reinterpret_cast<uint4*>(u);
  uint4* d4 = reinterpret_cast<uint4*>(dg);
  uint4 ru[GB_ROWS], rd[GB_ROWS];
#pragma unroll
  for (int i = 0; i < GB_ROWS; ++i) {
    const int r = r0 + i * GB_WARPS;
    const bool live = j < n && r < rows;
    ru[i] = live ? u4[(size_t)r * n + j] : make_uint4(0u, 0u, 0u, 0u);
    rd[i] = live ? d4[(size_t)r * n + j] : make_uint4(0u, 0u, 0u, 0u);
  }
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int i = 0; i < GB_ROWS; ++i) {
    const int r = r0 + i * GB_WARPS;
    if (j >= n || r >= rows) continue;
    float uf[V], df[V], g[V], du[V];
    Chunk<T>::to_f(ru[i], uf);
    Chunk<T>::to_f(rd[i], df);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float e = erff(uf[v] * 0.7071067811865476f);
      g[v] = uf[v] * 0.5f * (1.0f + e);
      du[v] = df[v] * (0.5f * (1.0f + e) +
                       uf[v] * 0.3989422804014327f * expf(-0.5f * uf[v] * uf[v]));
    }
    const uint4 dq = Chunk<T>::from_f(du);
    u4[(size_t)r * n + j] = Chunk<T>::from_f(g);
    d4[(size_t)r * n + j] = dq;
    Chunk<T>::to_f(dq, du);  // the bias gradient sums du as stored
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += du[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) red[ty][tx * V + v] = acc[v];
  __syncthreads();
  const int c = blockIdx.y * GB_CHUNKS * V + threadIdx.x;
  if (threadIdx.x < GB_CHUNKS * V && c < H) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < GB_WARPS; ++w) s += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * H + c] = s;
  }
}

// (a, b) summed over the G lanes of a row: G a power of two up to a warp
// (xor shuffles: every lane ends with the same bits), or whole warps up to
// LN_MAX_LANES (through red).  Called by every thread of the block.
__device__ __forceinline__ float2 row_sum2(float2 v, int G, float2* red) {
  if (G <= 32) {
    for (int o = G / 2; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    return v;
  }
  v = make_float2(warp_sum(v.x), warp_sum(v.y));
  __syncthreads();  // the previous sum's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const int first = threadIdx.x / G * (G / 32);
  float2 s = make_float2(0.0f, 0.0f);
  for (int i = 0; i < G / 32; ++i) {
    s.x += red[first + i].x;
    s.y += red[first + i].y;
  }
  return s;
}

// Rows of block b: row group (b LNB_ROWS + i) of `slots` neighbouring rows
// at step i, one a lane group.  part [gridDim.x, 2C]: the block's sums of
// d_xn xhat (columns 0 .. C-1) and of d_xn (C .. 2C-1).  dy may be null.
template <typename T, int K>
__global__ void __launch_bounds__(LN_BLOCK, 2) ln_rows_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dxn,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int rows, int C,
    int G, float eps) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float lnb_sums[];  // [slots, 2C]
  __shared__ float2 red[LN_BLOCK / 32];
  const int n = C / V, lane = threadIdx.x % G, slot = threadIdx.x / G, slots = blockDim.x / G;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* g4 = reinterpret_cast<const uint4*>(dxn);
  const uint4* y4 = reinterpret_cast<const uint4*>(dy);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float wv[K][V], pw[K][V], pb[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      wv[k][v] = j < n ? __ldg(w + j * V + v) : 0.0f;
      pw[k][v] = pb[k][v] = 0.0f;
    }
  }
  for (int i = 0; i < LNB_ROWS; ++i) {
    const int r = (blockIdx.x * LNB_ROWS + i) * slots + slot;
    const bool live = r < rows;
    uint4 rx[K], rg[K], ry[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + k * G;
      const bool ok = live && j < n;
      const size_t at = (size_t)r * n + j;
      rx[k] = ok ? __ldg(x4 + at) : zero;
      rg[k] = ok ? __ldg(g4 + at) : zero;
      ry[k] = ok && dy ? __ldg(y4 + at) : zero;
    }
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xf[V];
      Chunk<T>::to_f(rx[k], xf);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s1 += xf[v];
        s2 += xf[v] * xf[v];
      }
    }
    const float2 st = row_sum2(make_float2(s1, s2), G, red);
    const float mu = st.x / C;
    const float rs = rsqrtf(st.y / C - mu * mu + eps);
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xf[V], gf[V];
      Chunk<T>::to_f(rx[k], xf);
      Chunk<T>::to_f(rg[k], gf);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (xf[v] - mu) * rs, gw = gf[v] * wv[k][v];
        a1 += gw;
        a2 += gw * xh;
        pw[k][v] += gf[v] * xh;
        pb[k][v] += gf[v];
      }
    }
    const float2 sa = row_sum2(make_float2(a1, a2), G, red);
    const float m1 = sa.x / C, m2 = sa.y / C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + k * G;
      if (!live || j >= n) continue;
      float xf[V], gf[V], yf[V];
      Chunk<T>::to_f(rx[k], xf);
      Chunk<T>::to_f(rg[k], gf);
      Chunk<T>::to_f(ry[k], yf);
#pragma unroll
      for (int v = 0; v < V; ++v)
        xf[v] = rs * (gf[v] * wv[k][v] - m1 - (xf[v] - mu) * rs * m2) + yf[v];
      reinterpret_cast<uint4*>(dx)[(size_t)r * n + j] = Chunk<T>::from_f(xf);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    if (j >= n) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lnb_sums[slot * 2 * C + j * V + v] = pw[k][v];
      lnb_sums[slot * 2 * C + C + j * V + v] = pb[k][v];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < slots; ++q) s += lnb_sums[q * 2 * C + c];
    part[(size_t)blockIdx.x * 2 * C + c] = s;
  }
}

// out[c] = the sum over p of part[p, c] (P partial rows of N columns), in a
// fixed order: CS_SPLIT ranges of rows, each summed in turn, then the ranges
// in turn; one rounding to TO
template <typename TO>
__global__ void __launch_bounds__(CS_COLS * CS_SPLIT) col_sums_kernel(
    const float* __restrict__ part, int P, int N, TO* __restrict__ out) {
  __shared__ float red[CS_SPLIT][CS_COLS];
  const int tx = threadIdx.x % CS_COLS, ty = threadIdx.x / CS_COLS;
  const int c = blockIdx.x * CS_COLS + tx;
  const int per = (P + CS_SPLIT - 1) / CS_SPLIT, p1 = min(P, (ty + 1) * per);
  float s = 0.0f;
  if (c < N) {
#pragma unroll 8
    for (int p = ty * per; p < p1; ++p) s += part[(size_t)p * N + c];
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < N) {
    float t = 0.0f;
#pragma unroll
    for (int q = 0; q < CS_SPLIT; ++q) t += red[q][tx];
    out[c] = from_f<TO>(t);
  }
}

template <typename TO>
int launch_col_sums(const float* part, int P, int N, void* out, cudaStream_t st) {
  col_sums_kernel<TO><<<(N + CS_COLS - 1) / CS_COLS, CS_COLS * CS_SPLIT, 0, st>>>(
      part, P, N, static_cast<TO*>(out));
  return (int)cudaGetLastError();
}

inline int gelu_bwd_blocks(int rows) { return (rows + GB_TILE_ROWS - 1) / GB_TILE_ROWS; }

template <typename T>
int launch_gelu_bwd(void* u, void* dg, float* part, void* db, int rows, int H, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  if (rows <= 0 || H <= 0 || H % V) return (int)cudaErrorInvalidValue;
  const int blocks = gelu_bwd_blocks(rows);
  gelu_bwd_kernel<T><<<dim3(blocks, (H / V + GB_CHUNKS - 1) / GB_CHUNKS), GB_CHUNKS * GB_WARPS,
                       0, st>>>(static_cast<T*>(u), static_cast<T*>(dg), part, rows, H);
  const int err = (int)cudaGetLastError();
  return err ? err : launch_col_sums<T>(part, blocks, H, db, st);
}

// ln_rows_bwd_kernel's lanes a row (launch_ln's rule for rows read in place)
// and the rows a block takes
inline int ln_bwd_lanes(int n) { return ln_lanes(n, LN_CHUNKS_ROWS); }
inline int ln_bwd_slots(int G) { return G < LN_THREADS ? LN_THREADS / G : 1; }

inline int ln_rows_bwd_blocks(int rows, int C, int V) {
  if (rows <= 0 || C <= 0 || C % V) return -1;
  const int slots = ln_bwd_slots(ln_bwd_lanes(C / V)), per = slots * LNB_ROWS;
  return (rows + per - 1) / per;
}

template <typename T>
int launch_ln_rows_bwd(const void* x, const void* w, const void* dxn, const void* dy, void* dx,
                       float* part, void* dwb, int rows, int C, float eps, cudaStream_t st) {
  constexpr int V = Chunk<T>::V;
  const int blocks = ln_rows_bwd_blocks(rows, C, V);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const int n = C / V, G = ln_bwd_lanes(n), slots = ln_bwd_slots(G);
  const size_t smem = (size_t)slots * 2 * C * sizeof(float);
  const int err = ln_dispatch((n + G - 1) / G, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ln_rows_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    ln_rows_bwd_kernel<T, K><<<blocks, G * slots, smem, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dxn),
        static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, C, G, eps);
    return (int)cudaGetLastError();
  });
  return err ? err : launch_col_sums<float>(part, blocks, 2 * C, dwb, st);
}

// the three column blocks of a packed [rows, 3C] tensor
template <typename T>
const void* col_block(const void* p, int C, int k) { return static_cast<const T*>(p) + k * C; }
template <typename T>
void* col_block(void* p, int C, int k) { return static_cast<T*>(p) + k * C; }

}  // namespace grit

using namespace grit;

extern "C" {

// x: [rows or map tokens, C]; g, b: f32 [C]; out: [rows, C].
int grit_ln_rows(const void* x, const void* g, const void* b, void* out, int rows, int C,
                 int window_mode, int Hp, int Wp, int win, int shift, int real_h, int real_w,
                 float eps, int dtype, void* stream) {
  WinMap m{Hp, Wp, win, shift, real_h, real_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_ln<bf16>(x, g, b, out, rows, C, window_mode, m, eps, st);
  return launch_ln<float>(x, g, b, out, rows, C, window_mode, m, eps, st);
}

// K10a's LayerNorm launch alone (the first half of grit_ln_linear with
// merge = 1), for timing it apart from the product: x [B, H, W, C], g, b f32
// [4C], out [B ceil(H/2) ceil(W/2), 4C].
int grit_ln_merge(const void* x, const void* g, const void* b, void* out, int rows, int H, int W,
                  int C, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_ln_merge<bf16>(x, g, b, out, rows, H, W, C, eps, st);
  return launch_ln_merge<float>(x, g, b, out, rows, H, W, C, eps, st);
}

// out = epilogue(A [M, K] @ W[N, K]^T); bias [N] in the storage type, as
// flax's Dense casts it.  bf16 needs N % 8 == 0 and K % 8 == 0 (gemm_sm90.cu),
// fp32 N % 4 == 0 and K % 16 == 0 (the Python wrappers check the same
// GEMM_TILES).  With a_gather, A is the map and row r of the product reads map
// token win_row_to_token(r).
int grit_gemm(const void* A, const void* W, const void* bias, void* out, const void* resid,
              int M, int N, int K, int mode, float scale, int scale_cols, int Hp, int Wp,
              int win, int shift, int real_h, int real_w, int a_gather, int dtype,
              void* stream) {
  Epi e{bias, out, resid, mode, scale, scale_cols,
        WinMap{Hp, Wp, win, shift, real_h, real_w}, a_gather};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_gemm_bf16(static_cast<const bf16*>(A), static_cast<const bf16*>(W), M, N, K, e,
                            st);
  return launch_gemm_f32(static_cast<const float*>(A), static_cast<const float*>(W), M, N, K, e,
                         st);
}

// qkv: [num_windows * win^2, 3C]; table f32 [(2win-1)^2, heads]; out [.., C].
int grit_window_attn(const void* qkv, const void* table, void* out, int num_windows, int C,
                     int heads, int Hp, int Wp, int win, int shift, int dtype, void* stream) {
  WinMap m{Hp, Wp, win, shift, Hp, Wp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ld = 3 * (size_t)C;
  if (dtype == 1)
    return launch_win_attn(dtype, qkv, col_block<bf16>(qkv, C, 1), col_block<bf16>(qkv, C, 2), ld,
                           1.0f, table, nullptr, 1, out, num_windows, C, heads, m, st);
  return launch_win_attn(dtype, qkv, col_block<float>(qkv, C, 1), col_block<float>(qkv, C, 2), ld,
                         1.0f, table, nullptr, 1, out, num_windows, C, heads, m, st);
}

// K5 (bf16: win_attn_bwd_mma.cu; fp32: win_attn_f32.cu): qkv, dqkv
// [batch * nW * win^2, 3C]; dout [.., C]; table f32 [(2win-1)^2, heads]; dbias
// f32 [chunks, nW, heads, win^2, win^2 rounded up to a multiple of 4], dS
// summed over each of `chunks` balanced chunks of the batch.
int grit_window_attn_bwd(const void* qkv, const void* dout, const void* table, void* dqkv,
                         void* dbias, int batch, int chunks, int C, int heads, float scale,
                         int Hp, int Wp, int win, int shift, int dtype, void* stream) {
  WinMap m{Hp, Wp, win, shift, Hp, Wp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ld = 3 * (size_t)C;
  if (dtype == 1) {
    const bf16* q = static_cast<const bf16*>(qkv);
    bf16* dq = static_cast<bf16*>(dqkv);
    return launch_win_attn_bwd_bf16(q, q + C, q + 2 * C, static_cast<const bf16*>(dout), ld, 1.0f,
                                    scale, static_cast<const float*>(table), nullptr, 1, dq,
                                    dq + C, dq + 2 * C, static_cast<float*>(dbias), batch, chunks,
                                    C, heads, m, st);
  }
  const float* q = static_cast<const float*>(qkv);
  float* dq = static_cast<float*>(dqkv);
  return launch_win_attn_bwd_f32(q, q + C, q + 2 * C, static_cast<const float*>(dout), ld, 1.0f,
                                 scale, static_cast<const float*>(table), nullptr, 1, dq, dq + C,
                                 dq + 2 * C, static_cast<float*>(dbias), batch, chunks, C, heads,
                                 m, st);
}

// K8 forward: q, k, v, out [batch * nW * win^2, C] (q unscaled); bias f32
// [bias_windows, heads, win^2, win^2] with bias_windows 1 or nW.
int grit_window_attn_dense(const void* q, const void* k, const void* v, const void* bias,
                           void* out, int batch, int nW, int win, int C, int heads,
                           int bias_windows, float scale, int dtype, void* stream) {
  WinMap m{win, win * nW, win, 0, win, win * nW};
  return launch_win_attn(dtype, q, k, v, (size_t)C, scale, nullptr, bias, bias_windows, out,
                         batch * nW, C, heads, m, static_cast<cudaStream_t>(stream));
}

// K8 backward: dq, dk, dv as q; dbias f32 [chunks, nW, heads, win^2, win^2], dS
// summed over each chunk of the batch (the sums over chunks, and over windows
// for a one-window bias, are the caller's).
int grit_window_attn_dense_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* bias, void* dq, void* dk, void* dv, void* dbias,
                               int batch, int chunks, int nW, int win, int C, int heads,
                               int bias_windows, float scale, int dtype, void* stream) {
  WinMap m{win, win * nW, win, 0, win, win * nW};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_win_attn_bwd_bf16(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), (size_t)C, scale, scale, nullptr,
        static_cast<const float*>(bias), bias_windows, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dbias), batch, chunks,
        C, heads, m, st);
  return launch_win_attn_bwd_f32(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), (size_t)C, scale, scale, nullptr,
      static_cast<const float*>(bias), bias_windows, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dbias), batch, chunks,
      C, heads, m, st);
}

// K2's backward passes (see gelu_bwd_kernel, ln_rows_bwd_kernel).  The
// *_blocks entries give the rows of the f32 scratch `part` that a call over
// `rows` rows fills (-1: a width the kernel does not take).
int grit_gelu_bwd_blocks(int rows) { return gelu_bwd_blocks(rows); }

// u, dg: [rows, H], in: the pre-activation and dL/dg; out: gelu(u) and
// dL/du.  part f32 [grit_gelu_bwd_blocks(rows), H]; db [H] in the storage
// type: the column sums of dL/du (H % 8 in bf16, H % 4 in fp32).
int grit_gelu_bwd(void* u, void* dg, void* part, void* db, int rows, int H, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 1) return launch_gelu_bwd<bf16>(u, dg, p, db, rows, H, st);
  return launch_gelu_bwd<float>(u, dg, p, db, rows, H, st);
}

int grit_ln_rows_bwd_blocks(int rows, int C, int dtype) {
  return ln_rows_bwd_blocks(rows, C, dtype == 1 ? Chunk<bf16>::V : Chunk<float>::V);
}

// x, dxn, dy (null: no residual), dx: [rows, C] (launch_ln's widths); w f32
// [C]; part f32 [grit_ln_rows_bwd_blocks(rows, C, dtype), 2C]; dwb f32 [2C]:
// the scale's gradient, then the bias's.
int grit_ln_rows_bwd(const void* x, const void* w, const void* dxn, const void* dy, void* dx,
                     void* part, void* dwb, int rows, int C, float eps, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return launch_ln_rows_bwd<bf16>(x, w, dxn, dy, dx, p, dwb, rows, C, eps, st);
  return launch_ln_rows_bwd<float>(x, w, dxn, dy, dx, p, dwb, rows, C, eps, st);
}

// K10a: out [rows, N] = LN(rows of x) W^T, W [N, K] in the storage type, g, b f32
// [K]; xn [rows, K] is scratch.  merge = 1: x is the map [B, H, W, K / 4] and
// row (b, y2, x2) its 2x2 neighbourhood (rows = B ceil(H/2) ceil(W/2)); merge = 0:
// x is [rows, K].  The GEMM's shape rules hold (grit_gemm).
int grit_ln_linear(const void* x, const void* g, const void* b, const void* w, void* xn,
                   void* out, int rows, int N, int K, int merge, int H, int W, float eps,
                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (merge) {
    err = dtype == 1 ? launch_ln_merge<bf16>(x, g, b, xn, rows, H, W, K / 4, eps, st)
                     : launch_ln_merge<float>(x, g, b, xn, rows, H, W, K / 4, eps, st);
  } else {
    WinMap none{1, 1, 1, 0, 1, 1};
    err = dtype == 1 ? launch_ln<bf16>(x, g, b, xn, rows, K, 0, none, eps, st)
                     : launch_ln<float>(x, g, b, xn, rows, K, 0, none, eps, st);
  }
  if (err != 0) return err;
  return grit_gemm(xn, w, nullptr, out, nullptr, rows, N, K, EPI_BIAS, 1.0f, 0, 1, 1, 1, 0, 1, 1,
                   0, dtype, stream);
}

}  // extern "C"
