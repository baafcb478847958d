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
// ln_rows in row mode, one pass, one warp a row.  Both are memory passes.
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
// LayerNorm over rows, one warp per row.  Window mode gathers row r from the
// map token win_row_to_token(r) and zeroes pad tokens; row mode reads row r.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ out, int rows, int C, int window_mode, WinMap m, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  bool pad = false;
  const size_t src = window_mode ? win_row_to_token(m, r, &pad) : (size_t)r;
  const T* xr = x + src * C;
  T* o = out + (size_t)r * C;
  if (pad) {
    for (int c = lane; c < C; c += 32) o[c] = from_f<T>(0.0f);
    return;
  }
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f<T>(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rs = rsqrtf(s2 / C - mu * mu + eps);
  for (int c = lane; c < C; c += 32) {
    o[c] = from_f<T>((to_f<T>(xr[c]) - mu) * rs * g[c] + b[c]);
  }
}

// ---------------------------------------------------------------------------
// K10a's first launch: LayerNorm over the 4C channels of PatchMerging's rows,
// gathered from the map x [B, H, W, C].  Output row (b, y2, x2) is the
// concatenation of tokens (2y2, 2x2), (2y2+1, 2x2), (2y2, 2x2+1), (2y2+1, 2x2+1),
// zeros where an odd H or W ends the map (they count in the statistics, as
// the zero pad before the norm does).  One warp per row; g, b: f32 [4C].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) ln_merge_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ out, int rows, int H, int W, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int bi = r / (H2 * W2), rem = r - bi * (H2 * W2);
  const int y2 = rem / W2, x2 = rem - y2 * W2;
  const T* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int y = 2 * y2 + (q & 1), xx = 2 * x2 + (q >> 1);
    src[q] = (y < H && xx < W) ? x + (((size_t)bi * H + y) * W + xx) * C : nullptr;
  }
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (src[q] == nullptr) continue;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f<T>(src[q][c]);
      s += v;
      s2 += v * v;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const int C4 = 4 * C;
  const float mu = s / C4;
  const float rs = rsqrtf(s2 / C4 - mu * mu + eps);
  T* o = out + (size_t)r * C4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int c = lane; c < C; c += 32) {
      const float v = src[q] == nullptr ? 0.0f : to_f<T>(src[q][c]);
      o[q * C + c] = from_f<T>((v - mu) * rs * g[q * C + c] + b[q * C + c]);
    }
  }
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

template <typename T>
int launch_ln(const void* x, const void* g, const void* b, void* out, int rows, int C,
              int window_mode, WinMap m, float eps, cudaStream_t st) {
  const int per_block = 8;
  ln_rows_kernel<T><<<(rows + per_block - 1) / per_block, 32 * per_block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(out), rows, C, window_mode, m, eps);
  return (int)cudaGetLastError();
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

template <typename T>
int launch_ln_merge(const void* x, const void* g, const void* b, void* out, int rows, int H,
                    int W, int C, float eps, cudaStream_t st) {
  const int per_block = 8;
  ln_merge_kernel<T><<<(rows + per_block - 1) / per_block, 32 * per_block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(out), rows, H, W, C, eps);
  return (int)cudaGetLastError();
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
// flax's Dense casts it.  bf16 needs N % 128 == 0 and K % 64 == 0 (gemm_sm90.cu),
// fp32 N % 4 == 0 and K % 8 == 0 (the Python wrappers check the stricter
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
// f32 [chunks, nW, heads, win^2, win^2], dS summed over each of `chunks`
// balanced chunks of the batch.
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
