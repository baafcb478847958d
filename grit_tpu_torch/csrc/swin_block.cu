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
//      a block on mma.sync tiles; fp32: win_attn_f32_kernel, one block per
//      (window, head)): an exact f32 row max and softmax per query row, with
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
// K5 replaces ::_bwd_kernel (through _backward).  In bf16 it runs on
// win_attn_bwd_mma.cu (mma.sync tiles, the batch split over blocks).  The fp32
// parity path keeps win_attn_bwd_kernel below: one block per (window of the
// image, head) that loops over the batch, so the bias gradient of a window
// kind is summed over images in a fixed order by the one block that owns it
// (the TPU kernel revisits its dbias block across the batch grid axis); no
// atomics.  Per image it recomputes P from the stored q (pre-scaled), k and
// the bias table, then dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)),
// dQ = scale dS K, dK = dS^T Q.  Q, K, V, dO (f32, 74 KB) and one N x N f32
// matrix that holds P and then dS (81 KB) live in dynamic shared memory.
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
// registers (window_attn_mma.cu).  The fp32 parity path keeps the SIMT
// attention core below and a SIMT GEMM (no TF32: the parity runs compare with
// the plain path in full f32), bound by operations at 67 TFLOP/s, the card's
// f32 rate outside the tensor cores.  It is built to reach that rate (see
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

// ---------------------------------------------------------------------------
// Window attention core, fp32 (parity path; bf16: window_attn_mma.cu).  qkv:
// [B*nW*N, 3C] window-partitioned rows (q already scaled); out: [B*nW*N, C].
// One block per (window, head), 8 warps, one query row per warp at a time;
// d = 32 = one lane per head channel.  score_row is K5's too.
// ---------------------------------------------------------------------------
constexpr int WA_D = 32, WA_WARPS = 8, WA_MAXT = 8;  // N <= 32 * WA_MAXT

// scores of query row i against keys j = lane + 32 t, bias and shift mask
// included; returns the row max over the warp.  The bias comes from the
// relative-position table or, when dense_row is given (K8), from row i of a
// dense [N, N] bias
template <int MAXT>
__device__ __forceinline__ float score_row(
    const float* __restrict__ q, const float* __restrict__ Ks, int ldk,
    const float* __restrict__ table, const float* __restrict__ dense_row,
    const int* __restrict__ reg, int i, int n, int win, int heads, int h, int shift, int lane,
    float* s) {
  const int tw = 2 * win - 1;
  const int iy = i / win, ix = i - (i / win) * win;
  const int ri = shift > 0 ? reg[i] : 0;
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const int j = lane + 32 * t;
    s[t] = -INFINITY;
    if (j < n) {
      const float* kr = Ks + j * ldk;
      float acc = 0.0f;
#pragma unroll
      for (int dd = 0; dd < WA_D; ++dd) acc = fmaf(q[dd], kr[dd], acc);
      const int jy = j / win, jx = j - (j / win) * win;
      acc += dense_row ? dense_row[j]
                       : table[((iy - jy + win - 1) * tw + (ix - jx + win - 1)) * heads + h];
      if (shift > 0 && reg[j] != ri) acc += -100.0f;
      s[t] = acc;
      mx = fmaxf(mx, acc);
    }
  }
  return warp_max(mx);
}

// q, k, v: rows of stride ld (the three column blocks of one qkv tensor, or
// three tensors); qscale multiplies q (1 where the projection scaled it
// already); dense: null, or the K8
// bias f32 [dense_windows, heads, N, N], window wi reading slice wi % dense_windows.
__global__ void __launch_bounds__(256) win_attn_f32_kernel(
    const float* __restrict__ qp, const float* __restrict__ kp, const float* __restrict__ vp,
    size_t ld, float qscale, const float* __restrict__ table, const float* __restrict__ dense,
    int dense_windows, float* __restrict__ out, int C, int heads, WinMap m) {
  extern __shared__ float sm[];
  const int win = m.win, n = win * win;
  float* Ks = sm;                       // n x (D + 1)
  float* Vs = Ks + n * (WA_D + 1);      // n x D
  float* Qw = Vs + n * WA_D;            // warps x D
  float* Pw = Qw + WA_WARPS * WA_D;     // warps x n
  int* reg = reinterpret_cast<int*>(Pw + WA_WARPS * n);  // n
  const int wi = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)wi * n;
  const float* dense_w =
      dense ? dense + ((size_t)(wi % dense_windows) * heads + h) * n * n : nullptr;

  for (int idx = tid; idx < n * WA_D; idx += blockDim.x) {
    const int j = idx / WA_D, dd = idx - (idx / WA_D) * WA_D;
    const size_t off = (row0 + j) * ld + h * WA_D + dd;
    Ks[j * (WA_D + 1) + dd] = kp[off];
    Vs[j * WA_D + dd] = vp[off];
  }
  if (m.shift > 0) {
    // shifted-window regions on the rolled padded grid: rows [0, Hp - w),
    // [Hp - w, Hp - s), [Hp - s, Hp) and likewise for columns
    const int nwx = m.Wp / win, per_img = (m.Hp / win) * nwx;
    const int wr = wi % per_img, wy = wr / nwx, wx = wr - wy * nwx;
    for (int j = tid; j < n; j += blockDim.x) {
      const int ry = wy * win + j / win, rx = wx * win + j % win;
      const int gy = ry < m.Hp - win ? 0 : (ry < m.Hp - m.shift ? 1 : 2);
      const int gx = rx < m.Wp - win ? 0 : (rx < m.Wp - m.shift ? 1 : 2);
      reg[j] = gy * 3 + gx;
    }
  }
  __syncthreads();

  float* q = Qw + warp * WA_D;
  float* p = Pw + warp * n;
  for (int i = warp; i < n; i += WA_WARPS) {
    q[lane] = qp[(row0 + i) * ld + h * WA_D + lane] * qscale;
    __syncwarp();
    float s[WA_MAXT];
    const float mx = score_row<WA_MAXT>(q, Ks, WA_D + 1, table, dense_w ? dense_w + i * n : nullptr,
                                        reg, i, n, win, heads, h, m.shift, lane, s);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < WA_MAXT; ++t) {
      if (lane + 32 * t < n) {
        s[t] = expf(s[t] - mx);
        sum += s[t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < WA_MAXT; ++t) {
      const int j = lane + 32 * t;
      if (j < n) p[j] = s[t] / sum;
    }
    __syncwarp();
    float o = 0.0f;
    for (int j = 0; j < n; ++j) o = fmaf(p[j], Vs[j * WA_D + lane], o);
    out[(row0 + i) * C + h * WA_D + lane] = o;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K5 in fp32 (the parity path; bf16: win_attn_bwd_mma.cu): window attention
// backward.  qkv: [B*nW*N, 3C] as the forward stored it
// (q pre-scaled); dout: [B*nW*N, C], the gradient of the attention core's
// output; dqkv: [B*nW*N, 3C], gradients of the qkv projection's output (dq
// carries the q scale); dbias: f32 [nW, heads, N, N], dS summed over images.
// One block per (window of the image, head), WB_WARPS warps; needs N % 4 == 0.
// ---------------------------------------------------------------------------
// 18 warps: 144 rows are 8 rounds of 18, 36 column groups of 4 are 2 rounds
constexpr int WB_LD = WA_D + 1, WB_WARPS = 18;

// q, k, v and their gradients dq, dk, dv: rows of stride ld (column blocks of
// one tensor, or three tensors); qscale and dense as in win_attn_f32_kernel
// (q rounded to the storage type after the scale).
template <typename T>
__global__ void __launch_bounds__(32 * WB_WARPS) win_attn_bwd_kernel(
    const T* __restrict__ qp, const T* __restrict__ kp, const T* __restrict__ vp,
    const T* __restrict__ dout, size_t ld, float qscale, const float* __restrict__ table,
    const float* __restrict__ dense, int dense_windows, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dbias, int batch, int C, int heads, float scale,
    WinMap m) {
  extern __shared__ float sm[];
  const int win = m.win, n = win * win;
  float* Qs = sm;                 // n x WB_LD each
  float* Ks = Qs + n * WB_LD;
  float* Vs = Ks + n * WB_LD;
  float* Gs = Vs + n * WB_LD;     // dO
  float* Mx = Gs + n * WB_LD;     // n x n: P, then dS
  int* reg = reinterpret_cast<int*>(Mx + n * n);
  const int w = blockIdx.x, h = blockIdx.y, per_img = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* db = dbias + ((size_t)w * heads + h) * n * n;
  const float* dense_w =
      dense ? dense + ((size_t)(w % dense_windows) * heads + h) * n * n : nullptr;

  if (m.shift > 0) {
    const int nwx = m.Wp / win;
    const int wy = w / nwx, wx = w - wy * nwx;
    for (int j = tid; j < n; j += blockDim.x) {
      const int ry = wy * win + j / win, rx = wx * win + j % win;
      const int gy = ry < m.Hp - win ? 0 : (ry < m.Hp - m.shift ? 1 : 2);
      const int gx = rx < m.Wp - win ? 0 : (rx < m.Wp - m.shift ? 1 : 2);
      reg[j] = gy * 3 + gx;
    }
  }

  for (int b = 0; b < batch; ++b) {
    const size_t row0 = ((size_t)b * per_img + w) * n;
    __syncthreads();  // the previous image's passes are done with shared memory
    for (int idx = tid; idx < n * WA_D; idx += blockDim.x) {
      const int j = idx / WA_D, dd = idx - (idx / WA_D) * WA_D;
      const size_t off = (row0 + j) * ld + h * WA_D + dd;
      Qs[j * WB_LD + dd] = to_f<T>(from_f<T>(to_f<T>(qp[off]) * qscale));
      Ks[j * WB_LD + dd] = to_f<T>(kp[off]);
      Vs[j * WB_LD + dd] = to_f<T>(vp[off]);
      Gs[j * WB_LD + dd] = to_f<T>(dout[(row0 + j) * C + h * WA_D + dd]);
    }
    __syncthreads();

    // pass 1: P = softmax(S), one query row per warp
    for (int i = warp; i < n; i += WB_WARPS) {
      float s[WA_MAXT];
      const float mx = score_row<WA_MAXT>(Qs + i * WB_LD, Ks, WB_LD, table,
                                          dense_w ? dense_w + i * n : nullptr, reg, i, n, win,
                                          heads, h, m.shift, lane, s);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < WA_MAXT; ++t) {
        if (lane + 32 * t < n) {
          s[t] = expf(s[t] - mx);
          sum += s[t];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < WA_MAXT; ++t) {
        const int j = lane + 32 * t;
        if (j < n) Mx[i * n + j] = s[t] / sum;
      }
    }
    __syncthreads();

    // pass 2: dV[j] = sum_i P[i, j] dO[i], P in the storage type as the forward used it;
    // a warp takes 4 neighbouring columns j so that one dO load feeds 4 products
    for (int j = 4 * warp; j < n; j += 4 * WB_WARPS) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(Mx + i * n + j);
        const float gv = Gs[i * WB_LD + lane];
        acc[0] = fmaf(to_f<T>(from_f<T>(pr.x)), gv, acc[0]);
        acc[1] = fmaf(to_f<T>(from_f<T>(pr.y)), gv, acc[1]);
        acc[2] = fmaf(to_f<T>(from_f<T>(pr.z)), gv, acc[2]);
        acc[3] = fmaf(to_f<T>(from_f<T>(pr.w)), gv, acc[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dv[(row0 + j + k) * ld + h * WA_D + lane] = from_f<T>(acc[k]);
    }
    __syncthreads();

    // pass 3: dP = dO V^T, dS = P (dP - rowsum(dP P)) over P in place, dQ = scale dS K
    for (int i = warp; i < n; i += WB_WARPS) {
      const float* g = Gs + i * WB_LD;
      float dp[WA_MAXT];
      float part = 0.0f;
#pragma unroll
      for (int t = 0; t < WA_MAXT; ++t) {
        const int j = lane + 32 * t;
        dp[t] = 0.0f;
        if (j < n) {
          const float* vr = Vs + j * WB_LD;
          float acc = 0.0f;
#pragma unroll
          for (int dd = 0; dd < WA_D; ++dd) acc = fmaf(g[dd], vr[dd], acc);
          dp[t] = acc;
          part = fmaf(acc, Mx[i * n + j], part);
        }
      }
      part = warp_sum(part);
#pragma unroll
      for (int t = 0; t < WA_MAXT; ++t) {
        const int j = lane + 32 * t;
        if (j < n) Mx[i * n + j] *= dp[t] - part;
      }
      __syncwarp();
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc = fmaf(Mx[i * n + j], Ks[j * WB_LD + lane], acc);
      dq[(row0 + i) * ld + h * WA_D + lane] = from_f<T>(acc * scale);
    }
    __syncthreads();

    // pass 4: dK[j] = sum_i dS[i, j] Q[i] (Q carries the scale); dBias += dS
    for (int j = 4 * warp; j < n; j += 4 * WB_WARPS) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; ++i) {
        const float4 ds = *reinterpret_cast<const float4*>(Mx + i * n + j);
        const float qv = Qs[i * WB_LD + lane];
        acc[0] = fmaf(ds.x, qv, acc[0]);
        acc[1] = fmaf(ds.y, qv, acc[1]);
        acc[2] = fmaf(ds.z, qv, acc[2]);
        acc[3] = fmaf(ds.w, qv, acc[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dk[(row0 + j + k) * ld + h * WA_D + lane] = from_f<T>(acc[k]);
    }
    for (int idx = tid; idx < n * n; idx += blockDim.x)
      db[idx] = (b == 0 ? 0.0f : db[idx]) + Mx[idx];
  }
}

template <typename T>
int launch_win_attn_bwd(const void* q, const void* k, const void* v, const void* dout, size_t ld,
                        float qscale, const void* table, const void* dense, int dense_windows,
                        void* dq, void* dk, void* dv, void* dbias, int batch, int C, int heads,
                        float scale, WinMap m, cudaStream_t st) {
  const int n = m.win * m.win;
  const size_t smem = (size_t)(4 * n * WB_LD + n * n + n) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      win_attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m.Hp / m.win) * (m.Wp / m.win), heads);
  win_attn_bwd_kernel<T><<<grid, 32 * WB_WARPS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), ld, qscale, static_cast<const float*>(table),
      static_cast<const float*>(dense), dense_windows, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dbias), batch, C, heads, scale, m);
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

int launch_win_attn_f32(const void* q, const void* k, const void* v, size_t ld, float qscale,
                        const void* table, const void* dense, int dense_windows, void* out,
                        int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  const int n = m.win * m.win;
  const size_t smem = (size_t)(n * (WA_D + 1) + n * WA_D + WA_WARPS * WA_D + WA_WARPS * n) * 4 +
                      (size_t)n * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        win_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(num_windows, heads);
  win_attn_f32_kernel<<<grid, 32 * WA_WARPS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), ld,
      qscale, static_cast<const float*>(table), static_cast<const float*>(dense), dense_windows,
      static_cast<float*>(out), C, heads, m);
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
  return launch_win_attn_f32(q, k, v, ld, qscale, table, dense, dense_windows, out, num_windows, C,
                             heads, m, st);
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

// K5 (bf16: win_attn_bwd_mma.cu; fp32: win_attn_bwd_kernel): qkv, dqkv
// [batch * nW * win^2, 3C]; dout [.., C]; table f32 [(2win-1)^2, heads]; dbias
// f32 [chunks, nW, heads, win^2, win^2], dS summed over each of `chunks`
// balanced chunks of the batch (fp32: chunks = 1).
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
  if (chunks != 1) return (int)cudaErrorInvalidValue;
  return launch_win_attn_bwd<float>(
      qkv, col_block<float>(qkv, C, 1), col_block<float>(qkv, C, 2), dout, ld, 1.0f, table,
      nullptr, 1, dqkv, col_block<float>(dqkv, C, 1), col_block<float>(dqkv, C, 2), dbias, batch,
      C, heads, scale, m, st);
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
// for a one-window bias, are the caller's; fp32: chunks = 1).
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
  if (chunks != 1) return (int)cudaErrorInvalidValue;
  return launch_win_attn_bwd<float>(q, k, v, dout, (size_t)C, scale, nullptr, bias, bias_windows,
                                    dq, dk, dv, dbias, batch, C, heads, scale, m, st);
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
