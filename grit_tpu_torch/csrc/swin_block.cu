// Swin block kernels: K1 (attention half-block) and K2 (MLP half-block).
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
//   3. win_attn: one block per (window, head); K and V of the window in
//      shared memory, an exact f32 row max and softmax per query row, with
//      the relative-position bias read from its [(2w-1)^2, heads] table and
//      the shifted-window region derived from token coordinates (neither
//      [nW, h, N, N] tensor is ever materialised).
//   4. gemm (EPI_RESID_MAP): proj + bias + the pad-masked residual, stored
//      through the window-reverse + unshift address.
// K2 is three launches on rows [R, C]: ln_rows (row mode), gemm (EPI_GELU,
// exact-erf GELU; the TPU's rational/A&S approximations existed only because
// Mosaic has no erf), gemm (EPI_RESID).  fused_block_mlp_step is K1 then K2.
//
// What bounds them on an H100: the GEMMs are tensor-core work (bf16 in, f32
// accumulate via WMMA 16x16x16 tiles; fp32 parity runs use a SIMT FMA tile),
// the attention core is shared-memory FMA work over 144 x 144 scores per
// (window, head) at d = 32, and LN is a memory pass.  This first version
// writes every intermediate (xn, qkv, the attention output, the 4C-wide MLP
// hidden) to device memory and reads it back; keeping them on chip, as the
// TPU kernels keep them in VMEM, is later work.
#include <mma.h>

#include "common.cuh"

namespace grit {

enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_RESID_MAP = 3 };

struct Epi {
  const void* bias;    // storage type; [N]
  void* out;
  const void* resid;   // storage type; [M, N] (EPI_RESID) or the map (EPI_RESID_MAP)
  int mode;
  float scale;         // EPI_BIAS: multiplies columns < scale_cols
  int scale_cols;
  WinMap map;          // EPI_RESID_MAP: row -> map token, pad flag
};

template <typename T>
__device__ __forceinline__ void epi_store(const Epi& e, int row, int col, int N, float acc) {
  float v = acc + to_f<T>(static_cast<const T*>(e.bias)[col]);
  size_t orow = (size_t)row;
  if (e.mode == EPI_BIAS) {
    if (col < e.scale_cols) v *= e.scale;
  } else if (e.mode == EPI_GELU) {
    v = 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  } else if (e.mode == EPI_RESID) {
    v += to_f<T>(static_cast<const T*>(e.resid)[orow * N + col]);
  } else {
    bool pad;
    orow = win_row_to_token(e.map, row, &pad);
    if (!pad) v += to_f<T>(static_cast<const T*>(e.resid)[orow * N + col]);
  }
  static_cast<T*>(e.out)[orow * N + col] = from_f<T>(v);
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
// out = epilogue(A W^T): A [M, K] row-major, W [N, K] (torch Linear layout).
// bf16: 128 x 64 block tile, 8 warps of 32 x 32 (2 x 2 WMMA fragments), K
// steps of 32 through shared memory; the f32 accumulator tile is staged in
// shared memory (aliasing the A/B tiles) for a coalesced epilogue.
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;

constexpr int GB_M = 128, GB_N = 64, GB_K = 32, GB_LD = GB_K + 8, GB_CLD = GB_N + 4;
constexpr int GB_SMEM_AB = (GB_M + GB_N) * GB_LD * 2;
constexpr int GB_SMEM_C = GB_M * GB_CLD * 4;
constexpr int GB_SMEM = GB_SMEM_C > GB_SMEM_AB ? GB_SMEM_C : GB_SMEM_AB;

__global__ void __launch_bounds__(256) gemm_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K, Epi e) {
  __shared__ __align__(128) unsigned char smem[GB_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + GB_M * GB_LD;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wrow = (warp >> 1) * 32, wcol = (warp & 1) * 32;
  const int m0 = blockIdx.x * GB_M, n0 = blockIdx.y * GB_N;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
    for (int c = tid; c < GB_M * 4; c += 256) {
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(As + r * GB_LD + kc) = v;
    }
    for (int c = tid; c < GB_N * 4; c += 256) {
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N) v = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(Ws + r * GB_LD + kc) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a[2];
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wm::load_matrix_sync(a[i], As + (wrow + i * 16) * GB_LD + kk, GB_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wm::load_matrix_sync(bfr[j], Ws + (wcol + j * 16) * GB_LD + kk, GB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(Cs + (wrow + i * 16) * GB_CLD + wcol + j * 16, acc[i][j], GB_CLD,
                            wm::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < GB_M * GB_N; idx += 256) {
    const int r = idx / GB_N, c = idx - r * GB_N;
    if (m0 + r < M && n0 + c < N) epi_store<bf16>(e, m0 + r, n0 + c, N, Cs[r * GB_CLD + c]);
  }
}

// fp32 (parity path): 64 x 64 block tile, 4 x 4 outputs per thread, SIMT FMA.
constexpr int GF_M = 64, GF_N = 64, GF_K = 16;

__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W, int M, int N, int K, Epi e) {
  __shared__ float As[GF_K][GF_M + 4];
  __shared__ float Ws[GF_K][GF_N + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * GF_M, n0 = blockIdx.y * GF_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += GF_K) {
    for (int c = tid; c < GF_M * GF_K; c += 256) {
      const int r = c / GF_K, kk = c - r * GF_K;
      As[kk][r] = (m0 + r < M) ? A[(size_t)(m0 + r) * K + k0 + kk] : 0.0f;
      Ws[kk][r] = (n0 + r < N) ? W[(size_t)(n0 + r) * K + k0 + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GF_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) epi_store<float>(e, row, col, N, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Window attention core.  qkv: [B*nW*N, 3C] window-partitioned rows (q
// already scaled); out: [B*nW*N, C].  One block per (window, head), 8 warps,
// one query row per warp at a time; d = 32 = one lane per head channel.
// ---------------------------------------------------------------------------
constexpr int WA_D = 32, WA_WARPS = 8, WA_MAXT = 8;  // N <= 32 * WA_MAXT

template <typename T>
__global__ void __launch_bounds__(256) win_attn_kernel(
    const T* __restrict__ qkv, const float* __restrict__ table, T* __restrict__ out,
    int C, int heads, WinMap m) {
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
  const size_t ld = 3 * (size_t)C;

  for (int idx = tid; idx < n * WA_D; idx += blockDim.x) {
    const int j = idx / WA_D, dd = idx - (idx / WA_D) * WA_D;
    const T* rp = qkv + (row0 + j) * ld + h * WA_D + dd;
    Ks[j * (WA_D + 1) + dd] = to_f<T>(rp[C]);
    Vs[j * WA_D + dd] = to_f<T>(rp[2 * C]);
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

  const int tw = 2 * win - 1;
  float* q = Qw + warp * WA_D;
  float* p = Pw + warp * n;
  for (int i = warp; i < n; i += WA_WARPS) {
    q[lane] = to_f<T>(qkv[(row0 + i) * ld + h * WA_D + lane]);
    __syncwarp();
    const int iy = i / win, ix = i - (i / win) * win;
    const int ri = m.shift > 0 ? reg[i] : 0;
    float s[WA_MAXT];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < WA_MAXT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float* kr = Ks + j * (WA_D + 1);
        float acc = 0.0f;
#pragma unroll
        for (int dd = 0; dd < WA_D; ++dd) acc = fmaf(q[dd], kr[dd], acc);
        const int jy = j / win, jx = j - (j / win) * win;
        acc += table[((iy - jy + win - 1) * tw + (ix - jx + win - 1)) * heads + h];
        if (m.shift > 0 && reg[j] != ri) acc += -100.0f;
        s[t] = acc;
        mx = fmaxf(mx, acc);
      }
    }
    mx = warp_max(mx);
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
      if (j < n) p[j] = to_f<T>(from_f<T>(s[t] / sum));  // p in the storage type, as on the TPU
    }
    __syncwarp();
    float o = 0.0f;
    for (int j = 0; j < n; ++j) o = fmaf(p[j], Vs[j * WA_D + lane], o);
    out[(row0 + i) * C + h * WA_D + lane] = from_f<T>(o);
    __syncwarp();
  }
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

template <typename T>
int launch_win_attn(const void* qkv, const void* table, void* out, int num_windows, int C,
                    int heads, WinMap m, cudaStream_t st) {
  const int n = m.win * m.win;
  const size_t smem = (size_t)(n * (WA_D + 1) + n * WA_D + WA_WARPS * WA_D + WA_WARPS * n) * 4 +
                      (size_t)n * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        win_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(num_windows, heads);
  win_attn_kernel<T><<<grid, 32 * WA_WARPS, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(table), static_cast<T*>(out), C,
      heads, m);
  return (int)cudaGetLastError();
}

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
// flax's Dense casts it.  bf16 needs K % 32 == 0, fp32 K % 16 == 0; both
// N % 64 == 0 (checked by the Python wrapper).
int grit_gemm(const void* A, const void* W, const void* bias, void* out, const void* resid,
              int M, int N, int K, int mode, float scale, int scale_cols, int Hp, int Wp,
              int win, int shift, int real_h, int real_w, int dtype, void* stream) {
  Epi e{bias, out, resid, mode, scale, scale_cols,
        WinMap{Hp, Wp, win, shift, real_h, real_w}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((M + GB_M - 1) / GB_M, (N + GB_N - 1) / GB_N);
    gemm_bf16_kernel<<<grid, 256, 0, st>>>(static_cast<const bf16*>(A),
                                          static_cast<const bf16*>(W), M, N, K, e);
  } else {
    dim3 grid((M + GF_M - 1) / GF_M, (N + GF_N - 1) / GF_N);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(A),
                                         static_cast<const float*>(W), M, N, K, e);
  }
  return (int)cudaGetLastError();
}

// qkv: [num_windows * win^2, 3C]; table f32 [(2win-1)^2, heads]; out [.., C].
int grit_window_attn(const void* qkv, const void* table, void* out, int num_windows, int C,
                     int heads, int Hp, int Wp, int win, int shift, int dtype, void* stream) {
  WinMap m{Hp, Wp, win, shift, Hp, Wp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_win_attn<bf16>(qkv, table, out, num_windows, C, heads, m, st);
  return launch_win_attn<float>(qkv, table, out, num_windows, C, heads, m, st);
}

}  // extern "C"
