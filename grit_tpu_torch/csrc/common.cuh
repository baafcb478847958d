// Shared helpers for the grit_tpu_torch Hopper kernels.
//
// Every kernel is instantiated for float (the fp32 parity path) and
// __nv_bfloat16 (the production path); `dtype` codes at the C interface are
// 0 = float32, 1 = bfloat16.  All arithmetic is f32; storage rounds to the
// storage type with round-to-nearest-even, like JAX's astype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace grit {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Geometry of one Swin stage's padded map [B, Hp, Wp, C] and the block's
// window partition.  Row r of the window-partitioned order enumerates
// (image, window row, window col, token row, token col) of the map ROLLED by
// -shift; win_row_to_token maps it back to the flat token index of the
// unrolled map, which is where the kernels load and store.  So the cyclic
// shift and the window partition/reverse live in the addresses only.
struct WinMap {
  int Hp, Wp, win, shift, real_h, real_w;
};

__device__ __forceinline__ size_t win_row_to_token(const WinMap& m, int r, bool* pad) {
  const int n = m.win * m.win;
  const int wi = r / n;
  const int t = r - wi * n;
  const int iy = t / m.win, ix = t - (t / m.win) * m.win;
  const int nwx = m.Wp / m.win, per_img = (m.Hp / m.win) * nwx;
  const int b = wi / per_img, wr = wi - b * per_img;
  const int wy = wr / nwx, wx = wr - wy * nwx;
  int y = wy * m.win + iy + m.shift;
  if (y >= m.Hp) y -= m.Hp;
  int x = wx * m.win + ix + m.shift;
  if (x >= m.Wp) x -= m.Wp;
  *pad = (y >= m.real_h) || (x >= m.real_w);
  return ((size_t)b * m.Hp + y) * m.Wp + x;
}

// The GEMMs' epilogues (swin_block.cu, gemm_sm90.cu): out = epilogue(A W^T).
enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_RESID_MAP = 3, EPI_MAP = 4 };

struct Epi {
  const void* bias;    // storage type; [N], or null for none
  void* out;
  const void* resid;   // storage type; [M, N] (EPI_RESID) or the map (EPI_RESID_MAP)
  int mode;
  float scale;         // EPI_BIAS: multiplies columns < scale_cols
  int scale_cols;
  WinMap map;          // EPI_RESID_MAP, EPI_MAP, a_gather: row -> map token, pad flag
  int a_gather;        // A's row r is read from map token win_row_to_token(r)
};

// Launchers of the Hopper kernels in their own files (bf16: gemm_sm90.cu,
// window_attn_mma.cu, win_attn_bwd_mma.cu; fp32: win_attn_f32.cu); each
// returns a cudaError_t.
int launch_gemm_bf16(const bf16* A, const bf16* W, int M, int N, int K, const Epi& e,
                     cudaStream_t st);
int launch_win_attn_bf16(const bf16* q, const bf16* k, const bf16* v, size_t ld, float qscale,
                         const float* table, const float* dense, int dense_windows, bf16* out,
                         int num_windows, int C, int heads, WinMap m, cudaStream_t st);
int launch_win_attn_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                             size_t ld, float qscale, float scale, const float* table,
                             const float* dense, int dense_windows, bf16* dq, bf16* dk, bf16* dv,
                             float* dbias, int batch, int chunks, int C, int heads, WinMap m,
                             cudaStream_t st);
int launch_win_attn_f32(const float* q, const float* k, const float* v, size_t ld, float qscale,
                        const float* table, const float* dense, int dense_windows, float* out,
                        int num_windows, int C, int heads, WinMap m, cudaStream_t st);
int launch_win_attn_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                            size_t ld, float qscale, float scale, const float* table,
                            const float* dense, int dense_windows, float* dq, float* dk, float* dv,
                            float* dbias, int batch, int chunks, int C, int heads, WinMap m,
                            cudaStream_t st);

}  // namespace grit
