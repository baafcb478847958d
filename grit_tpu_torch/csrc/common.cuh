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

}  // namespace grit
