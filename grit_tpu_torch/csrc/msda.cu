// K3: multi-scale deformable attention forward, and K6: its backward.
//
// Replaces the TPU's grit_tpu/ops/msda_pallas.py::_gather_matmul_kernel_v5
// (reached through ms_deform_attn_pallas_v5 / msda.py::ms_deform_attn_relaid).
// The same function is computed by the TPU's S-chunked _gather_matmul_kernel_v5s
// and the older layouts _gather_matmul_kernel (v2), _v3 and _v4; on the GPU a
// gather never holds the value slab on chip, so this one kernel serves them all.
//
// The TPU kernel builds one-hot selection matrices over a relaid value slab
// (W padded to 8 sublanes) and contracts them on the MXU.  Here it is a direct
// gather on the natural [N, S, C] layout, as the reference CUDA im2col does:
// one block per (image, query), one thread per (head, channel), a loop over
// levels x points x 4 bilinear corners with f32 accumulation.  Corners outside
// the level grid (zero padding, align_corners=False) or outside the image's
// real rectangle min(level size, real_hw) contribute zero, so the value needs
// no pre-mask pass.  floorf, not truncation, handles negative coordinates.
//
// What bounds it on an H100: scattered reads.  Each (image, query, head) reads
// L*P*4 rows of D contiguous channels (128 B in bf16 at D = 64); the 5.2 MB
// bf16 value map of one 384x640 image fits in the 50 MB L2, so the gather
// runs at L2 rather than HBM bandwidth.
//
// K6 replaces ::_gather_bwd_kernel_v4 (reached through _gather_bwd_v5, and
// through _gather_bwd_v4) and the S-chunked ::_gather_bwd_kernel_v5s, which
// compute the same function.  The TPU kernel returns the value gradient and a
// corner-weight gradient and leaves the chain to sampling locations and
// attention weights to autodiff of its corner preparation; here one kernel
// gives all three.  Same launch shape as K3: one block per (image, query), one
// thread per (head, channel).  Each thread re-reads its 4 corners per (level,
// point), scatters dOut * attn * corner weight into an f32 value-gradient
// buffer with atomicAdd (bf16 rounds once afterwards, in the wrapper), and
// forms its channel's share of d(attn), d(loc x), d(loc y); those are summed
// over the head's channels by warp shuffles, then across the head's warps
// through shared memory in a fixed order.  Taps outside the level or the
// image's real rectangle get no gradient, as they gave no value.  What bounds
// it: the atomics (N * Lq * C * L * P * 4 of them, coalesced across channels,
// onto a value gradient that fits the L2).  Their order is not fixed, so the
// value gradient is reproducible to f32 summation order only; the location
// and weight gradients are deterministic.
#include "common.cuh"

namespace grit {

// Normalized location -> pixel coordinate (align_corners=False).  The product
// is rounded before the subtraction, as the plain version's two operations
// do: contracted into one FMA, a coordinate within an ulp of an integer would
// fall into the neighbouring cell, where the value agrees but the location
// gradient (the slope of another cell) does not.
__device__ __forceinline__ float pixel(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

template <typename T>
__global__ void __launch_bounds__(256) msda_kernel(
    const T* __restrict__ value, const int* __restrict__ shapes, const float* __restrict__ loc,
    const float* __restrict__ attw, const int* __restrict__ real_hw, T* __restrict__ out, int S,
    int Lq, int M, int D, int L, int P) {
  const int nq = blockIdx.x;
  const int n = nq / Lq;
  const int C = M * D;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int m = c / D;
    const float* lp = loc + ((size_t)nq * M + m) * L * P * 2;
    const float* ap = attw + ((size_t)nq * M + m) * L * P;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int H = shapes[3 * l], W = shapes[3 * l + 1], st = shapes[3 * l + 2];
      const int hmax = min(H, real_hw[(n * L + l) * 2]);
      const int wmax = min(W, real_hw[(n * L + l) * 2 + 1]);
      const T* vl = value + ((size_t)n * S + st) * C + c;
      for (int p = 0; p < P; ++p) {
        const float px = pixel(lp[(l * P + p) * 2], W);
        const float py = pixel(lp[(l * P + p) * 2 + 1], H);
        const float x0f = floorf(px), y0f = floorf(py);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float lx = px - x0f, ly = py - y0f;
        const bool xa = x0 >= 0 && x0 < wmax, xb = x0 + 1 >= 0 && x0 + 1 < wmax;
        const bool ya = y0 >= 0 && y0 < hmax, yb = y0 + 1 >= 0 && y0 + 1 < hmax;
        float v = 0.0f;
        if (ya && xa) v += (1.0f - lx) * (1.0f - ly) * to_f<T>(vl[((size_t)y0 * W + x0) * C]);
        if (ya && xb) v += lx * (1.0f - ly) * to_f<T>(vl[((size_t)y0 * W + x0 + 1) * C]);
        if (yb && xa) v += (1.0f - lx) * ly * to_f<T>(vl[((size_t)(y0 + 1) * W + x0) * C]);
        if (yb && xb) v += lx * ly * to_f<T>(vl[((size_t)(y0 + 1) * W + x0 + 1) * C]);
        acc = fmaf(ap[l * P + p], v, acc);
      }
    }
    out[(size_t)nq * C + c] = from_f<T>(acc);
  }
}


template <typename T>
__global__ void __launch_bounds__(1024) msda_bwd_kernel(
    const T* __restrict__ value, const int* __restrict__ shapes, const float* __restrict__ loc,
    const float* __restrict__ attw, const int* __restrict__ real_hw, const T* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dloc, float* __restrict__ dattw, int S,
    int Lq, int M, int D, int L, int P) {
  extern __shared__ float part[];  // [C / seg][L * P * 3]
  const int nq = blockIdx.x;
  const int n = nq / Lq;
  const int C = M * D;
  const int c = threadIdx.x;       // blockDim.x == C, a multiple of 32
  const int lane = c & 31;
  const int seg = D < 32 ? D : 32; // channels summed by shuffles: a power of two
  const int lp3 = L * P * 3;
  const int m = c / D;
  const float* lp = loc + ((size_t)nq * M + m) * L * P * 2;
  const float* ap = attw + ((size_t)nq * M + m) * L * P;
  const float g = to_f<T>(dout[(size_t)nq * C + c]);
  for (int l = 0; l < L; ++l) {
    const int H = shapes[3 * l], W = shapes[3 * l + 1], st = shapes[3 * l + 2];
    const int hmax = min(H, real_hw[(n * L + l) * 2]);
    const int wmax = min(W, real_hw[(n * L + l) * 2 + 1]);
    const size_t base = ((size_t)n * S + st) * C + c;
    for (int p = 0; p < P; ++p) {
      const float px = pixel(lp[(l * P + p) * 2], W);
      const float py = pixel(lp[(l * P + p) * 2 + 1], H);
      const float x0f = floorf(px), y0f = floorf(py);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float lx = px - x0f, ly = py - y0f;
      const bool xa = x0 >= 0 && x0 < wmax, xb = x0 + 1 >= 0 && x0 + 1 < wmax;
      const bool ya = y0 >= 0 && y0 < hmax, yb = y0 + 1 >= 0 && y0 + 1 < hmax;
      const size_t o00 = base + ((size_t)y0 * W + x0) * C, o10 = o00 + C;
      const size_t o01 = o00 + (size_t)W * C, o11 = o01 + C;
      const float v00 = ya && xa ? to_f<T>(value[o00]) : 0.0f;
      const float v10 = ya && xb ? to_f<T>(value[o10]) : 0.0f;
      const float v01 = yb && xa ? to_f<T>(value[o01]) : 0.0f;
      const float v11 = yb && xb ? to_f<T>(value[o11]) : 0.0f;
      const float a = ap[l * P + p];
      const float ga = g * a;
      if (ya && xa) atomicAdd(dvalue + o00, ga * (1.0f - lx) * (1.0f - ly));
      if (ya && xb) atomicAdd(dvalue + o10, ga * lx * (1.0f - ly));
      if (yb && xa) atomicAdd(dvalue + o01, ga * (1.0f - lx) * ly);
      if (yb && xb) atomicAdd(dvalue + o11, ga * lx * ly);
      float r[3];
      r[0] = g * ((1.0f - lx) * (1.0f - ly) * v00 + lx * (1.0f - ly) * v10 +
                  (1.0f - lx) * ly * v01 + lx * ly * v11);
      r[1] = ga * ((1.0f - ly) * (v10 - v00) + ly * (v11 - v01)) * W;
      r[2] = ga * ((1.0f - lx) * (v01 - v00) + lx * (v11 - v10)) * H;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = r[k];
        for (int o = seg >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane % seg == 0) part[(c / seg) * lp3 + (l * P + p) * 3 + k] = v;
      }
    }
  }
  __syncthreads();
  const int per_head = D / seg;
  for (int idx = c; idx < M * lp3; idx += blockDim.x) {
    const int mm = idx / lp3, k = idx - mm * lp3;
    float v = 0.0f;
    for (int s = 0; s < per_head; ++s) v += part[(mm * per_head + s) * lp3 + k];
    const size_t q = ((size_t)nq * M + mm) * L * P + k / 3;
    const int comp = k % 3;
    if (comp == 0) dattw[q] = v;
    else dloc[q * 2 + comp - 1] = v;
  }
}

}  // namespace grit

using namespace grit;

extern "C" {

// value [N, S, M*D]; shapes int32 [L, 3] = (H, W, level start); loc f32
// [N, Lq, M, L, P, 2]; attw f32 [N, Lq, M, L, P]; real_hw int32 [N, L, 2];
// out [N, Lq, M*D].
int grit_msda(const void* value, const void* shapes, const void* loc, const void* attw,
              const void* real_hw, void* out, int N, int S, int Lq, int M, int D, int L, int P,
              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = M * D < 256 ? ((M * D + 31) / 32) * 32 : 256;
  const int* sh = static_cast<const int*>(shapes);
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(attw);
  const int* rh = static_cast<const int*>(real_hw);
  if (dtype == 1) {
    msda_kernel<bf16><<<N * Lq, threads, 0, st>>>(static_cast<const bf16*>(value), sh, lp, ap, rh,
                                                  static_cast<bf16*>(out), S, Lq, M, D, L, P);
  } else {
    msda_kernel<float><<<N * Lq, threads, 0, st>>>(static_cast<const float*>(value), sh, lp, ap,
                                                   rh, static_cast<float*>(out), S, Lq, M, D, L, P);
  }
  return (int)cudaGetLastError();
}

// K6: dout [N, Lq, M*D]; dvalue f32 [N, S, M*D], zeroed by the caller; dloc f32
// [N, Lq, M, L, P, 2]; dattw f32 [N, Lq, M, L, P].  M*D <= 1024 and a multiple
// of 32; D a power of two below 32 or a multiple of 32 (checked by the caller).
int grit_msda_bwd(const void* value, const void* shapes, const void* loc, const void* attw,
                  const void* real_hw, const void* dout, void* dvalue, void* dloc, void* dattw,
                  int N, int S, int Lq, int M, int D, int L, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = M * D, seg = D < 32 ? D : 32;
  const size_t smem = (size_t)(C / seg) * L * P * 3 * sizeof(float);
  const int* sh = static_cast<const int*>(shapes);
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(attw);
  const int* rh = static_cast<const int*>(real_hw);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattw);
  if (dtype == 1) {
    msda_bwd_kernel<bf16><<<N * Lq, C, smem, st>>>(
        static_cast<const bf16*>(value), sh, lp, ap, rh, static_cast<const bf16*>(dout), dv, dl,
        da, S, Lq, M, D, L, P);
  } else {
    msda_bwd_kernel<float><<<N * Lq, C, smem, st>>>(
        static_cast<const float*>(value), sh, lp, ap, rh, static_cast<const float*>(dout), dv,
        dl, da, S, Lq, M, D, L, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
