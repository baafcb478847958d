// K3: multi-scale deformable attention forward.
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
#include "common.cuh"

namespace grit {

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
        const float px = lp[(l * P + p) * 2] * W - 0.5f;
        const float py = lp[(l * P + p) * 2 + 1] * H - 0.5f;
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

}  // extern "C"
