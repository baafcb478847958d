// K3: multi-scale deformable attention forward, and K6: its backward.
//
// Replaces the TPU's grit_tpu/ops/msda_pallas.py::_gather_matmul_kernel_v5
// (reached through ms_deform_attn_pallas_v5 / msda.py::ms_deform_attn_relaid).
// The same function is computed by the TPU's S-chunked _gather_matmul_kernel_v5s
// and the older layouts _gather_matmul_kernel (v2), _v3 and _v4; on the GPU a
// gather never holds the value slab on chip, so this one kernel serves them all.
// K6 replaces ::_gather_bwd_kernel_v4 (reached through _gather_bwd_v5, and
// through _gather_bwd_v4) and the S-chunked ::_gather_bwd_kernel_v5s, which
// compute the same function.  The TPU kernel returns the value gradient and a
// corner-weight gradient and leaves the chain to sampling locations and
// attention weights to autodiff of its corner preparation; here one kernel
// gives all three.
//
// The TPU kernels build one-hot selection matrices over a relaid value slab
// (W padded to 8 sublanes) and contract them on the MXU.  Here both are a
// direct gather on the natural [N, S, C] layout, as the reference CUDA im2col
// does.  Corners outside the level grid (zero padding, align_corners=False) or
// outside the image's real rectangle min(level size, real_hw) contribute
// zero and get no gradient, so the value needs no pre-mask pass.  floorf, not
// truncation, handles negative coordinates.
//
// What bounds them on an H100: bytes, read as scattered rows.  Each (image,
// query, head) reads L*P*4 rows of D contiguous channels (128 B in bf16 at
// D = 64); K6 also scatters as many rows of f32 value gradient.  An image's
// value map (5.2 MB in bf16 at 384x640) fits the 50 MB L2, the 668 MB of a
// b128 batch does not.  The design:
// - a group of G = D / MS_VEC lanes (16 at D = 64: a half warp) owns one
//   (image, query, head); each lane owns MS_VEC = 4 consecutive channels,
//   loaded as one vector (8 bytes in bf16, 16 in fp32) and, in K3, stored as
//   one;
// - each of the head's L*P taps is set up once: the group's lanes compute a
//   tap each (its pixel, floor, the four corners' row offsets, -1 where the
//   corner is invalid, and its four bilinear weights; K3 premultiplies them
//   by the attention weight) into shared memory, from where the tap loop
//   reads them as broadcasts;
// - the tap loop is unrolled by MS_UNROLL taps; an invalid corner's load is
//   skipped by a branch.  K3 compiles to few registers, so a full SM of
//   warps keeps the loads in flight; K6 holds more a lane and is held to
//   128 registers, two blocks an SM;
// - items are numbered (image, query, head), blocks take consecutive items,
//   so an image's queries run together and share its map in L2;
// - K6 scatters its value gradient with one vector f32 reduction a lane and
//   valid corner (atomicAdd on a float4, sm_90) into an f32 buffer, rounded
//   once by the wrapper, and forms each tap's d(attn), d(loc x), d(loc y) as
//   each lane's partial over its channels, summed over the group by
//   xor-shuffles in a fixed order.  The reductions are about half of K6's
//   time: each is a read-modify-write of 16 bytes in L2.
// So K3's output and K6's location and weight gradients are the same bit for
// bit from call to call; the value gradient is reproducible to f32 summation
// order only (the reductions' order is not fixed).
#include "common.cuh"

namespace grit {
namespace {

constexpr int MS_VEC = 4;        // channels a lane
constexpr int MS_THREADS = 256;  // threads a block: 256 / G groups
constexpr int MS_UNROLL = 4;     // taps whose corner loads are in flight together

// Normalized location -> pixel coordinate (align_corners=False).  The product
// is rounded before the subtraction, as the plain version's two operations
// do: contracted into one FMA, a coordinate within an ulp of an integer would
// fall into the neighbouring cell, where the value agrees but the location
// gradient (the slope of another cell) does not.
__device__ __forceinline__ float pixel(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

// One tap of one (image, query, head): the four corners' offsets in the
// image's value map (row * C; -1: outside the level or the real rectangle) in
// the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1), and the
// bilinear weights in the same order.
struct TapGeom {
  int4 off;
  float lx, ly;
};

__device__ __forceinline__ TapGeom tap_geom(const int* __restrict__ shapes,
                                            const int* __restrict__ real_hw, float locx,
                                            float locy, int n, int l, int L, int C) {
  const int H = shapes[3 * l], W = shapes[3 * l + 1], st = shapes[3 * l + 2];
  const int hmax = min(H, real_hw[(n * L + l) * 2]);
  const int wmax = min(W, real_hw[(n * L + l) * 2 + 1]);
  const float px = pixel(locx, W), py = pixel(locy, H);
  const float x0f = floorf(px), y0f = floorf(py);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const bool xa = x0 >= 0 && x0 < wmax, xb = x0 + 1 >= 0 && x0 + 1 < wmax;
  const bool ya = y0 >= 0 && y0 < hmax, yb = y0 + 1 >= 0 && y0 + 1 < hmax;
  TapGeom t;
  t.off.x = ya && xa ? (st + y0 * W + x0) * C : -1;
  t.off.y = ya && xb ? (st + y0 * W + x0 + 1) * C : -1;
  t.off.z = yb && xa ? (st + (y0 + 1) * W + x0) * C : -1;
  t.off.w = yb && xb ? (st + (y0 + 1) * W + x0 + 1) * C : -1;
  t.lx = px - x0f;
  t.ly = py - y0f;
  return t;
}

__device__ __forceinline__ float4 corner_weights(float lx, float ly) {
  return make_float4((1.0f - lx) * (1.0f - ly), lx * (1.0f - ly), (1.0f - lx) * ly, lx * ly);
}

__device__ __forceinline__ int corner(const int4& o, int k) {
  return k == 0 ? o.x : k == 1 ? o.y : k == 2 ? o.z : o.w;
}

__device__ __forceinline__ float corner(const float4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// bf16 pair (low half first) -> two floats, exactly.
__device__ __forceinline__ float2 bf2_to_f2(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// A lane's MS_VEC channels as one vector load / store.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (MS_VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  }
}

__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  if constexpr (MS_VEC == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = bf2_to_f2(a.x), hi = bf2_to_f2(a.y);
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    const float2 a = bf2_to_f2(__ldg(reinterpret_cast<const unsigned*>(p)));
    v[0] = a.x, v[1] = a.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (MS_VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (MS_VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
  } else {
    *reinterpret_cast<unsigned*>(p) = f2_to_bf2(v[0], v[1]);
  }
}

// A corner's MS_VEC channels, zero where the corner is invalid (o < 0).
template <typename T>
__device__ __forceinline__ void load_corner(const T* vb, int o, float* v) {
  if (o >= 0) {
    load_vec(vb + o, v);
  } else {
#pragma unroll
    for (int c = 0; c < MS_VEC; ++c) v[c] = 0.0f;
  }
}

// The value gradient's scatter: one vector f32 reduction (red.global.add.v4.f32).
__device__ __forceinline__ void red_vec(float* p, const float* v) {
  if constexpr (MS_VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
}

// K3's tap: corner offsets and weights times the attention weight.
struct FwdTap {
  int4 off;
  float4 w;
};

// K6's tap: corner offsets, the bilinear weights, and (lx, ly, attention
// weight, unused).
struct BwdTap {
  int4 off;
  float4 w;
  float4 e;
};

// Taps in shared memory: a group's L*P rounded up to MS_UNROLL (the rest
// invalid).
__host__ __device__ __forceinline__ int padded_taps(int LP) {
  return (LP + MS_UNROLL - 1) / MS_UNROLL * MS_UNROLL;
}

template <typename T, int G>
__global__ void __launch_bounds__(MS_THREADS) msda_kernel(
    const T* __restrict__ value, const int* __restrict__ shapes, const float* __restrict__ loc,
    const float* __restrict__ attw, const int* __restrict__ real_hw, T* __restrict__ out, int S,
    int Lq, int M, int L, int P, int items) {
  extern __shared__ float4 ms_smem[];
  constexpr int GROUPS = MS_THREADS / G;
  const int D = G * MS_VEC, C = M * D, LP = L * P, LPp = padded_taps(LP);
  const int lane = threadIdx.x % G;
  const int item = blockIdx.x * GROUPS + threadIdx.x / G;  // (n * Lq + q) * M + m
  const int nq = item / M, m = item - nq * M, n = nq / Lq;
  FwdTap* taps = reinterpret_cast<FwdTap*>(ms_smem) + (threadIdx.x / G) * LPp;
  if (item < items) {
    for (int t = lane; t < LPp; t += G) {
      FwdTap tp{make_int4(-1, -1, -1, -1), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
      if (t < LP) {
        const float* lp = loc + ((size_t)item * LP + t) * 2;
        const TapGeom geo = tap_geom(shapes, real_hw, lp[0], lp[1], n, t / P, L, C);
        const float a = attw[(size_t)item * LP + t];
        const float4 w = corner_weights(geo.lx, geo.ly);
        tp.off = geo.off;
        tp.w = make_float4(w.x * a, w.y * a, w.z * a, w.w * a);
      }
      taps[t] = tp;
    }
  }
  __syncwarp();
  if (item >= items) return;
  const T* vb = value + (size_t)n * S * C + m * D + lane * MS_VEC;
  float acc[MS_VEC];
#pragma unroll
  for (int c = 0; c < MS_VEC; ++c) acc[c] = 0.0f;
  for (int t0 = 0; t0 < LPp; t0 += MS_UNROLL) {
    FwdTap tp[MS_UNROLL];
    float v[MS_UNROLL][4][MS_VEC];
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u) {
      tp[u] = taps[t0 + u];
#pragma unroll
      for (int k = 0; k < 4; ++k) load_corner(vb, corner(tp[u].off, k), v[u][k]);
    }
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < MS_VEC; ++c) acc[c] = fmaf(corner(tp[u].w, k), v[u][k][c], acc[c]);
  }
  store_vec(out + (size_t)nq * C + m * D + lane * MS_VEC, acc);
}

template <typename T, int G>
__global__ void __launch_bounds__(MS_THREADS, 2) msda_bwd_kernel(
    const T* __restrict__ value, const int* __restrict__ shapes, const float* __restrict__ loc,
    const float* __restrict__ attw, const int* __restrict__ real_hw, const T* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dloc, float* __restrict__ dattw, int S,
    int Lq, int M, int L, int P, int items) {
  extern __shared__ float4 ms_smem[];
  constexpr int GROUPS = MS_THREADS / G;
  const int D = G * MS_VEC, C = M * D, LP = L * P, LPp = padded_taps(LP);
  const int lane = threadIdx.x % G;
  const int item = blockIdx.x * GROUPS + threadIdx.x / G;  // (n * Lq + q) * M + m
  // a group past the last item runs the loop on invalid taps (every lane of a
  // warp takes part in the shuffles) and loads and stores nothing
  const bool live = item < items;
  const int nq = item / M, m = item - nq * M, n = nq / Lq;
  BwdTap* taps = reinterpret_cast<BwdTap*>(ms_smem) + (threadIdx.x / G) * LPp;
  for (int t = lane; t < LPp; t += G) {
    BwdTap tp{make_int4(-1, -1, -1, -1), make_float4(0.0f, 0.0f, 0.0f, 0.0f),
              make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (live && t < LP) {
      const float* lp = loc + ((size_t)item * LP + t) * 2;
      const TapGeom geo = tap_geom(shapes, real_hw, lp[0], lp[1], n, t / P, L, C);
      tp.off = geo.off;
      tp.w = corner_weights(geo.lx, geo.ly);
      tp.e = make_float4(geo.lx, geo.ly, attw[(size_t)item * LP + t], 0.0f);
    }
    taps[t] = tp;
  }
  __syncwarp();
  float g[MS_VEC];
  if (live) {
    load_vec(dout + (size_t)nq * C + m * D + lane * MS_VEC, g);
  } else {
#pragma unroll
    for (int c = 0; c < MS_VEC; ++c) g[c] = 0.0f;
  }
  const T* vb = value + (size_t)n * S * C + m * D + lane * MS_VEC;
  float* db = dvalue + (size_t)n * S * C + m * D + lane * MS_VEC;
  for (int t0 = 0; t0 < LPp; t0 += MS_UNROLL) {
    BwdTap tp[MS_UNROLL];
    float v[MS_UNROLL][4][MS_VEC];
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u) {
      tp[u] = taps[t0 + u];
#pragma unroll
      for (int k = 0; k < 4; ++k) load_corner(vb, corner(tp[u].off, k), v[u][k]);
    }
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u) {
      const float lx = tp[u].e.x, ly = tp[u].e.y, a = tp[u].e.z;
      // d(value) at each valid corner: dOut * attention weight * corner weight
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = corner(tp[u].off, k);
        if (o >= 0) {
          const float wa = corner(tp[u].w, k) * a;
          float d[MS_VEC];
#pragma unroll
          for (int c = 0; c < MS_VEC; ++c) d[c] = g[c] * wa;
          red_vec(db + o, d);
        }
      }
      // this lane's share of d(attn) and of the two location slopes
      float r[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < MS_VEC; ++c) {
        const float v00 = v[u][0][c], v10 = v[u][1][c], v01 = v[u][2][c], v11 = v[u][3][c];
        r[0] = fmaf(g[c], tp[u].w.x * v00 + tp[u].w.y * v10 + tp[u].w.z * v01 + tp[u].w.w * v11,
                    r[0]);
        r[1] = fmaf(g[c], (1.0f - ly) * (v10 - v00) + ly * (v11 - v01), r[1]);
        r[2] = fmaf(g[c], (1.0f - lx) * (v01 - v00) + lx * (v11 - v10), r[2]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) r[k] += __shfl_xor_sync(0xffffffffu, r[k], o);
      const int t = t0 + u;
      if (live && t < LP && lane == t % G) {
        const int l = t / P;
        const size_t q = (size_t)item * LP + t;
        dattw[q] = r[0];
        dloc[q * 2] = r[1] * a * (float)shapes[3 * l + 1];
        dloc[q * 2 + 1] = r[2] * a * (float)shapes[3 * l];
      }
    }
  }
}

template <int G>
int launch_msda(int dtype, const void* value, const int* sh, const float* lp, const float* ap,
                const int* rh, void* out, int N, int S, int Lq, int M, int L, int P,
                cudaStream_t st) {
  const int items = N * Lq * M, groups = MS_THREADS / G;
  const int blocks = (items + groups - 1) / groups;
  const size_t smem = (size_t)groups * padded_taps(L * P) * sizeof(FwdTap);
  if (dtype == 1) {
    msda_kernel<bf16, G><<<blocks, MS_THREADS, smem, st>>>(
        static_cast<const bf16*>(value), sh, lp, ap, rh, static_cast<bf16*>(out), S, Lq, M, L, P,
        items);
  } else {
    msda_kernel<float, G><<<blocks, MS_THREADS, smem, st>>>(
        static_cast<const float*>(value), sh, lp, ap, rh, static_cast<float*>(out), S, Lq, M, L,
        P, items);
  }
  return (int)cudaGetLastError();
}

template <int G>
int launch_msda_bwd(int dtype, const void* value, const int* sh, const float* lp, const float* ap,
                    const int* rh, const void* dout, float* dv, float* dl, float* da, int N,
                    int S, int Lq, int M, int L, int P, cudaStream_t st) {
  const int items = N * Lq * M, groups = MS_THREADS / G;
  const int blocks = (items + groups - 1) / groups;
  const size_t smem = (size_t)groups * padded_taps(L * P) * sizeof(BwdTap);
  if (dtype == 1) {
    msda_bwd_kernel<bf16, G><<<blocks, MS_THREADS, smem, st>>>(
        static_cast<const bf16*>(value), sh, lp, ap, rh, static_cast<const bf16*>(dout), dv, dl,
        da, S, Lq, M, L, P, items);
  } else {
    msda_bwd_kernel<float, G><<<blocks, MS_THREADS, smem, st>>>(
        static_cast<const float*>(value), sh, lp, ap, rh, static_cast<const float*>(dout), dv, dl,
        da, S, Lq, M, L, P, items);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace grit

using namespace grit;

extern "C" {

// value [N, S, M*D]; shapes int32 [L, 3] = (H, W, level start); loc f32
// [N, Lq, M, L, P, 2]; attw f32 [N, Lq, M, L, P]; real_hw int32 [N, L, 2];
// out [N, Lq, M*D].  D / MS_VEC lanes a head: 8, 16 or 32; L * P <= 32;
// S * M * D < 2^31; 16-byte aligned tensors (checked by the caller,
// ops/msda.py::check_msda_shape).
int grit_msda(const void* value, const void* shapes, const void* loc, const void* attw,
              const void* real_hw, void* out, int N, int S, int Lq, int M, int D, int L, int P,
              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sh = static_cast<const int*>(shapes);
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(attw);
  const int* rh = static_cast<const int*>(real_hw);
  switch (D / MS_VEC) {
    case 8: return launch_msda<8>(dtype, value, sh, lp, ap, rh, out, N, S, Lq, M, L, P, st);
    case 16: return launch_msda<16>(dtype, value, sh, lp, ap, rh, out, N, S, Lq, M, L, P, st);
    case 32: return launch_msda<32>(dtype, value, sh, lp, ap, rh, out, N, S, Lq, M, L, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6: dout [N, Lq, M*D]; dvalue f32 [N, S, M*D], zeroed by the caller; dloc f32
// [N, Lq, M, L, P, 2]; dattw f32 [N, Lq, M, L, P].  The same shapes as K3.
int grit_msda_bwd(const void* value, const void* shapes, const void* loc, const void* attw,
                  const void* real_hw, const void* dout, void* dvalue, void* dloc, void* dattw,
                  int N, int S, int Lq, int M, int D, int L, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sh = static_cast<const int*>(shapes);
  const float* lp = static_cast<const float*>(loc);
  const float* ap = static_cast<const float*>(attw);
  const int* rh = static_cast<const int*>(real_hw);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattw);
  switch (D / MS_VEC) {
    case 8:
      return launch_msda_bwd<8>(dtype, value, sh, lp, ap, rh, dout, dv, dl, da, N, S, Lq, M, L,
                                P, st);
    case 16:
      return launch_msda_bwd<16>(dtype, value, sh, lp, ap, rh, dout, dv, dl, da, N, S, Lq, M, L,
                                 P, st);
    case 32:
      return launch_msda_bwd<32>(dtype, value, sh, lp, ap, rh, dout, dv, dl, da, N, S, Lq, M, L,
                                 P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
