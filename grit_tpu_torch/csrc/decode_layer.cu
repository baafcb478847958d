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
// a fixed chain of eight launches on the caller's stream, each product
// splitting its OUTPUT COLUMNS across blocks (tiles of 64 rows x 16 columns)
// so that the weight read is spread over the SMs and each weight is read from
// device memory once (the row tiles of a large batch find it in L2):
//   1. q = (x Wq + bq) / sqrt(d) for both attentions        [R, 2D]
//   2. attention core, one block per (image, attention, head): the image's
//      `fold` query rows against its T keys, scores and probabilities in
//      shared memory                                          [R, 2D]
//   3. pre_i = x + o_i Wo_i + bo_i                             f32 [2, R, D]
//   4. enc_i = LN_i(pre_i) * pad                               f32 [2, R, D]
//   5. enc = (enc_1 s(x Ws_1 + enc_1 We_1 + b_1)
//             + enc_2 s(x Ws_2 + enc_2 We_2 + b_2)) / sqrt(2) * pad
//   6. h = relu(enc W1 + b1)                                   [R, F]
//   7. pre = enc + h W2 + b2                                   f32 [R, D]
//   8. out = LN_f(pre) * pad                                   [R, D]
// The products run on tensor cores in bf16 (WMMA 16x16x16, f32 accumulate) and
// as SIMT FMA in fp32 (the parity path).  Intermediates go through device
// memory (they stay in L2: 0.6 MB at 40 rows); one cooperative launch that
// keeps them on chip is later work.
#include <mma.h>

#include "common.cuh"

namespace grit {

namespace wm = nvcuda::wmma;

constexpr int DT_M = 64, DT_N = 16, DT_THREADS = 128, DT_CLD = DT_N + 4;
constexpr float DT_NEG = -1e30f;  // additive mask: exp underflows to exactly 0

// One operand pair of a product: A [R, K] rows (leading dimension lda, stored
// as T or, for an f32 intermediate, rounded to T on load) times W [N, K] in
// torch's Linear layout (leading dimension ldw).
struct Operand {
  const void* a;
  int lda;
  int a_f32;
  const void* w;
  int ldw;
};

template <typename T>
__device__ __forceinline__ T load_a(const Operand& op, size_t idx) {
  return op.a_f32 ? from_f<T>(static_cast<const float*>(op.a)[idx])
                  : static_cast<const T*>(op.a)[idx];
}

// Accumulates a 64 x 16 output tile over K and leaves it in shared memory as
// f32 [DT_M][DT_CLD].
template <typename T> struct Tile;

template <> struct Tile<bf16> {
  static constexpr int TK = 64, LD = TK + 8;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
  __device__ void zero() { wm::fill_fragment(acc, 0.0f); }
  // As: [DT_M][LD], Ws: [DT_N][LD]
  __device__ void mma(const Operand& op, int K, int row0, int R, int col0, bf16* As, bf16* Ws) {
    const int tid = threadIdx.x, warp = tid >> 5;
    const bf16* W = static_cast<const bf16*>(op.w);
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int idx = tid; idx < DT_M * TK; idx += DT_THREADS) {
        const int r = idx / TK, kk = idx - r * TK;
        As[r * LD + kk] = row0 + r < R
                              ? load_a<bf16>(op, (size_t)(row0 + r) * op.lda + k0 + kk)
                              : __float2bfloat16(0.0f);
      }
      for (int idx = tid; idx < DT_N * TK; idx += DT_THREADS) {
        const int c = idx / TK, kk = idx - c * TK;
        Ws[c * LD + kk] = W[(size_t)(col0 + c) * op.ldw + k0 + kk];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
        wm::load_matrix_sync(a, As + warp * 16 * LD + kk, LD);
        wm::load_matrix_sync(b, Ws + kk, LD);
        wm::mma_sync(acc, a, b, acc);
      }
      __syncthreads();
    }
  }
  __device__ void store(float* Cs) {
    wm::store_matrix_sync(Cs + (threadIdx.x >> 5) * 16 * DT_CLD, acc, DT_CLD, wm::mem_row_major);
  }
};

template <> struct Tile<float> {
  static constexpr int TK = 32, LD = TK + 1;
  float acc[8];   // rows ty + 8 i, column tx
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  }
  __device__ void mma(const Operand& op, int K, int row0, int R, int col0, float* As, float* Ws) {
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const float* A = static_cast<const float*>(op.a);
    const float* W = static_cast<const float*>(op.w);
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int idx = tid; idx < DT_M * TK; idx += DT_THREADS) {
        const int r = idx / TK, kk = idx - r * TK;
        As[r * LD + kk] = row0 + r < R ? A[(size_t)(row0 + r) * op.lda + k0 + kk] : 0.0f;
      }
      for (int idx = tid; idx < DT_N * TK; idx += DT_THREADS) {
        const int c = idx / TK, kk = idx - c * TK;
        Ws[c * LD + kk] = W[(size_t)(col0 + c) * op.ldw + k0 + kk];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float b = Ws[tx * LD + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(As[(ty + 8 * i) * LD + kk], b, acc[i]);
      }
      __syncthreads();
    }
  }
  __device__ void store(float* Cs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) Cs[(ty + 8 * i) * DT_CLD + tx] = acc[i];
  }
};

template <typename T> struct Staging {
  T As[DT_M * Tile<T>::LD];
  T Ws[DT_N * Tile<T>::LD];
};

// 1. q projections: blockIdx.z picks the attention.  q [R, 2D].
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_qproj_kernel(
    const T* __restrict__ x, const T* wq1, const T* bq1, const T* wq2, const T* bq2,
    T* __restrict__ q, int R, int D, float scale) {
  __shared__ __align__(32) unsigned char st_raw[sizeof(Staging<T>)];
  Staging<T>& st = *reinterpret_cast<Staging<T>*>(st_raw);
  __shared__ __align__(32) float Cs[DT_M * DT_CLD];
  const int z = blockIdx.z, col0 = blockIdx.x * DT_N, row0 = blockIdx.y * DT_M;
  const T* bias = z ? bq2 : bq1;
  Tile<T> t;
  t.zero();
  t.mma(Operand{x, D, 0, z ? wq2 : wq1, D}, D, row0, R, col0, st.As, st.Ws);
  t.store(Cs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < DT_M * DT_N; idx += DT_THREADS) {
    const int r = idx / DT_N, c = idx - r * DT_N, row = row0 + r;
    if (row < R)
      q[(size_t)row * 2 * D + z * D + col0 + c] =
          from_f<T>((Cs[r * DT_CLD + c] + to_f<T>(bias[col0 + c])) * scale);
  }
}

// 2. attention core.  grid (B, 2, H); dynamic shared memory: fold x d query
// values, then fold x T scores / probabilities.
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k1, const T* __restrict__ v1,
    const unsigned char* __restrict__ m1, const T* __restrict__ k2, const T* __restrict__ v2,
    const unsigned char* __restrict__ m2, T* __restrict__ o, int fold, int T1, int T2, int D,
    int H) {
  extern __shared__ float dsm[];
  const int b = blockIdx.x, a = blockIdx.y, h = blockIdx.z;
  const int d = D / H, Tk = a ? T2 : T1;
  const T* kk = (a ? k2 : k1) + (size_t)b * Tk * D + h * d;
  const T* vv = (a ? v2 : v1) + (size_t)b * Tk * D + h * d;
  const unsigned char* mask = a ? m2 : m1;
  float* qs = dsm;             // fold x d
  float* s = dsm + fold * d;   // fold x Tk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int idx = tid; idx < fold * d; idx += DT_THREADS) {
    const int i = idx / d, dd = idx - i * d;
    qs[idx] = to_f<T>(q[(size_t)(b * fold + i) * 2 * D + a * D + h * d + dd]);
  }
  __syncthreads();
  // scores: one warp per key, the lanes over the head's channels
  for (int j = warp; j < Tk; j += DT_THREADS / 32) {
    const float madd = (mask != nullptr && mask[(size_t)b * Tk + j]) ? DT_NEG : 0.0f;
    for (int i = 0; i < fold; ++i) {
      float acc = 0.0f;
      for (int dd = lane; dd < d; dd += 32)
        acc = fmaf(qs[i * d + dd], to_f<T>(kk[(size_t)j * D + dd]), acc);
      acc = warp_sum(acc);
      if (lane == 0) s[i * Tk + j] = acc + madd;
    }
  }
  __syncthreads();
  // softmax: one warp per query row; probabilities rounded to the compute type
  for (int i = warp; i < fold; i += DT_THREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < Tk; j += 32) mx = fmaxf(mx, s[i * Tk + j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(s[i * Tk + j] - mx);
      s[i * Tk + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Tk; j += 32) s[i * Tk + j] = to_f<T>(from_f<T>(s[i * Tk + j] / sum));
  }
  __syncthreads();
  // o = P V: one thread per (query row, channel)
  for (int idx = tid; idx < fold * d; idx += DT_THREADS) {
    const int i = idx / d, dd = idx - i * d;
    float acc = 0.0f;
    for (int j = 0; j < Tk; ++j) acc = fmaf(s[i * Tk + j], to_f<T>(vv[(size_t)j * D + dd]), acc);
    o[(size_t)(b * fold + i) * 2 * D + a * D + h * d + dd] = from_f<T>(acc);
  }
}

// 3. out projections with the residual: pre[z] = x + o_z Wo_z + bo_z (f32).
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_oproj_kernel(
    const T* __restrict__ o, const T* __restrict__ x, const T* wo1, const T* bo1, const T* wo2,
    const T* bo2, float* __restrict__ pre, int R, int D) {
  __shared__ __align__(32) unsigned char st_raw[sizeof(Staging<T>)];
  Staging<T>& st = *reinterpret_cast<Staging<T>*>(st_raw);
  __shared__ __align__(32) float Cs[DT_M * DT_CLD];
  const int z = blockIdx.z, col0 = blockIdx.x * DT_N, row0 = blockIdx.y * DT_M;
  const T* bias = z ? bo2 : bo1;
  Tile<T> t;
  t.zero();
  t.mma(Operand{o + z * D, 2 * D, 0, z ? wo2 : wo1, D}, D, row0, R, col0, st.As, st.Ws);
  t.store(Cs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < DT_M * DT_N; idx += DT_THREADS) {
    const int r = idx / DT_N, c = idx - r * DT_N, row = row0 + r, col = col0 + c;
    if (row < R)
      pre[((size_t)z * R + row) * D + col] =
          to_f<T>(x[(size_t)row * D + col]) + (Cs[r * DT_CLD + c] + to_f<T>(bias[col]));
  }
}

// 4 and 8. LayerNorm of f32 rows times pad, one warp per row; blockIdx.y
// picks the problem.  Writes f32 (out_f) or the output type (out_t).
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
    else out_t[(size_t)row * D + c] = from_f<T>(v);
  }
}

// 5. both gates and the fused sum.  enc: f32 [2, R, D]; ws/we: [D, K = D]
// with leading dimension ldg (the two halves of one [D, 2D] Linear weight).
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_gate_kernel(
    const T* __restrict__ x, const float* __restrict__ enc, const T* wsa, const T* wea,
    const T* ba, const T* wsb, const T* web, const T* bb, const T* __restrict__ pad,
    float* __restrict__ encf, int R, int D, int ldg) {
  __shared__ __align__(32) unsigned char st_raw[sizeof(Staging<T>)];
  Staging<T>& st = *reinterpret_cast<Staging<T>*>(st_raw);
  __shared__ __align__(32) float Cs[2][DT_M * DT_CLD];
  const int col0 = blockIdx.x * DT_N, row0 = blockIdx.y * DT_M;
  for (int z = 0; z < 2; ++z) {
    Tile<T> t;
    t.zero();
    t.mma(Operand{x, D, 0, z ? wsb : wsa, ldg}, D, row0, R, col0, st.As, st.Ws);
    t.mma(Operand{enc + (size_t)z * R * D, D, 1, z ? web : wea, ldg}, D, row0, R, col0, st.As,
          st.Ws);
    t.store(Cs[z]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < DT_M * DT_N; idx += DT_THREADS) {
    const int r = idx / DT_N, c = idx - r * DT_N, row = row0 + r, col = col0 + c;
    if (row >= R) continue;
    const float a1 = 1.0f / (1.0f + expf(-(Cs[0][r * DT_CLD + c] + to_f<T>(ba[col]))));
    const float a2 = 1.0f / (1.0f + expf(-(Cs[1][r * DT_CLD + c] + to_f<T>(bb[col]))));
    const float e1 = enc[(size_t)row * D + col], e2 = enc[((size_t)R + row) * D + col];
    encf[(size_t)row * D + col] =
        (e1 * a1 + e2 * a2) * 0.70710678118654752440f * to_f<T>(pad[row]);
  }
}

// 6. h = relu(enc W1 + b1), rounded to the compute type.
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_fc1_kernel(
    const float* __restrict__ encf, const T* w1, const T* b1, T* __restrict__ hbuf, int R, int D,
    int F) {
  __shared__ __align__(32) unsigned char st_raw[sizeof(Staging<T>)];
  Staging<T>& st = *reinterpret_cast<Staging<T>*>(st_raw);
  __shared__ __align__(32) float Cs[DT_M * DT_CLD];
  const int col0 = blockIdx.x * DT_N, row0 = blockIdx.y * DT_M;
  Tile<T> t;
  t.zero();
  t.mma(Operand{encf, D, 1, w1, D}, D, row0, R, col0, st.As, st.Ws);
  t.store(Cs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < DT_M * DT_N; idx += DT_THREADS) {
    const int r = idx / DT_N, c = idx - r * DT_N, row = row0 + r, col = col0 + c;
    if (row < R)
      hbuf[(size_t)row * F + col] =
          from_f<T>(fmaxf(Cs[r * DT_CLD + c] + to_f<T>(b1[col]), 0.0f));
  }
}

// 7. pre = enc + h W2 + b2 (f32).
template <typename T>
__global__ void __launch_bounds__(DT_THREADS) dt_fc2_kernel(
    const T* __restrict__ hbuf, const float* __restrict__ encf, const T* w2, const T* b2,
    float* __restrict__ pre, int R, int D, int F) {
  __shared__ __align__(32) unsigned char st_raw[sizeof(Staging<T>)];
  Staging<T>& st = *reinterpret_cast<Staging<T>*>(st_raw);
  __shared__ __align__(32) float Cs[DT_M * DT_CLD];
  const int col0 = blockIdx.x * DT_N, row0 = blockIdx.y * DT_M;
  Tile<T> t;
  t.zero();
  t.mma(Operand{hbuf, F, 0, w2, F}, F, row0, R, col0, st.As, st.Ws);
  t.store(Cs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < DT_M * DT_N; idx += DT_THREADS) {
    const int r = idx / DT_N, c = idx - r * DT_N, row = row0 + r, col = col0 + c;
    if (row < R)
      pre[(size_t)row * D + col] =
          encf[(size_t)row * D + col] + (Cs[r * DT_CLD + c] + to_f<T>(b2[col]));
  }
}

// weights: the 24 pointers in grit_tpu/ops/decode_layer.py::_ref's order
template <typename T>
int decode_tail(const void* x_, const void* k1, const void* v1, const void* m1, const void* k2,
                const void* v2, const void* m2, const void* pad_, void* out,
                const void* const* w, float* sf, void* st_, int R, int B, int fold, int T1,
                int T2, int D, int F, int H, int ldg, float eps, cudaStream_t stream) {
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
  const int rt = (R + DT_M - 1) / DT_M, lr = (R + DT_THREADS / 32 - 1) / (DT_THREADS / 32);
  const int d = D / H, tmax = T1 > T2 ? T1 : T2;
  const size_t attn_smem = (size_t)fold * (d + tmax) * sizeof(float);
  if (attn_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);

  dt_qproj_kernel<T><<<dim3(D / DT_N, rt, 2), DT_THREADS, 0, stream>>>(
      x, wt(0), wt(1), wt(6), wt(7), q, R, D, 1.0f / sqrtf((float)d));
  dt_attn_kernel<T><<<dim3(B, 2, H), DT_THREADS, attn_smem, stream>>>(
      q, static_cast<const T*>(k1), static_cast<const T*>(v1),
      static_cast<const unsigned char*>(m1), static_cast<const T*>(k2),
      static_cast<const T*>(v2), static_cast<const unsigned char*>(m2), o, fold, T1, T2, D, H);
  dt_oproj_kernel<T><<<dim3(D / DT_N, rt, 2), DT_THREADS, 0, stream>>>(
      o, x, wt(2), wt(3), wt(8), wt(9), pre, R, D);
  dt_ln_kernel<T><<<dim3(lr, 2), DT_THREADS, 0, stream>>>(
      pre, wf(4), wf(5), wf(10), wf(11), pad, enc, nullptr, R, D, eps);
  dt_gate_kernel<T><<<dim3(D / DT_N, rt), DT_THREADS, 0, stream>>>(
      x, enc, wt(12), wt(13), wt(14), wt(15), wt(16), wt(17), pad, encf, R, D, ldg);
  dt_fc1_kernel<T><<<dim3(F / DT_N, rt), DT_THREADS, 0, stream>>>(
      encf, wt(18), wt(19), hbuf, R, D, F);
  dt_fc2_kernel<T><<<dim3(D / DT_N, rt), DT_THREADS, 0, stream>>>(
      hbuf, encf, wt(20), wt(21), pre, R, D, F);
  dt_ln_kernel<T><<<dim3(lr, 1), DT_THREADS, 0, stream>>>(
      pre, wf(22), wf(23), wf(22), wf(23), pad, nullptr, static_cast<T*>(out), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grit

// x [R, D], k_i / v_i [B, T_i, D], m_i uint8 [B, T_i] (non-zero = masked) or
// null, pad [R], out [R, D]; w: host array of the 24 weight pointers (matrices
// as [N, K] rows: q, o and FFN matrices with leading dimension K, the four gate
// matrices with ldg); sf: f32 scratch [5, R, D]; st: scratch of the compute
// type [R, 4D + F].  D and F are multiples of 64, R = B * fold.
extern "C" int grit_decode_tail(const void* x, const void* k1, const void* v1, const void* m1,
                                const void* k2, const void* v2, const void* m2,
                                const void* pad, void* out, const void* const* w, void* sf,
                                void* st, int R, int B, int fold, int T1, int T2, int D, int F,
                                int H, int ldg, float eps, int dtype, void* stream) {
  using namespace grit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(sf);
  if (dtype == 0)
    return decode_tail<float>(x, k1, v1, m1, k2, v2, m2, pad, out, w, f, st, R, B, fold, T1, T2,
                              D, F, H, ldg, eps, s);
  return decode_tail<bf16>(x, k1, v1, m1, k2, v2, m2, pad, out, w, f, st, R, B, fold, T1, T2, D,
                           F, H, ldg, eps, s);
}
