// The fp32 window-attention core and its backward (K5 in fp32) on the CUDA
// cores: SIMT FMA register micro-tiles (no TF32: the fp32 parity runs compare
// with the plain path in full f32).
//
// The core serves the fp32 attention of K1 and K4 (grit_window_attn: q
// stored pre-scaled, the relative-position table and the shifted-window
// regions) and K8's fp32 forward (grit_window_attn_dense: q scaled at the
// load, a dense f32 bias): softmax(q k^T + bias) v inside
// grit_tpu/ops/window_attention.py::_band_kernel, ::_block_kernel and
// ::_kernel.  The backward serves K5 (grit_window_attn_bwd) and K8's fp32
// backward (grit_window_attn_dense_bwd): ::_bwd_kernel.  Both are entered
// through swin_block.cu's entry points; bf16 runs on window_attn_mma.cu and
// win_attn_bwd_mma.cu, whose layouts these mirror.
//
// What bounds them on an H100: operations, 4 N^2 d flops a (window, head,
// image) forward and 10 N^2 d backward at 67 TFLOP/s (f32 outside the tensor
// cores); their bytes take about a third of that time.  The kernels they
// replace ran one query row a warp: a lane scored keys lane + 32 t, so every
// FMA of Q K^T read two 4-byte shared words (q broadcast, k at stride 33), as
// did every FMA of P V and of the backward's five passes; the shared-memory
// pipe, not the FMA pipe, set their pace (0.5 FMAs a word read), each score
// read its bias from the table in global memory and each probability paid an
// IEEE division.  The backward also looped over the whole batch in one block
// per (window, head), so a stage of few windows and heads (2 x 32 at the b16
// XE step's stage 4) ran 64 blocks on 132 SMs.  Here:
// - a block holds one (window, head): in fp32 a head's q, k, v (and dO) rows
//   are already 128 contiguous bytes; they arrive by 16-byte loads into rows
//   of 34 floats (so that a half-warp's 8-byte reads of 16 rows hit 32
//   distinct banks); tokens are padded to whole 16-row strips, zero rows,
//   their keys masked to -inf;
// - the head's column of the table and one word a key (its table offset and
//   shifted-window region) sit in shared memory, as in window_attn_mma.cu:
//   no score reads global memory for its bias (K8's dense row excepted, read
//   in 64-byte coalesced segments);
// - query strips: a warp owns 16 queries; S = Q K^T (16 x NP) lives in
//   registers, a lane holding 8 queries x NS keys (keys kg + 16 t of the
//   half-warp kg = lane % 16): each 2-deep step of d reads 8 float2 of q and
//   NS float2 of k for 16 NS FMAs, 4.2 FMAs a 4-byte word (72 score registers
//   at N = 144); the backward's dP = dO V^T is the same tile;
// - bias and the -100 region mask as the plain version adds them; the exact
//   row max and sum by four xor shuffles within the half-warp (no online
//   softmax); expf and one IEEE reciprocal a row, multiplied into each
//   probability;
// - the products with a 32-wide output (O = P V, dQ, dV, dK) are a second
//   micro-tile of 4 rows x 4 head dims a lane, one float4 of the N x N
//   operand and two float2 of the row operand a step of the sum, stored as
//   16-byte coalesced rows.  The forward stages P through a per-warp
//   transposed strip of TC 16-key blocks at a time (shared memory for two
//   blocks an SM at N = 144);
// - the backward: grid (window of the image, head, batch chunk), the chunks
//   chosen by the wrapper (ops/window_attention.py::bwd_batch_chunks) for
//   about two waves of blocks; a block walks its chunk's images in order.
//   Per image: q (times qscale), k, v and dO rows (f32, 4 x 18 KB at N =
//   144) and one N x N f32 tile (83 KB), one block an SM: P into the tile;
//   dV = P^T dO over key strips; dP in registers, rowsum(dP P) from the
//   strip's own rows of P, which dS = P (dP - rowsum) then overwrites;
//   dQ = scale dS K; dK = dS^T Q over key strips, while the block adds the
//   image's dS into its own [chunk, window, head] slice of the partial bias
//   gradient (16-byte read-modify-writes, no atomics; the wrapper sums the
//   chunks in a fixed order, so the table gradient is the same bit for bit
//   from call to call).
// The strip count is a template argument: the core takes 4, 9 or 16 strips
// (N <= 64, 144, 256), as the bf16 core; the backward 4 or 9 (N <= 144).  N
// may be odd (window 7: N = 49): the backward's bias-gradient rows are
// padded to LDB(N) = N rounded up to a multiple of 4 floats, so that its
// 16-byte read-modify-writes stay aligned and inside the row; the pad columns
// take the masked keys' dS, which is 0, and the wrapper reads the real N
// columns.  An even window has N % 4 == 0 and no pad; K8's dense bias keeps
// N % 4 == 0.
#include "common.cuh"

namespace grit {
namespace {

constexpr int HD = 32;        // head dim
constexpr int LDQ = HD + 2;   // q, k, v and dO rows in shared memory
constexpr int TC = 3;         // 16-key blocks of P the core stages at a time
constexpr int LDPT = 20;      // a key's row of the core's transposed P strip: 16 queries + 4
constexpr int LDM_PAD = 4;    // the backward's N x N tile: rows of NP + 4 floats

// the row stride of the bias gradient [chunks, nW, heads, N, LDB(N)] (floats)
__host__ __device__ constexpr int ldb_of(int n) { return (n + 3) & ~3; }

template <int NS>
constexpr size_t core_smem_bytes(int tw2) {
  return ((size_t)16 * NS * 3 * LDQ + (size_t)NS * 16 * TC * LDPT + 16 * NS + tw2) * 4;
}

template <int NS>
constexpr size_t bwd_smem_bytes(int tw2) {
  return ((size_t)16 * NS * 4 * LDQ + (size_t)16 * NS * (16 * NS + LDM_PAD) + 16 * NS + tw2) * 4;
}

// Per key j < NP: kinfo[j] = its offset in the table (jy (2w-1) + jx) | its
// shifted-window region << 16, -1 beyond N (DENSE: 0 or -1); tab = the head's
// table column.  w: the window's index within its image.
template <int NP, bool DENSE>
__device__ __forceinline__ void key_info(int* kinfo, float* tab, const float* __restrict__ table,
                                         const WinMap& m, int w, int h, int heads, int tid,
                                         int nthreads) {
  const int win = m.win, n = win * win, tw = 2 * win - 1;
  if (DENSE) {
    for (int j = tid; j < NP; j += nthreads) kinfo[j] = j < n ? 0 : -1;
    return;
  }
  // shifted-window regions on the rolled padded grid: rows [0, Hp - w),
  // [Hp - w, Hp - s), [Hp - s, Hp) and likewise for columns
  const int nwx = m.Wp / win, wy = w / nwx, wx = w - wy * nwx;
  for (int j = tid; j < NP; j += nthreads) {
    int info = -1;
    if (j < n) {
      const int jy = j / win, jx = j - jy * win;
      int reg = 0;
      if (m.shift > 0) {
        const int ry = wy * win + jy, rx = wx * win + jx;
        const int gy = ry < m.Hp - win ? 0 : (ry < m.Hp - m.shift ? 1 : 2);
        const int gx = rx < m.Wp - win ? 0 : (rx < m.Wp - m.shift ? 1 : 2);
        reg = gy * 3 + gx;
      }
      info = (jy * tw + jx) | (reg << 16);
    }
    kinfo[j] = info;
  }
  for (int r = tid; r < tw * tw; r += nthreads) tab[r] = table[(size_t)r * heads + h];
}

// `count` tensors' rows of one (window, head) into shared memory rows of LDQ
// floats, 16 bytes a thread, zeros beyond N: tensor t's row j from
// src[t] + (row0 + j) * stride[t] + h * HD; tensor 0 scaled by qscale
template <int NP>
__device__ __forceinline__ void load_rows(float* dst, const float* const* src,
                                         const size_t* stride, int count, size_t row0, int n,
                                         int h, float qscale, int tid, int nthreads) {
  for (int idx = tid; idx < count * NP * 8; idx += nthreads) {
    const int t = idx / (NP * 8), r = idx - t * (NP * 8), j = r >> 3, c = (r & 7) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < n)
      v = __ldg(reinterpret_cast<const float4*>(src[t] + (row0 + j) * stride[t] + h * HD + c));
    if (t == 0) v = make_float4(v.x * qscale, v.y * qscale, v.z * qscale, v.w * qscale);
    float* d = dst + (t * NP + j) * LDQ + c;
    *reinterpret_cast<float2*>(d) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(d + 2) = make_float2(v.z, v.w);
  }
}

// s[r][t] = sum_d A[i0 + 8 rg + r][d] B[kg + 16 t][d] (rows of LDQ floats)
template <int NS>
__device__ __forceinline__ void strip_tile(const float* A, const float* B, int i0, int rg,
                                           int kg, float (&s)[8][NS]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int t = 0; t < NS; ++t) s[r][t] = 0.0f;
  const float* arow = A + (i0 + 8 * rg) * LDQ;
  const float* brow = B + kg * LDQ;
#pragma unroll 2
  for (int d = 0; d < HD; d += 2) {
    float2 q[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) q[r] = *reinterpret_cast<const float2*>(arow + r * LDQ + d);
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const float2 k = *reinterpret_cast<const float2*>(brow + 16 * t * LDQ + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s[r][t] = fmaf(q[r].x, k.x, s[r][t]);
        s[r][t] = fmaf(q[r].y, k.y, s[r][t]);
      }
    }
  }
}

// The scores s of strip_tile -> exp(s + bias - row max), rs = 1 / row sum.
// kinf[t] = kinfo[kg + 16 t]; dw: the (window, head)'s dense [N, N] bias
// (DENSE).  A query row beyond N takes row 0's bias (it is not stored).
template <int NS, bool DENSE>
__device__ __forceinline__ void strip_softmax(float (&s)[8][NS], const int (&kinf)[NS],
                                              const int* kinfo, const float* tab,
                                              const float* __restrict__ dw, int i0, int rg,
                                              int kg, int n, int win, int shift, float (&rs)[8]) {
  const int tw = 2 * win - 1;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 8 * rg + r, ic = i < n ? i : 0;
    int qoff = 0, qreg = 0;
    if (!DENSE) {
      const int qi = kinfo[ic];
      qoff = (qi & 0xffff) + (win - 1) * (tw + 1);
      qreg = qi >> 16;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int info = kinf[t];
      float v = -INFINITY;
      if (info >= 0) {
        v = s[r][t];
        if (DENSE) {
          v += __ldg(dw + (size_t)ic * n + kg + 16 * t);
        } else {
          v += tab[qoff - (info & 0xffff)];
          if (shift > 0 && (info >> 16) != qreg) v += -100.0f;
        }
      }
      s[r][t] = v;
      mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      s[r][t] = expf(s[r][t] - mx);
      sum += s[r][t];
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    rs[r] = 1.0f / sum;  // one IEEE reciprocal a row, then products
  }
}

// o[e][x] += sum_{i < count} M[i * ldm + 4a + e] R[i * LDQ + 4b + x]: a
// 4 x 4 micro-tile of M^T R (M's columns 4a .. 4a + 3 at its offset)
__device__ __forceinline__ void tile_mtr(const float* M, int ldm, const float* R, int count,
                                         int a, int b, float (&o)[4][4]) {
  const float* mp = M + 4 * a;
  const float* rp = R + 4 * b;
#pragma unroll 4
  for (int i = 0; i < count; ++i) {
    const float4 p = *reinterpret_cast<const float4*>(mp + i * ldm);
    const float2 r0 = *reinterpret_cast<const float2*>(rp + i * LDQ);
    const float2 r1 = *reinterpret_cast<const float2*>(rp + i * LDQ + 2);
    const float pe[4] = {p.x, p.y, p.z, p.w}, re[4] = {r0.x, r0.y, r1.x, r1.y};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[e][x] = fmaf(pe[e], re[x], o[e][x]);
  }
}

__device__ __forceinline__ void zero4x4(float (&o)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e][0] = o[e][1] = o[e][2] = o[e][3] = 0.0f;
}

// q, k, v: rows of stride ld (the three column blocks of one qkv tensor, or
// three tensors); qscale multiplies q at the load (DENSE: K8's unscaled q);
// table f32 [(2w-1)^2, heads] (!DENSE) or dense f32 [dense_windows, heads, N,
// N] (DENSE, window wi reading slice wi % dense_windows); out [rows, C]
template <int NS, bool DENSE>  // NS: 16-row query strips (and 16-key blocks)
__global__ void __launch_bounds__(32 * NS, NS <= 9 ? 2 : 1) win_attn_f32_kernel(
    const float* __restrict__ qp, const float* __restrict__ kp, const float* __restrict__ vp,
    size_t ld, float qscale, const float* __restrict__ table, const float* __restrict__ dense,
    int dense_windows, float* __restrict__ out, int C, int heads, WinMap m) {
  constexpr int NP = 16 * NS;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;                  // [q, k, v][NP][LDQ]
  float* Ks = Qs + NP * LDQ;
  float* Vs = Ks + NP * LDQ;
  float* Pts = Vs + NP * LDQ;       // [NS warps][16 TC keys][LDPT]
  int* kinfo = reinterpret_cast<int*>(Pts + NS * 16 * TC * LDPT);  // [NP]
  float* tab = reinterpret_cast<float*>(kinfo + NP);               // [(2w-1)^2]
  const int n = m.win * m.win;
  const int wi = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)wi * n;

  const float* src[3] = {qp, kp, vp};
  const size_t stride[3] = {ld, ld, ld};
  load_rows<NP>(Qs, src, stride, 3, row0, n, h, qscale, tid, 32 * NS);
  const int per_img = (m.Hp / m.win) * (m.Wp / m.win);
  key_info<NP, DENSE>(kinfo, tab, table, m, wi % per_img, h, heads, tid, 32 * NS);
  __syncthreads();

  const int i0 = warp * 16;
  if (i0 >= n) return;  // a strip wholly beyond N (the only barrier is behind us)
  const int rg = lane >> 4, kg = lane & 15;
  float s[8][NS], rs[8];
  strip_tile<NS>(Qs, Ks, i0, rg, kg, s);
  int kinf[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) kinf[t] = kinfo[kg + 16 * t];
  const float* dw = DENSE ? dense + ((size_t)(wi % dense_windows) * heads + h) * n * n : nullptr;
  strip_softmax<NS, DENSE>(s, kinf, kinfo, tab, dw, i0, rg, kg, n, m.win, m.shift, rs);

  // O = P V, TC 16-key blocks of P at a time through the warp's transposed strip
  float* pt = Pts + warp * (16 * TC * LDPT);
  const int a = lane >> 3, b = lane & 7;  // queries i0 + 4a .. +3, head dims 4b .. +3
  float o[4][4];
  zero4x4(o);
#pragma unroll
  for (int t0 = 0; t0 < NS; t0 += TC) {
    const int tc = NS - t0 < TC ? NS - t0 : TC;
    __syncwarp();  // the previous blocks' reads of the strip are done
#pragma unroll
    for (int t = t0; t < t0 + tc; ++t) {
      float* dst = pt + (kg + 16 * (t - t0)) * LDPT + 8 * rg;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][t] * rs[0], s[1][t] * rs[1],
                                                    s[2][t] * rs[2], s[3][t] * rs[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][t] * rs[4], s[5][t] * rs[5],
                                                        s[6][t] * rs[6], s[7][t] * rs[7]);
    }
    __syncwarp();
    tile_mtr(pt, LDPT, Vs + 16 * t0 * LDQ, 16 * tc, a, b, o);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + 4 * a + e;
    if (i < n)
      *reinterpret_cast<float4*>(out + (row0 + i) * C + h * HD + 4 * b) =
          make_float4(o[e][0], o[e][1], o[e][2], o[e][3]);
  }
}

// K5 in fp32.  q, k, v and dq, dk, dv: rows of stride ld (column blocks of
// one tensor, or three tensors); dout: rows of stride C.  qscale multiplies q
// at the load (1 for K5's pre-scaled q; DENSE: K8's scale); dQ = scale dS K,
// dK = dS^T (q qscale); table / dense as the core's; dbias f32 [chunks, nW,
// heads, N, LDB(N)], each chunk's dS summed over its images in order.
template <int NS, bool DENSE>
__global__ void __launch_bounds__(32 * NS, 1) win_attn_bwd_f32_kernel(
    const float* __restrict__ qp, const float* __restrict__ kp, const float* __restrict__ vp,
    const float* __restrict__ dout, size_t ld, float qscale, float scale,
    const float* __restrict__ table, const float* __restrict__ dense, int dense_windows,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dbias, int batch, int C, int heads, WinMap m) {
  constexpr int NP = 16 * NS, LDM = NP + LDM_PAD;
  constexpr int RMW = 2 * NS;  // float4s of the bias gradient a thread (>= N LDB(N) / 4 / (32 NS))
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;                  // [q, k, v, dO][NP][LDQ]
  float* Ks = Qs + NP * LDQ;
  float* Vs = Ks + NP * LDQ;
  float* Gs = Vs + NP * LDQ;
  float* Ms = Gs + NP * LDQ;        // [NP][LDM]: P, then dS
  int* kinfo = reinterpret_cast<int*>(Ms + NP * LDM);  // [NP]
  float* tab = reinterpret_cast<float*>(kinfo + NP);   // [(2w-1)^2]
  const int n = m.win * m.win, ldb = ldb_of(n), n4 = ldb / 4;
  const int w = blockIdx.x, h = blockIdx.y, per_img = gridDim.x;
  const int b_begin = (int)((long long)blockIdx.z * batch / gridDim.z);
  const int b_end = (int)((long long)(blockIdx.z + 1) * batch / gridDim.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* db = dbias + (((size_t)blockIdx.z * per_img + w) * heads + h) * n * ldb;
  const float* dw = DENSE ? dense + ((size_t)(w % dense_windows) * heads + h) * n * n : nullptr;

  key_info<NP, DENSE>(kinfo, tab, table, m, w, h, heads, tid, 32 * NS);
  __syncthreads();
  const int i0 = warp * 16;  // the warp's query strip, then its key strip
  const int rg = lane >> 4, kg = lane & 15, a = lane >> 3, b = lane & 7;
  int kinf[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) kinf[t] = kinfo[kg + 16 * t];
  const float* src[4] = {qp, kp, vp, dout};
  const size_t stride[4] = {ld, ld, ld, (size_t)C};

  for (int bi = b_begin; bi < b_end; ++bi) {
    const size_t row0 = ((size_t)bi * per_img + w) * n;
    load_rows<NP>(Qs, src, stride, 4, row0, n, h, qscale, tid, 32 * NS);
    __syncthreads();  // image bi's rows are in

    // P = softmax(S) into the strip's rows of the tile (zero beyond N)
    {
      float s[8][NS], rs[8];
      strip_tile<NS>(Qs, Ks, i0, rg, kg, s);
      strip_softmax<NS, DENSE>(s, kinf, kinfo, tab, dw, i0, rg, kg, n, m.win, m.shift, rs);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float rr = i0 + 8 * rg + r < n ? rs[r] : 0.0f;
        float* prow = Ms + (i0 + 8 * rg + r) * LDM + kg;
#pragma unroll
        for (int t = 0; t < NS; ++t) prow[16 * t] = s[r][t] * rr;
      }
    }
    __syncthreads();  // P is whole

    // dV = P^T dO over the warp's key strip
    float o[4][4];
    zero4x4(o);
    tile_mtr(Ms + i0, LDM, Gs, NP, a, b, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = i0 + 4 * a + e;
      if (j < n)
        *reinterpret_cast<float4*>(dv + (row0 + j) * ld + h * HD + 4 * b) =
            make_float4(o[e][0], o[e][1], o[e][2], o[e][3]);
    }
    __syncthreads();  // every read of P for dV is done

    // dP = dO V^T; dS = P (dP - rowsum(dP P)) over the strip's own rows of P
    {
      float s[8][NS];
      strip_tile<NS>(Gs, Vs, i0, rg, kg, s);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* prow = Ms + (i0 + 8 * rg + r) * LDM + kg;
        float p[NS], part = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          p[t] = prow[16 * t];
          part = fmaf(s[r][t], p[t], part);
        }
#pragma unroll
        for (int o2 = 1; o2 < 16; o2 <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o2);
#pragma unroll
        for (int t = 0; t < NS; ++t) prow[16 * t] = p[t] * (s[r][t] - part);
      }
    }
    __syncwarp();
    // dQ = scale dS K: queries i0 + a + 4e (rows a apart land in distinct banks)
    zero4x4(o);
    {
      const float* mrow = Ms + (i0 + a) * LDM;
      const float* krow = Ks + 4 * b;
#pragma unroll 2
      for (int j = 0; j < NP; j += 4) {
        float4 dsr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dsr[e] = *reinterpret_cast<const float4*>(mrow + 4 * e * LDM + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 k0 = *reinterpret_cast<const float2*>(krow + (j + u) * LDQ);
          const float2 k1 = *reinterpret_cast<const float2*>(krow + (j + u) * LDQ + 2);
          const float ke[4] = {k0.x, k0.y, k1.x, k1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dse = u == 0 ? dsr[e].x : u == 1 ? dsr[e].y : u == 2 ? dsr[e].z : dsr[e].w;
#pragma unroll
            for (int x = 0; x < 4; ++x) o[e][x] = fmaf(dse, ke[x], o[e][x]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + a + 4 * e;
      if (i < n)
        *reinterpret_cast<float4*>(dq + (row0 + i) * ld + h * HD + 4 * b) =
            make_float4(o[e][0] * scale, o[e][1] * scale, o[e][2] * scale, o[e][3] * scale);
    }
    __syncthreads();  // dS is whole

    // dK = dS^T Q over the warp's key strip; meanwhile the image's dS into the
    // block's slice of the bias gradient (its reads issued first)
    const bool first = bi == b_begin;
    float4 acc[RMW];
#pragma unroll
    for (int it = 0; it < RMW; ++it) {
      const int idx = tid + 32 * NS * it, row = idx / n4, c4 = idx - row * n4;
      acc[it] = idx < n * n4 && !first
                    ? *reinterpret_cast<const float4*>(db + (size_t)row * ldb + 4 * c4)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    zero4x4(o);
    tile_mtr(Ms + i0, LDM, Qs, NP, a, b, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = i0 + 4 * a + e;
      if (j < n)
        *reinterpret_cast<float4*>(dk + (row0 + j) * ld + h * HD + 4 * b) =
            make_float4(o[e][0], o[e][1], o[e][2], o[e][3]);
    }
#pragma unroll
    for (int it = 0; it < RMW; ++it) {
      const int idx = tid + 32 * NS * it, row = idx / n4, c4 = idx - row * n4;
      if (idx < n * n4) {
        const float4 d = *reinterpret_cast<const float4*>(Ms + row * LDM + 4 * c4);
        *reinterpret_cast<float4*>(db + (size_t)row * ldb + 4 * c4) =
            make_float4(acc[it].x + d.x, acc[it].y + d.y, acc[it].z + d.z, acc[it].w + d.w);
      }
    }
    __syncthreads();  // before the next image's rows and P overwrite shared memory
  }
}

template <int NS, bool DENSE>
int launch_core(const float* q, const float* k, const float* v, size_t ld, float qscale,
                const float* table, const float* dense, int dense_windows, float* out,
                int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  const int tw = 2 * m.win - 1;
  const size_t smem = core_smem_bytes<NS>(DENSE ? 0 : tw * tw);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_f32_kernel<NS, DENSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  win_attn_f32_kernel<NS, DENSE><<<dim3(num_windows, heads), 32 * NS, smem, st>>>(
      q, k, v, ld, qscale, table, dense, dense_windows, out, C, heads, m);
  return (int)cudaGetLastError();
}

template <int NS, bool DENSE>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout, size_t ld,
               float qscale, float scale, const float* table, const float* dense,
               int dense_windows, float* dq, float* dk, float* dv, float* dbias, int batch,
               int chunks, int C, int heads, WinMap m, cudaStream_t st) {
  const int tw = 2 * m.win - 1;
  const size_t smem = bwd_smem_bytes<NS>(DENSE ? 0 : tw * tw);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_bwd_f32_kernel<NS, DENSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((m.Hp / m.win) * (m.Wp / m.win), heads, chunks);
  win_attn_bwd_f32_kernel<NS, DENSE><<<grid, 32 * NS, smem, st>>>(
      q, k, v, dout, ld, qscale, scale, table, dense, dense_windows, dq, dk, dv, dbias, batch, C,
      heads, m);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_win_attn_f32(const float* q, const float* k, const float* v, size_t ld, float qscale,
                        const float* table, const float* dense, int dense_windows, float* out,
                        int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  const int n = m.win * m.win;
  if (C != heads * HD || n > 256) return (int)cudaErrorInvalidValue;
#define GRIT_WAF_LAUNCH(NS)                                                                    \
  return dense != nullptr                                                                      \
             ? launch_core<NS, true>(q, k, v, ld, qscale, table, dense, dense_windows, out,   \
                                     num_windows, C, heads, m, st)                            \
             : launch_core<NS, false>(q, k, v, ld, qscale, table, dense, dense_windows, out,  \
                                      num_windows, C, heads, m, st)
  if (n <= 64) GRIT_WAF_LAUNCH(4);
  if (n <= 144) GRIT_WAF_LAUNCH(9);
  GRIT_WAF_LAUNCH(16);
#undef GRIT_WAF_LAUNCH
}

int launch_win_attn_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                            size_t ld, float qscale, float scale, const float* table,
                            const float* dense, int dense_windows, float* dq, float* dk, float* dv,
                            float* dbias, int batch, int chunks, int C, int heads, WinMap m,
                            cudaStream_t st) {
  const int n = m.win * m.win;
  if (C != heads * HD || n > 144 || (dense != nullptr && n % 4) || chunks < 1 || chunks > batch)
    return (int)cudaErrorInvalidValue;
#define GRIT_WABF_LAUNCH(NS)                                                                   \
  return dense != nullptr                                                                      \
             ? launch_bwd<NS, true>(q, k, v, dout, ld, qscale, scale, table, dense,           \
                                    dense_windows, dq, dk, dv, dbias, batch, chunks, C, heads, \
                                    m, st)                                                     \
             : launch_bwd<NS, false>(q, k, v, dout, ld, qscale, scale, table, dense,          \
                                     dense_windows, dq, dk, dv, dbias, batch, chunks, C,       \
                                     heads, m, st)
  if (n <= 64) GRIT_WABF_LAUNCH(4);
  GRIT_WABF_LAUNCH(9);
#undef GRIT_WABF_LAUNCH
}

}  // namespace grit
