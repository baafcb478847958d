// The bf16 window-attention core on Hopper's tensor cores (mma.sync).
//
// Serves the attention core of K1 and K4 (grit_window_attn: the
// relative-position table and the shifted-window regions) and K8's forward
// (grit_window_attn_dense: q scaled at the load, a dense f32 bias): the
// softmax(q k^T + bias) v inside grit_tpu/ops/window_attention.py::_band_kernel,
// ::_block_kernel and ::_kernel.  Entered through launch_win_attn_bf16
// (swin_block.cu's entry points); fp32 runs on win_attn_f32.cu's SIMT
// register micro-tiles, which follow this layout.
//
// What bounds it on an H100: bytes.  Per (window, head) it reads q, k and v
// (3 x N x 32 bf16) and writes N x 32; its 4 N^2 d flops are ~0.08 ms over a
// b8 384x640 forward against ~0.3 ms of traffic.  wgmma's 64-row tile would
// pad N = 144 queries to 192; mma.sync m16n8k16 fits 144 = 9 x 16 exactly.
// The design:
// - a block holds one window and HPB = 2 heads, so that each token's q, k and
//   v rows are loaded as 128 contiguous bytes; they arrive by 16-byte cp.async
//   and stay bf16 in shared memory, in rows padded to 80 bytes, which ldmatrix
//   reads without bank conflicts;
// - a warp owns a 16-query strip of one head: S = Q K^T in registers (the
//   strip's 16 x N f32 scores, N / 2 a thread); the bias added per score (the
//   head's column of the table in shared memory, indexed from the query's and
//   the key's coordinates, and -100 where their shifted-window regions
//   differ; or an 8-byte read of the dense bias row); the exact row max and
//   sum by two quad shuffles (a whole row lives in one quad: no online
//   softmax); P = exp(s - max) times the row's reciprocal sum, rounded to
//   bf16 in registers (the plain version's and the TPU's rounding point), and
//   used as the A fragments of P V (m16n8k16's accumulator layout is its A
//   layout); V read by ldmatrix.trans;
// - the 16 x 32 output strip goes through the strip's own (spent) Q rows in
//   shared memory to 16-byte stores;
// - keys are padded to a multiple of 16 (masked to -inf, zero rows) and query
//   rows beyond N are not stored, so any window with N <= 256 works: the
//   kernel is instantiated for 4, 9 and 16 strips (N <= 64, 144, 256).
#include "mma_tiles.cuh"

namespace grit {
namespace {

constexpr int HPB = 2;       // heads a block
constexpr int HD = 32;       // head dim
constexpr int LDS = HD + 8;  // bf16 row stride in shared memory: 80 bytes

// q, k, v: rows of stride ld (the three column blocks of one qkv tensor, or
// three tensors); qscale multiplies q before it is rounded to bf16 (DENSE: K8);
// table f32 [(2w-1)^2, heads] (!DENSE) or dense f32 [dense_windows, heads, N, N]
// (DENSE, window wi reading slice wi % dense_windows); out [rows, C]
template <int NS, bool DENSE>  // NS: 16-row query strips (and 16-key blocks) a head
__global__ void __launch_bounds__(32 * NS, NS <= 9 ? 2 : 1) win_attn_mma_kernel(
    const bf16* __restrict__ qp, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    size_t ld, float qscale, const float* __restrict__ table, const float* __restrict__ dense,
    int dense_windows, bf16* __restrict__ out, int C, int heads, WinMap m) {
  constexpr int NP = 16 * NS;  // tokens padded to whole strips
  constexpr int NT = 2 * NS;   // 8-key tiles of a score row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [HPB][NP][LDS] each
  bf16* sk = sq + HPB * NP * LDS;
  bf16* sv = sk + HPB * NP * LDS;
  // per key: its offset in the table (jy (2w-1) + jx) | its region << 16; -1 beyond N
  int* kinfo = reinterpret_cast<int*>(sv + HPB * NP * LDS);
  float* tab = reinterpret_cast<float*>(kinfo + NP);  // [HPB][(2w-1)^2]
  const int win = m.win, n = win * win, tw = 2 * win - 1, tw2 = tw * tw;
  const int wi = blockIdx.x, h0 = blockIdx.y * HPB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)wi * n;

  // q, k and v of the block's heads, 16 bytes a thread; padding rows are zeros
  const bf16* src[3] = {qp, kp, vp};
  bf16* dst[3] = {sq, sk, sv};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    for (int idx = tid; idx < NP * HPB * 4; idx += 32 * NS) {
      const int j = idx / (HPB * 4), c = idx - j * (HPB * 4);
      const int hh = c >> 2, d0 = (c & 3) * 8;
      bf16* d = dst[t] + (hh * NP + j) * LDS + d0;
      if (j < n && h0 + hh < heads)
        cp_async16(smem_u32(d), src[t] + (row0 + j) * ld + (h0 + hh) * HD + d0);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (!DENSE) {
    // shifted-window regions on the rolled padded grid: rows [0, Hp - w),
    // [Hp - w, Hp - s), [Hp - s, Hp) and likewise for columns
    const int nwx = m.Wp / win, per_img = (m.Hp / win) * nwx;
    const int wr = wi % per_img, wy = wr / nwx, wx = wr - wy * nwx;
    for (int j = tid; j < NP; j += 32 * NS) {
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
    for (int idx = tid; idx < HPB * tw2; idx += 32 * NS) {
      const int hh = idx / tw2, r = idx - hh * tw2;
      tab[idx] = h0 + hh < heads ? table[(size_t)r * heads + h0 + hh] : 0.0f;
    }
  } else {
    for (int j = tid; j < NP; j += 32 * NS) kinfo[j] = j < n ? 0 : -1;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int i0 = warp * 16;
  if (i0 >= n) return;  // a strip wholly beyond N (the only barrier is behind us)
  const int g = lane >> 2, t4 = lane & 3;
  // the thread's two query rows; a row beyond N computes row 0's scores and is not stored
  const int ia = i0 + g < n ? i0 + g : 0, ib = i0 + g + 8 < n ? i0 + g + 8 : 0;
  int qa_off = 0, qb_off = 0, qa_reg = 0, qb_reg = 0;
  if (!DENSE) {
    qa_off = (ia / win) * tw + ia % win + (win - 1) * (tw + 1);
    qb_off = (ib / win) * tw + ib % win + (win - 1) * (tw + 1);
    qa_reg = kinfo[ia] >> 16;
    qb_reg = kinfo[ib] >> 16;
  }

  for (int hh = 0; hh < HPB; ++hh) {
    const int h = h0 + hh;
    if (h >= heads) break;
    bf16* Q = sq + hh * NP * LDS;
    const bf16* Ks = sk + hh * NP * LDS;
    const bf16* Vs = sv + hh * NP * LDS;

    // the strip's Q as A fragments of the two 16-wide k-steps over d
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(qa[ks], smem_u32(Q + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + ks * 16 +
                               (lane >> 4) * 8));
    if (DENSE) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[ks][r] = scale_bf16x2(qa[ks][r], qscale);
    }

    // S = Q K^T: tile nt holds keys 8 nt + 2 t4 + {0, 1} of rows g ([0], [1]) and g + 8 ([2], [3])
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < NS; ++kb) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t kf[4];  // keys kb*16 + 8 hf + (0..7), d in four 8-wide chunks
        ldsm_x4(kf, smem_u32(Ks + (kb * 16 + hf * 8 + (lane & 7)) * LDS + (lane >> 3) * 8));
        mma16816(s[2 * kb + hf], qa[0], kf[0], kf[1]);
        mma16816(s[2 * kb + hf], qa[1], kf[2], kf[3]);
      }
    }

    // bias, mask, exact row max
    const float* da = nullptr;
    const float* db = nullptr;
    if (DENSE) {
      const float* dw = dense + ((size_t)(wi % dense_windows) * heads + h) * n * n;
      da = dw + (size_t)ia * n;
      db = dw + (size_t)ib * n;
    }
    const float* th = tab + hh * tw2;
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt * 8 + 2 * t4;
      const int info0 = kinfo[j], info1 = kinfo[j + 1];
      if (DENSE) {
        if (info1 >= 0) {  // n is even: j and j + 1 are both keys
          const float2 ba = *reinterpret_cast<const float2*>(da + j);
          const float2 bb = *reinterpret_cast<const float2*>(db + j);
          s[nt][0] += ba.x;
          s[nt][1] += ba.y;
          s[nt][2] += bb.x;
          s[nt][3] += bb.y;
        }
      } else {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int info = e2 ? info1 : info0;
          if (info >= 0) {
            const int koff = info & 0xffff, kreg = info >> 16;
            s[nt][e2] += th[qa_off - koff];
            s[nt][2 + e2] += th[qb_off - koff];
            if (m.shift > 0) {
              if (kreg != qa_reg) s[nt][e2] += -100.0f;
              if (kreg != qb_reg) s[nt][2 + e2] += -100.0f;
            }
          }
        }
      }
      if (info0 < 0) s[nt][0] = s[nt][2] = -INFINITY;
      if (info1 < 0) s[nt][1] = s[nt][3] = -INFINITY;
      mxa = fmaxf(mxa, fmaxf(s[nt][0], s[nt][1]));
      mxb = fmaxf(mxb, fmaxf(s[nt][2], s[nt][3]));
    }
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    float suma = 0.0f, sumb = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mxa);
      s[nt][1] = expf(s[nt][1] - mxa);
      s[nt][2] = expf(s[nt][2] - mxb);
      s[nt][3] = expf(s[nt][3] - mxb);
      suma += s[nt][0] + s[nt][1];
      sumb += s[nt][2] + s[nt][3];
    }
    suma += __shfl_xor_sync(0xffffffffu, suma, 1);
    suma += __shfl_xor_sync(0xffffffffu, suma, 2);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);

    // P in bf16 as the A fragments of P V: k-step kb is score tiles 2 kb, 2 kb + 1.
    // One IEEE reciprocal a row, then products: an IEEE division for each of a
    // thread's 72 probabilities tripled the kernel's time on an H100
    const float ra = 1.0f / suma, rb = 1.0f / sumb;
    uint32_t pa[NS][4];
#pragma unroll
    for (int kb = 0; kb < NS; ++kb) {
      pa[kb][0] = pack_bf16(s[2 * kb][0] * ra, s[2 * kb][1] * ra);
      pa[kb][1] = pack_bf16(s[2 * kb][2] * rb, s[2 * kb][3] * rb);
      pa[kb][2] = pack_bf16(s[2 * kb + 1][0] * ra, s[2 * kb + 1][1] * ra);
      pa[kb][3] = pack_bf16(s[2 * kb + 1][2] * rb, s[2 * kb + 1][3] * rb);
    }

    // O = P V over four 8-wide d tiles
    float o[4][4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < NS; ++kb) {
      const uint32_t vrow =
          smem_u32(Vs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t vf[4];  // d tiles 2 hf and 2 hf + 1, keys kb*16 + (0..15)
        ldsm_x4_trans(vf, vrow + hf * 32);
        mma16816(o[2 * hf], pa[kb], vf[0], vf[1]);
        mma16816(o[2 * hf + 1], pa[kb], vf[2], vf[3]);
      }
    }

    // the strip's output through its spent Q rows, then 16-byte stores
    __syncwarp();
    bf16* stage = Q + i0 * LDS;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(stage + g * LDS + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LDS + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = lane + 32 * it, r = idx >> 2, c = idx & 3;
      if (i0 + r < n)
        *reinterpret_cast<uint4*>(out + (row0 + i0 + r) * C + h * HD + c * 8) =
            *reinterpret_cast<const uint4*>(stage + r * LDS + c * 8);
    }
  }
}

template <int NS, bool DENSE>
int launch_ns(const bf16* q, const bf16* k, const bf16* v, size_t ld, float qscale,
              const float* table, const float* dense, int dense_windows, bf16* out,
              int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  const int tw = 2 * m.win - 1;
  const size_t smem = (size_t)3 * HPB * 16 * NS * LDS * 2 + (size_t)16 * NS * 4 +
                      (DENSE ? 0 : (size_t)HPB * tw * tw * 4);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_mma_kernel<NS, DENSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(num_windows, (heads + HPB - 1) / HPB);
  win_attn_mma_kernel<NS, DENSE><<<grid, 32 * NS, smem, st>>>(
      q, k, v, ld, qscale, table, dense, dense_windows, out, C, heads, m);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_win_attn_bf16(const bf16* q, const bf16* k, const bf16* v, size_t ld, float qscale,
                         const float* table, const float* dense, int dense_windows, bf16* out,
                         int num_windows, int C, int heads, WinMap m, cudaStream_t st) {
  const int n = m.win * m.win;
  if (C != heads * HD || n > 256 || (dense != nullptr && n % 2)) return (int)cudaErrorInvalidValue;
#define GRIT_WA_LAUNCH(NS)                                                                    \
  return dense != nullptr                                                                      \
             ? launch_ns<NS, true>(q, k, v, ld, qscale, table, dense, dense_windows, out,     \
                                   num_windows, C, heads, m, st)                              \
             : launch_ns<NS, false>(q, k, v, ld, qscale, table, dense, dense_windows, out,    \
                                    num_windows, C, heads, m, st)
  if (n <= 64) GRIT_WA_LAUNCH(4);
  if (n <= 144) GRIT_WA_LAUNCH(9);
  GRIT_WA_LAUNCH(16);
#undef GRIT_WA_LAUNCH
}

}  // namespace grit
