// K5 in bf16: the window-attention backward on Hopper's tensor cores
// (mma.sync), with the batch split over blocks.
//
// Replaces grit_tpu/ops/window_attention.py::_bwd_kernel (through _backward):
// for each (window kind, head, image) it recomputes P = softmax(S), S = Q K^T
// + bias, then dV = P^T dO (P rounded to bf16), dP = dO V^T, dS = P (dP -
// rowsum(dP P)), dQ = (dS scale) K and dK = (dS scale)^T Q with dS scale
// rounded to bf16 (the body's ds_s), and sums the f32 dS over the batch into
// the bias gradient.  Serves K5 (grit_window_attn_bwd: q stored pre-scaled,
// the bias from the relative-position table and the shifted-window regions,
// as the forward kernel derives them) and K8's backward
// (grit_window_attn_dense_bwd: q unscaled, scaled at the load, a dense f32
// bias).  fp32 runs on win_attn_f32.cu's SIMT register micro-tiles, which
// follow this structure.
//
// What bounds it on an H100: bytes.  Per (window, head, image) it reads q,
// k, v and dO (4 x N x 32 bf16) and writes dq, dk and dv; its 10 N^2 d flops
// run on the tensor cores.  The SIMT kernel it replaces spent its time on
// about one shared-memory load a FMA, and looped over the whole batch in one
// block per (window, head), so the starved stages (2 windows x 32 heads at
// the b16 XE step's stage 4) ran 64 blocks on 132 SMs.  The design:
// - the grid is (window of the image, head, batch chunk); the wrapper picks
//   the chunk count so that a stage has about two waves of blocks, and each
//   block walks its chunk's images in order;
// - an image's q, k, v and dO rows of the block's head arrive by 16-byte
//   cp.async into bf16 rows padded to 80 bytes (ldmatrix reads them without
//   bank conflicts), double-buffered: the next image's rows load while this
//   one computes;
// - query-strip phase: warp s owns queries 16 s .. 16 s + 15.  S = Q K^T on
//   m16n8k16, plus the bias; the exact row max and sum by quad shuffles; P in
//   f32 registers (and rounded to bf16 into shared memory); dP = dO V^T in
//   registers; dS in place of dP; the f32 dS added into the bias gradient;
//   dQ = (dS scale)_bf16 K with the rounded dS reused as the A fragments
//   (the accumulator layout is the A layout) and written, rounded, into
//   shared memory as well;
// - key-strip phase, after one barrier: warp s owns keys 16 s .. 16 s + 15;
//   dV = P^T dO and dK = (dS scale)^T Q from the two N x N bf16 tiles through
//   ldmatrix.trans;
// - outputs leave as 16-byte row stores: dQ through a small per-warp stage,
//   dK and dV through the warp's own (spent) K and V rows;
// - the bias gradient stays deterministic without atomics: the block that
//   owns (window, head, chunk) adds each image's f32 dS into its own slice of
//   a [chunks, nW, heads, N, N] partial in image order (read-modify-write
//   through L2); the wrapper sums the partial over chunks and windows.
// Keys and queries are padded to whole 16-row strips (masked keys, zero rows);
// the two N x N tiles bound N: shared memory for NS = 9 strips (N <= 144) is
// 2 x 46 KB of rows, 2 x 44 KB of tiles and 12 KB of stage, one block an SM.
// N may be odd (window 7: N = 49, in the NS = 4 instance): a row of the bias
// gradient is padded to LDB(N) = N rounded up to a multiple of 4 floats, so
// that a thread's column pair (j, j + 1) stays 8-byte aligned and inside its
// row even where j + 1 = N; the pad column takes the masked key's dS, which
// is 0, and the wrapper reads the real N columns.  An even window has N % 4
// == 0 and no pad.  K8's dense bias is read in pairs and keeps N % 4 == 0.
#include "mma_tiles.cuh"

namespace grit {
namespace {

constexpr int HD = 32;       // head dim
constexpr int LDS = HD + 8;  // bf16 row stride of q, k, v, dO in shared memory: 80 bytes
constexpr int RMW_TILES = 6;  // score tiles of the bias gradient read before they are written

// the row stride of the bias gradient [chunks, nW, heads, N, LDB(N)] (floats)
__host__ __device__ constexpr int ldb_of(int n) { return (n + 3) & ~3; }

template <int NS>
constexpr size_t bwd_smem_bytes(int tw2, bool dense) {
  // two buffers of q, k, v, dO rows; P and dS tiles; the dQ stage; key info; table column
  return ((size_t)2 * 4 * 16 * NS * LDS + (size_t)2 * 16 * NS * (16 * NS + 8) +
          (size_t)NS * 16 * LDS) * 2 + (size_t)16 * NS * 4 + (dense ? 0 : (size_t)tw2 * 4);
}

// q, k, v and dq, dk, dv: rows of stride ld (column blocks of one tensor, or
// three tensors); dout: rows of stride C.  qscale multiplies q before it is
// rounded for S (DENSE: K8's unscaled q); scale multiplies dS before its
// rounding; dK = kscale (dS scale)^T Q with Q as stored (kscale = qscale /
// scale).  table f32 [(2w-1)^2, heads] (!DENSE) or dense f32 [dense_windows,
// heads, N, N] (DENSE); dbias f32 [chunks, nW, heads, N, LDB(N)].
template <int NS, bool DENSE>
__global__ void __launch_bounds__(32 * NS, 1) win_attn_bwd_mma_kernel(
    const bf16* __restrict__ qp, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const bf16* __restrict__ dout, size_t ld, float qscale, float scale, float kscale,
    const float* __restrict__ table, const float* __restrict__ dense, int dense_windows,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dbias, int batch, int C, int heads, WinMap m) {
  constexpr int NP = 16 * NS;    // tokens padded to whole strips
  constexpr int NT = 2 * NS;     // 8-key tiles of a score row
  constexpr int LDP = NP + 8;    // bf16 row stride of the P and dS tiles
  constexpr int ROWS = NP * LDS;  // one tensor's rows
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);  // [2][q, k, v, dO][NP][LDS]
  bf16* Ps = bufs + 2 * 4 * ROWS;              // [NP][LDP]
  bf16* Ds = Ps + NP * LDP;                    // [NP][LDP]
  bf16* stg = Ds + NP * LDP;                   // [NS][16][LDS]
  // per key: its offset in the table (jy (2w-1) + jx) | its region << 16; -1 beyond N
  int* kinfo = reinterpret_cast<int*>(stg + NS * 16 * LDS);
  float* tab = reinterpret_cast<float*>(kinfo + NP);  // [(2w-1)^2]: the head's table column
  const int win = m.win, n = win * win, ldb = ldb_of(n), tw = 2 * win - 1, tw2 = tw * tw;
  const int w = blockIdx.x, h = blockIdx.y, per_img = gridDim.x;
  const int b_begin = (int)((long long)blockIdx.z * batch / gridDim.z);
  const int b_end = (int)((long long)(blockIdx.z + 1) * batch / gridDim.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* db = dbias + (((size_t)blockIdx.z * per_img + w) * heads + h) * n * ldb;

  // q, k, v and dO rows of image b's window, 16 bytes a thread; padding rows are zeros
  auto load = [&](int b, bf16* dst) {
    const size_t row0 = ((size_t)b * per_img + w) * n;
    for (int idx = tid; idx < 4 * NP * 4; idx += 32 * NS) {
      const int t = idx / (NP * 4), r = idx - t * (NP * 4);
      const int j = r >> 2, c = (r & 3) * 8;
      bf16* d = dst + t * ROWS + j * LDS + c;
      if (j < n) {
        const bf16* src = t == 3 ? dout + (row0 + j) * C
                                 : (t == 0 ? qp : t == 1 ? kp : vp) + (row0 + j) * ld;
        cp_async16(smem_u32(d), src + h * HD + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  if (b_begin < b_end) load(b_begin, bufs);
  if (!DENSE) {
    // shifted-window regions on the rolled padded grid: rows [0, Hp - w),
    // [Hp - w, Hp - s), [Hp - s, Hp) and likewise for columns
    const int nwx = m.Wp / win;
    const int wy = w / nwx, wx = w - wy * nwx;
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
    for (int r = tid; r < tw2; r += 32 * NS) tab[r] = table[(size_t)r * heads + h];
  } else {
    for (int j = tid; j < NP; j += 32 * NS) kinfo[j] = j < n ? 0 : -1;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = warp * 16;  // the warp's query strip, then its key strip
  // the thread's two query rows; a row beyond N computes row 0's scores and
  // is zeroed (P and dS) and not stored
  const int ia = i0 + g < n ? i0 + g : 0, ib = i0 + g + 8 < n ? i0 + g + 8 : 0;
  const float va = i0 + g < n ? 1.0f : 0.0f, vb = i0 + g + 8 < n ? 1.0f : 0.0f;
  const float* dw = DENSE ? dense + ((size_t)(w % dense_windows) * heads + h) * n * n : nullptr;
  // ldmatrix lane offsets: rows of a 16-row block (plain: A tiles and the
  // trans B tiles), and the 8-row / 8-column halves for the trans A tiles
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const int trow = ((lane >> 4) & 1) * 8 + (lane & 7), tcol = ((lane >> 3) & 1) * 8;

  for (int b = b_begin; b < b_end; ++b) {
    bf16* Q = bufs + ((b - b_begin) & 1) * 4 * ROWS;
    bf16* K = Q + ROWS;
    bf16* V = K + ROWS;
    const bf16* O = V + ROWS;
    const size_t row0 = ((size_t)b * per_img + w) * n;
    if (b + 1 < b_end) {
      load(b + 1, bufs + ((b + 1 - b_begin) & 1) * 4 * ROWS);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // image b's rows (and the key info) are in

    // ---- query strip i0: S, P, dP, dS, dQ ----------------------------------
    int qa_off = 0, qb_off = 0, qa_reg = 0, qb_reg = 0;
    if (!DENSE) {
      qa_off = (ia / win) * tw + ia % win + (win - 1) * (tw + 1);
      qb_off = (ib / win) * tw + ib % win + (win - 1) * (tw + 1);
      qa_reg = kinfo[ia] >> 16;
      qb_reg = kinfo[ib] >> 16;
    }
    float s[NT][4];
    {
      uint32_t qa[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldsm_x4(qa[ks], smem_u32(Q + (i0 + lrow) * LDS + ks * 16 + lcol));
        if (DENSE) {
#pragma unroll
          for (int r = 0; r < 4; ++r) qa[ks][r] = scale_bf16x2(qa[ks][r], qscale);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < NS; ++kb) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t kf[4];  // keys kb*16 + 8 hf + (0..7), d in four 8-wide chunks
          ldsm_x4(kf, smem_u32(K + (kb * 16 + hf * 8 + (lane & 7)) * LDS + (lane >> 3) * 8));
          mma16816(s[2 * kb + hf], qa[0], kf[0], kf[1]);
          mma16816(s[2 * kb + hf], qa[1], kf[2], kf[3]);
        }
      }
    }
    // bias, mask, exact row max
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt * 8 + 2 * t4;
      const int info0 = kinfo[j], info1 = kinfo[j + 1];
      if (DENSE) {
        if (info1 >= 0) {  // DENSE has n % 4 == 0: j and j + 1 are both keys
          const float2 ba = *reinterpret_cast<const float2*>(dw + (size_t)ia * n + j);
          const float2 bb = *reinterpret_cast<const float2*>(dw + (size_t)ib * n + j);
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
            s[nt][e2] += tab[qa_off - koff];
            s[nt][2 + e2] += tab[qb_off - koff];
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
    // P in f32 (one IEEE reciprocal a row, as the forward), zero on rows
    // beyond N; its bf16 rounding into the P tile for dV
    const float ra = va / suma, rb = vb / sumb;
    bf16* pa_row = Ps + (i0 + g) * LDP + 2 * t4;
    bf16* pb_row = pa_row + 8 * LDP;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] *= ra;
      s[nt][1] *= ra;
      s[nt][2] *= rb;
      s[nt][3] *= rb;
      *reinterpret_cast<uint32_t*>(pa_row + nt * 8) = pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(pb_row + nt * 8) = pack_bf16(s[nt][2], s[nt][3]);
    }

    // dP = dO V^T
    float dp[NT][4];
    {
      uint32_t oa[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(oa[ks], smem_u32(O + (i0 + lrow) * LDS + ks * 16 + lcol));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
#pragma unroll
      for (int kb = 0; kb < NS; ++kb) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t vf[4];
          ldsm_x4(vf, smem_u32(V + (kb * 16 + hf * 8 + (lane & 7)) * LDS + (lane >> 3) * 8));
          mma16816(dp[2 * kb + hf], oa[0], vf[0], vf[1]);
          mma16816(dp[2 * kb + hf], oa[1], vf[2], vf[3]);
        }
      }
    }
    // dS = P (dP - rowsum(dP P)) in place of dP
    float da = 0.0f, dbs = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      da += dp[nt][0] * s[nt][0] + dp[nt][1] * s[nt][1];
      dbs += dp[nt][2] * s[nt][2] + dp[nt][3] * s[nt][3];
    }
    da += __shfl_xor_sync(0xffffffffu, da, 1);
    da += __shfl_xor_sync(0xffffffffu, da, 2);
    dbs += __shfl_xor_sync(0xffffffffu, dbs, 1);
    dbs += __shfl_xor_sync(0xffffffffu, dbs, 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - da);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - da);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - dbs);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - dbs);
    }
    // the bias gradient: this image's f32 dS added into the block's slice,
    // RMW_TILES score tiles at a time, all their loads before any store (so
    // the L2 round trips overlap instead of queueing behind each store)
    {
      const bool first = b == b_begin;
      const bool ok_a = i0 + g < n, ok_b = i0 + g + 8 < n;
      float* dba = db + (size_t)(i0 + g) * ldb + 2 * t4;
      float* dbb = dba + 8 * (size_t)ldb;
#pragma unroll
      for (int nt0 = 0; nt0 < NT; nt0 += RMW_TILES) {
        float2 oa[RMW_TILES], ob[RMW_TILES];
#pragma unroll
        for (int j = 0; j < RMW_TILES; ++j) {
          const int nt = nt0 + j;
          // a pair with its first key inside N lies inside the padded row
          const bool in = nt < NT && nt * 8 + 2 * t4 < n;
          oa[j] = in && ok_a && !first ? *reinterpret_cast<const float2*>(dba + nt * 8)
                                       : make_float2(0.0f, 0.0f);
          ob[j] = in && ok_b && !first ? *reinterpret_cast<const float2*>(dbb + nt * 8)
                                       : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < RMW_TILES; ++j) {
          const int nt = nt0 + j;
          if (nt < NT && nt * 8 + 2 * t4 < n) {
            if (ok_a)
              *reinterpret_cast<float2*>(dba + nt * 8) =
                  make_float2(oa[j].x + dp[nt][0], oa[j].y + dp[nt][1]);
            if (ok_b)
              *reinterpret_cast<float2*>(dbb + nt * 8) =
                  make_float2(ob[j].x + dp[nt][2], ob[j].y + dp[nt][3]);
          }
        }
      }
    }
    // dQ = (dS scale)_bf16 K; the rounded dS also into the dS tile for dK
    {
      float acc[4][4];
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
      bf16* da_row = Ds + (i0 + g) * LDP + 2 * t4;
      bf16* db_row = da_row + 8 * LDP;
#pragma unroll
      for (int kb = 0; kb < NS; ++kb) {
        uint32_t sa[4];
        sa[0] = pack_bf16(dp[2 * kb][0] * scale, dp[2 * kb][1] * scale);
        sa[1] = pack_bf16(dp[2 * kb][2] * scale, dp[2 * kb][3] * scale);
        sa[2] = pack_bf16(dp[2 * kb + 1][0] * scale, dp[2 * kb + 1][1] * scale);
        sa[3] = pack_bf16(dp[2 * kb + 1][2] * scale, dp[2 * kb + 1][3] * scale);
        *reinterpret_cast<uint32_t*>(da_row + kb * 16) = sa[0];
        *reinterpret_cast<uint32_t*>(db_row + kb * 16) = sa[1];
        *reinterpret_cast<uint32_t*>(da_row + kb * 16 + 8) = sa[2];
        *reinterpret_cast<uint32_t*>(db_row + kb * 16 + 8) = sa[3];
        const uint32_t krow = smem_u32(K + (kb * 16 + lrow) * LDS + lcol);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t kt[4];  // d tiles 2 hf and 2 hf + 1, keys kb*16 + (0..15)
          ldsm_x4_trans(kt, krow + hf * 32);
          mma16816(acc[2 * hf], sa, kt[0], kt[1]);
          mma16816(acc[2 * hf + 1], sa, kt[2], kt[3]);
        }
      }
      // through the warp's stage to 16-byte row stores
      bf16* st = stg + warp * 16 * LDS;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(st + g * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(st + (g + 8) * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int idx = lane + 32 * it, r = idx >> 2, c = idx & 3;
        if (i0 + r < n)
          *reinterpret_cast<uint4*>(dq + (row0 + i0 + r) * ld + h * HD + c * 8) =
              *reinterpret_cast<const uint4*>(st + r * LDS + c * 8);
      }
    }
    __syncthreads();  // the P and dS tiles are whole; K and V are spent

    // ---- key strip i0: dV = P^T dO, dK = kscale (dS scale)^T Q ------------
    {
      float av[4][4], ak[4][4];
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        av[dt][0] = av[dt][1] = av[dt][2] = av[dt][3] = 0.0f;
        ak[dt][0] = ak[dt][1] = ak[dt][2] = ak[dt][3] = 0.0f;
      }
#pragma unroll
      for (int qb = 0; qb < NS; ++qb) {
        uint32_t pt[4], st4[4];  // P^T and (dS scale)^T: keys i0.., queries qb*16..
        ldsm_x4_trans(pt, smem_u32(Ps + (qb * 16 + trow) * LDP + i0 + tcol));
        ldsm_x4_trans(st4, smem_u32(Ds + (qb * 16 + trow) * LDP + i0 + tcol));
        const uint32_t orow = smem_u32(O + (qb * 16 + lrow) * LDS + lcol);
        const uint32_t qrow = smem_u32(Q + (qb * 16 + lrow) * LDS + lcol);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t of[4], qf[4];
          ldsm_x4_trans(of, orow + hf * 32);
          mma16816(av[2 * hf], pt, of[0], of[1]);
          mma16816(av[2 * hf + 1], pt, of[2], of[3]);
          ldsm_x4_trans(qf, qrow + hf * 32);
          mma16816(ak[2 * hf], st4, qf[0], qf[1]);
          mma16816(ak[2 * hf + 1], st4, qf[2], qf[3]);
        }
      }
      // through the warp's own K and V rows to 16-byte row stores
      bf16* sv = V + i0 * LDS;
      bf16* sk = K + i0 * LDS;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(sv + g * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(av[dt][0], av[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(sv + (g + 8) * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(av[dt][2], av[dt][3]);
        *reinterpret_cast<__nv_bfloat162*>(sk + g * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(ak[dt][0] * kscale, ak[dt][1] * kscale);
        *reinterpret_cast<__nv_bfloat162*>(sk + (g + 8) * LDS + dt * 8 + 2 * t4) =
            __floats2bfloat162_rn(ak[dt][2] * kscale, ak[dt][3] * kscale);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int idx = lane + 32 * it, r = idx >> 2, c = idx & 3;
        if (i0 + r < n) {
          const size_t off = (row0 + i0 + r) * ld + h * HD + c * 8;
          *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(sv + r * LDS + c * 8);
          *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(sk + r * LDS + c * 8);
        }
      }
    }
    __syncthreads();  // before the next image's strips and loads reuse the tiles and rows
  }
}

template <int NS, bool DENSE>
int launch_ns(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, size_t ld,
              float qscale, float scale, const float* table, const float* dense,
              int dense_windows, bf16* dq, bf16* dk, bf16* dv, float* dbias, int batch,
              int chunks, int C, int heads, WinMap m, cudaStream_t st) {
  const int tw = 2 * m.win - 1;
  const size_t smem = bwd_smem_bytes<NS>(tw * tw, DENSE);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(win_attn_bwd_mma_kernel<NS, DENSE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((m.Hp / m.win) * (m.Wp / m.win), heads, chunks);
  win_attn_bwd_mma_kernel<NS, DENSE><<<grid, 32 * NS, smem, st>>>(
      q, k, v, dout, ld, qscale, scale, qscale / scale, table, dense, dense_windows, dq, dk, dv,
      dbias, batch, C, heads, m);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_win_attn_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                             size_t ld, float qscale, float scale, const float* table,
                             const float* dense, int dense_windows, bf16* dq, bf16* dk, bf16* dv,
                             float* dbias, int batch, int chunks, int C, int heads, WinMap m,
                             cudaStream_t st) {
  const int n = m.win * m.win;
  if (C != heads * HD || n > 144 || (dense != nullptr && n % 4) || chunks < 1 || chunks > batch)
    return (int)cudaErrorInvalidValue;
#define GRIT_WAB_LAUNCH(NS)                                                                  \
  return dense != nullptr                                                                     \
             ? launch_ns<NS, true>(q, k, v, dout, ld, qscale, scale, table, dense,           \
                                   dense_windows, dq, dk, dv, dbias, batch, chunks, C, heads, \
                                   m, st)                                                     \
             : launch_ns<NS, false>(q, k, v, dout, ld, qscale, scale, table, dense,          \
                                    dense_windows, dq, dk, dv, dbias, batch, chunks, C,       \
                                    heads, m, st)
  if (n <= 64) GRIT_WAB_LAUNCH(4);
  GRIT_WAB_LAUNCH(9);
#undef GRIT_WAB_LAUNCH
}

}  // namespace grit
