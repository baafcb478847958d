// The bf16 GEMM of the Swin kernels on Hopper: out = epilogue(A W^T).
//
// Serves every bf16 product of K1 (qkv with the q-column scale; proj with the
// residual through the window map), K2 (fc1 with exact-erf GELU; fc2 with the
// row residual or none), K4 (qkv with A's rows gathered from the map in window
// order; proj stored through the map) and K10a (no bias): the products inside
// grit_tpu/ops/window_attention.py::_band_kernel, ::_mlp_kernel,
// ::_block_kernel and ::_lnlin_kernel.  Entered through grit_gemm
// (swin_block.cu); the fp32 parity path keeps its SIMT kernel there.
//
// What bounds it on an H100: the Swin-B products are tensor-core work (24 C^2
// flops a row a block, 1.36 TFLOP over a b8 384x640 forward: 1.4 ms at the
// bf16 peak), except at stage 1 (K = 128), where writing the qkv and the
// 4C-wide hidden makes it a memory pass.  The design:
// - a 128 x 128 output tile a block, computed by two consumer warpgroups that
//   each issue wgmma.mma_async m64n128k16 on their 64 rows (f32 accumulators
//   in registers), and one producer warp;
// - a ring of STAGES stages of (A 128 x 64, W 128 x 64) bf16 in shared memory
//   with the 128-byte swizzle, a full and an empty mbarrier each, so that the
//   producer keeps loads in flight while the consumers multiply;
// - A [M, K] and W [N, K] are both K-major, which is how wgmma reads A and a
//   transposed B: no operand is transposed;
// - loads by TMA (cp.async.bulk.tensor.2d; descriptors from
//   cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
//   that the library needs no -lcuda), rows beyond M filled with zeros by TMA.
//   Where A's rows are gathered from the map (K4's qkv), which TMA cannot do,
//   each consumer warpgroup loads its own 64 rows: a thread finds the source
//   tokens of its 4 rows once, then issues 16-byte cp.async copies into the
//   same swizzled layout (zero-filled beyond M) for the stage it has just
//   released, and signals the stage's barrier with
//   cp.async.mbarrier.arrive.noinc (one producer warp issuing all 1024 copies
//   of a stage could not keep the consumers fed);
// - the epilogue, its mode a template parameter, goes through the spent ring:
//   bias and column scale run in registers and the bf16 tile leaves by TMA
//   store; for exact-erf GELU, the row residual, and the residual and store
//   through the window map the f32 tile is staged and each lane takes 8
//   neighbouring columns of a row: 16-byte loads and stores, whole rows a
//   warp;
// - one tile a block, two blocks an SM (288 threads and ~98 KB of shared
//   memory each), so that one block's epilogue overlaps the other's main
//   loop (walking the tiles persistently was slower on an H100).
// Takes N % 8 == 0 and K % 8 == 0 (the Python wrappers check it; every
// product of the five Swin presets meets it): TMA's 16-byte global row stride
// and the epilogue's 8-column lanes.  N and K need not fill whole tiles: the
// tensor maps carry the real N and K, so TMA fills the boxes beyond them with
// zeros (and still counts the whole box in the barrier's transaction bytes),
// the gathered A loads zero-fill beyond K, the grid covers N's last partial
// column tile, and the epilogue predicates each 8-column lane (bias and
// residual reads, stores) on col < N; the bias epilogue's TMA store clips at N
// by itself.  A partial tile computes its zero columns all the same: at N =
// 288 (C 96's qkv) the last of three column tiles is a quarter used.
#include <cuda.h>

#include "common.cuh"

namespace grit {
namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int THREADS = 288;                  // warps 0-7: two consumer warpgroups; 8: producer
constexpr int TILE_BYTES = BM * BK * 2;       // one operand tile of a stage: 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // A then W
// 1024 bytes of slack to align the ring (the swizzle repeats every 1024
// bytes), the ring, the 2 x STAGES barriers
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int LDC = BN + 8;                   // floats: the epilogue's staged rows
static_assert(BM * LDC * 4 <= STAGES * STAGE_BYTES, "the staged tile fits in the ring");
constexpr unsigned long long HANG_NS = 4000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of `parity` has completed.  A barrier that never
// completes is a fault of this kernel: trap after HANG_NS rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > HANG_NS) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// a [BM rows x BK columns] box of shared memory -> the tensor of `map` at (c0, c1)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator reads across the wgmma waits
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}

template <int MODE, bool GATHER>
__global__ void __launch_bounds__(THREADS, 2) gemm_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_out, const bf16* __restrict__ A, int M, int N, int K,
    Epi e) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;  // full[s]: bars + 8s; empty[s]: + 8 STAGES
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;  // column tiles fastest: blocks in flight share A's rows
  const int ktiles = (K + BK - 1) / BK;  // the last k step's columns beyond K are zeros

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the TMA's expect_tx arrival, plus the 256 consumer threads' cp.async arrivals
      mbar_init(bars + 8 * s, GATHER ? 257 : 1);
      mbar_init(bars + 8 * (STAGES + s), 8);  // empty: one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer warp: W, and A unless its rows are gathered, by TMA
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
      if (lane == 0) {
        const uint32_t full = bars + 8 * s, sa = ring + s * STAGE_BYTES;
        mbar_expect_tx(full, GATHER ? TILE_BYTES : STAGE_BYTES);
        tma_load(sa + TILE_BYTES, &tm_w, full, kt * BK, n0);
        if (!GATHER) tma_load(sa, &tm_a, full, kt * BK, m0);
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroups: rows [wg * 64, wg * 64 + 64) of the tile
  const int wg = warp >> 2;
  // GATHER: the thread's 4 rows of A (16 apart) and its 16-byte chunk of their
  // 128-byte slice; chunk c of row r lands at chunk c ^ (r % 8), the 128-byte
  // swizzle that TMA and wgmma use
  long long src[4] = {-1ll, -1ll, -1ll, -1ll};
  const int gc = tid & 7, gr = wg * 64 + ((tid & 127) >> 3);
  auto load_a = [&](int kt, int stage) {
    const uint32_t sa = ring + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gr + 16 * i;
      // K % 8 == 0: the 16-byte chunk lies wholly inside or beyond K
      const bool in = src[i] >= 0 && kt * BK + gc * 8 < K;
      const bf16* p = in ? A + src[i] * K + kt * BK + gc * 8 : A;
      cp_async16(sa + r * 128 + ((gc ^ (r & 7)) << 4), p, in ? 16u : 0u);
    }
    cp_async_arrive(bars + 8 * stage);
  };
  if (GATHER) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool pad;
      const int row = m0 + gr + 16 * i;
      src[i] = row < M ? (long long)win_row_to_token(e.map, row, &pad) : -1ll;
    }
    for (int kt = 0; kt < STAGES && kt < ktiles; ++kt) load_a(kt, kt);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(bars + 8 * s, phase);
    // the gathered rows were written by cp.async (the generic proxy); wgmma
    // reads through the async proxy
    if (GATHER) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t sa = ring + s * STAGE_BYTES + wg * (64 * 128);
    const uint32_t sw = ring + s * STAGE_BYTES + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(acc, desc_sw128(sa + kk * 32), desc_sw128(sw + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0) {
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      // this warpgroup's rows of that stage are its own to refill
      if (GATHER && kt - 1 + STAGES < ktiles) load_a(kt - 1 + STAGES, prev);
    }
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue.  Stores from the accumulator layout (a bf16 pair a thread, 8
  // rows a warp instruction) cost as much as the main loop on an H100, so the
  // tile goes through the ring, which both warpgroups and the producer are
  // done with after this barrier of the consumers.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const int g = lane >> 2, q = lane & 3;
  const bf16* __restrict__ bias = static_cast<const bf16*>(e.bias);
  if constexpr (MODE == EPI_BIAS) {
    // bias and column scale: in registers, one rounding, the bf16 tile into
    // the ring as two [128 x 64] boxes in the 128-byte swizzle, out by TMA
    // (which clips the rows beyond M and the columns beyond N; a box wholly
    // beyond N is not stored)
    const int r0 = wg * 64 + (warp & 3) * 16 + g;  // r0 % 8 == g
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      float b0 = 0.0f, b1 = 0.0f;
      if (bias != nullptr && col < N) {  // N % 8 == 0: a pair lies wholly inside or beyond N
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        b0 = __low2float(b2);
        b1 = __high2float(b2);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (bias != nullptr) {
          v0 += b0;
          v1 += b1;
        }
        if (col < e.scale_cols) v0 *= e.scale;
        if (col + 1 < e.scale_cols) v1 *= e.scale;
        const int r = r0 + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(ring_ptr + (j >> 3) * (BM * 128) + r * 128 +
                                           (((j & 7) ^ g) << 4) + 4 * q) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (tid == 0) {
      tma_store(&tm_out, ring, n0, m0);
      if (n0 + 64 < N) tma_store(&tm_out, ring + BM * 128, n0 + 64, m0);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the ring outlives the reads
    }
    return;
  }
  // GELU (its erff in the accumulator layout ran slower than here), a
  // residual, or rows stored through the window map: the f32 tile through the
  // ring, then a lane takes 8 neighbouring columns of a row: 16-byte residual
  // and output accesses, two whole 256-byte rows a warp instruction
  float* stage = reinterpret_cast<float*>(ring_ptr) + (wg * 64 + (warp & 3) * 16) * LDC;
  {
    // thread (warp w of the warpgroup, lane l) holds rows 16 w + l / 4 and + 8,
    // columns 8 j + 2 (l % 4) + {0, 1}, j < 16, in acc[4 j + {0, 1}] and acc[4 j + {2, 3}]
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(stage + g * LDC + 8 * j + 2 * q) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (g + 8) * LDC + 8 * j + 2 * q) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncwarp();  // a warp reads back only the 16 rows it wrote

  const int row_base = m0 + wg * 64 + (warp & 3) * 16;
  // lanes 0-15 find the output row (and the pad flag) of the warp's row lane % 16
  long long my_orow = row_base + (lane & 15);
  int my_pad = 0;
  if ((MODE == EPI_RESID_MAP || MODE == EPI_MAP) && row_base + (lane & 15) < M) {
    bool pad;
    my_orow = (long long)win_row_to_token(e.map, row_base + (lane & 15), &pad);
    my_pad = pad;
  }
  const int c8 = (lane & 15) * 8, col = n0 + c8;
  const bool col_in = col < N;  // N % 8 == 0: the lane's 8 columns lie wholly inside or beyond N
  const bf16* __restrict__ resid = static_cast<const bf16*>(e.resid);
  bf16* __restrict__ out = static_cast<bf16*>(e.out);
  float bv[8];
  if (bias != nullptr && col_in) unpack8(*reinterpret_cast<const uint4*>(bias + col), bv);
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int rr = (lane >> 4) + 2 * it;
    const long long orow = __shfl_sync(0xffffffffu, my_orow, rr);
    const int pad = __shfl_sync(0xffffffffu, my_pad, rr);
    if (row_base + rr >= M || !col_in) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + rr * LDC + c8);
    const float4 hi = *reinterpret_cast<const float4*>(stage + rr * LDC + c8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (bias != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += bv[i];
    }
    if (MODE == EPI_GELU) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.5f * v[i] * (1.0f + erff(v[i] * 0.7071067811865476f));
    } else if (MODE == EPI_RESID || (MODE == EPI_RESID_MAP && !pad)) {
      float r[8];
      unpack8(*reinterpret_cast<const uint4*>(resid + orow * N + col), r);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += r[i];
    }
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + orow * N + col) = packed;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// TMA descriptor of a row-major bf16 [rows, cols] tensor, boxes of BM rows x BK columns
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
  cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                  box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int MODE, bool GATHER>
int launch(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& to, const bf16* A,
           int M, int N, int K, const Epi& e, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(gemm_bf16_sm90_kernel<MODE, GATHER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_sm90_kernel<MODE, GATHER><<<grid, THREADS, SMEM_BYTES, st>>>(ta, tw, to, A, M, N, K, e);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_gemm_bf16(const bf16* A, const bf16* W, int M, int N, int K, const Epi& e,
                     cudaStream_t st) {
  if (M <= 0) return 0;
  if (N <= 0 || K <= 0 || N % 8 || K % 8 || (e.a_gather && e.mode != EPI_BIAS))
    return (int)cudaErrorInvalidValue;
  // A, W and (for the bias epilogue, stored by TMA) the output
  CUtensorMap ta, tw, to;
  int err = tensor_map(&tw, W, N, K);
  if (err == 0 && e.mode == EPI_BIAS) err = tensor_map(&to, e.out, M, N);
  if (err == 0 && !e.a_gather) err = tensor_map(&ta, A, M, K);
  if (err != 0) return err;
  if (e.a_gather) return launch<EPI_BIAS, true>(tw, tw, to, A, M, N, K, e, st);
  switch (e.mode) {
    case EPI_BIAS: return launch<EPI_BIAS, false>(ta, tw, to, A, M, N, K, e, st);
    case EPI_GELU: return launch<EPI_GELU, false>(ta, tw, tw, A, M, N, K, e, st);
    case EPI_RESID: return launch<EPI_RESID, false>(ta, tw, tw, A, M, N, K, e, st);
    case EPI_RESID_MAP: return launch<EPI_RESID_MAP, false>(ta, tw, tw, A, M, N, K, e, st);
    case EPI_MAP: return launch<EPI_MAP, false>(ta, tw, tw, A, M, N, K, e, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace grit
