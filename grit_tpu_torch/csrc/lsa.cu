// The detector's Hungarian matcher on the card: an exact linear sum
// assignment per (level, image) problem, all problems in one launch.
//
// Replaces no Pallas kernel: it ports grit_tpu/detection/losses.py
// ::_device_lsa_single, the JAX package's on-device solver (lax control flow,
// vmapped over the problems), which its criterion takes for
// match_impl="auto" on every backend but the CPU.  PyTorch has no device-side
// while loop, so a solver written in torch ops would read a flag on the host
// at every Dijkstra iteration; here the loops run on the device and the
// criterion makes no host round trip.
//
// What it computes, for each problem: the shortest-augmenting-path Hungarian
// algorithm (the Jonker-Volgenant core) on a[i][j] = cost[j][i] (rows = gt
// boxes, columns = queries; a = 0 on the padding rows i >= n_valid), with
// the JAX solver's fp32 operations in the same order, so that its
// assignments are the JAX solver's where costs tie:
//   for each row i in order (padding rows included): p[Q] = i, then the
//   Dijkstra loop until p[j0] < 0:
//     used[j0] = true; i0 = p[j0]
//     cur[j] = (a[i0][j] - u[i0]) - v[j] on the unused columns
//     where cur < minv: minv = cur, way = j0
//     j1 = the FIRST column of least minv among the unused, delta = minv[j1]
//     u[p[j]] += delta on every used column (the virtual one, Q, included),
//     v[j] -= delta on the used columns, minv[j] -= delta on the others
//   then the augmenting walk back through way.
// "Infinity" is the finite 3e38 of the JAX solver, so that delta * 0 stays 0.
// Output: assign[i] = j where p[j] == i, -1 for i >= n_valid, as int64.
//
// Design: one warp a problem.  A block of LSA_THREADS stages the problem's a
// in shared memory, transposed so that row i0 is contiguous (Q x G x 4
// bytes, 60 KB at the detector step's 150 x 100; 16-byte loads where the
// costs are aligned); then every warp but the first leaves, and the first
// solves with no block barrier.  Lane l owns the C = ceil(Q / 32) columns
// l*C .. l*C + C-1 (a template argument; at odd C, 5 at Q = 150, the row's
// reads hit distinct banks), and keeps their v, minv, way, p and the
// potential u of the row each holds in registers, indexed only in unrolled
// loops.  u travels with its column: a Dijkstra iteration reads u only at
// i0 = p[j0], the row of a column that was unused until then, whose u no
// iteration of this row has moved; rows past i are 0 until their turn; and
// the walk moves a row's u with its p.  An iteration's chain: the lane's C
// reads of row i0; cur and minv; the lane's least masked minv (fminf); its
// order key; the warp's least key (__reduce_min_sync), which is also delta;
// its lowest lane (ballot, __ffs); three shuffles from that lane (the
// column, its row, the row's u), which give the loop's test and the next
// i0.  The lane's first column holding its least, and the potential updates,
// run beside that chain.  The augmenting walk runs by shuffles along the
// owner lanes (~100-270 steps a problem against ~5000 iterations).  n_valid
// is read on the device, so a launch needs no host value (CUDA graphs can
// capture it).
//
// What bounds it: neither bytes nor operations.  It reads the costs once
// (1.68 MB at P = 28, about 0.5 us at 3.35 TB/s), but each problem is a chain
// of dependent iterations, and the JAX solver's padding rows cost the most of
// them (row i of a zero row takes i + 1 iterations: 5050 a problem of fill 0
// or 1 at G = 100).  A call lasts about its longest problem's chain times the
// time of an iteration: 5050 x ~138 ns = 0.70 ms at [28, 150, 100] on an
// H100 at 700 W, against ~405 ns for the block design it replaced (a barrier
// and a five-warp merge an iteration); the staging takes ~8 us of it.
// Moving the next row's loads, a tree for the lane's minimum, a second
// reduction for the lowest lane, or cutting the potential updates out each
// moves an iteration by 1% or less (kernel_variants.py): what is left is the
// latency of the shared read, the warp reduction, the ballot and the
// shuffle.  28 problems fill 28 of 132 SMs, and a 61 KB block leaves room
// for 3 problems an SM.
#include "common.cuh"

namespace {

constexpr float LSA_INF = 3e38f;
constexpr int LSA_MAX_Q = 1024;
constexpr int LSA_SMEM_MAX = 232448;   // an H100 block's dynamic shared memory
constexpr int LSA_THREADS = 128;       // the staging warps; the first then solves
constexpr unsigned FULL = 0xffffffffu;

// A float's bits as an unsigned key in the float's order; -0 reads as +0, as
// the two compare equal in the JAX solver's argmin.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The float of an order key (a -0 comes back as +0: only a zero's sign can
// differ from the JAX solver's delta, which no sum or comparison here sees).
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// x[k] of a register array, k uniform or not, without indexing it at run time
template <int C, typename T>
__device__ __forceinline__ T pick(const T (&x)[C], int k) {
  T r = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) r = c == k ? x[c] : r;
  return r;
}

// The problem's costs into a [G][Q] (transposed), 0 on the rows past nv.
__device__ __forceinline__ void stage(const float* __restrict__ c, float* a, int Q, int G, int nv) {
  const int n = Q * G;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(c) & 15) == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    for (int e4 = threadIdx.x; e4 < n / 4; e4 += blockDim.x) {
      const float4 x = __ldg(c4 + e4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * e4 + t, j = e / G, i = e - j * G;
        a[(size_t)i * Q + j] = i < nv ? xs[t] : 0.0f;
      }
    }
    e0 = n / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x) {   // coalesced over the gt axis
    const int j = e / G, i = e - j * G;
    a[(size_t)i * Q + j] = i < nv ? __ldg(c + e) : 0.0f;
  }
}

// cost [P, Q, G] f32, n_valid [P] int64 -> assign [P, G] int64; C columns a lane
template <int C>
__global__ void __launch_bounds__(LSA_THREADS, 1) lsa_kernel(const float* __restrict__ cost,
                                                          const long long* __restrict__ n_valid,
                                                          long long* __restrict__ assign, int Q,
                                                          int G) {
  extern __shared__ float a[];   // [G][Q], then 32 spare words
  const long long nvl = n_valid[blockIdx.x];
  const int nv = nvl < 0 ? 0 : (nvl > G ? G : (int)nvl);
  stage(cost + (size_t)blockIdx.x * Q * G, a, Q, G, nv);
  __syncthreads();
  if (threadIdx.x >= 32) return;   // one warp solves; no barrier from here on

  const int lane = threadIdx.x, base = lane * C;
  // the lane's columns past Q: always "used", so never picked; their reads
  // stay inside the array (a lane wholly past Q reads columns 0 .. C-1, the
  // one across Q at most C - 1 words past the last row: the 32 spare words)
  const int ncol = Q - base;
  const unsigned pad = ncol >= C ? 0u : (ncol <= 0 ? FULL : FULL << ncol);
  const float* cols = a + (ncol > 0 ? base : 0);
  float v[C], minv[C], uc[C];   // uc: u of the row the column holds
  int pc[C], way[C];            // pc: the column's row, -1 free
#pragma unroll
  for (int k = 0; k < C; ++k) {
    v[k] = 0.0f;
    uc[k] = 0.0f;
    pc[k] = -1;
    way[k] = 0;
  }

  for (int i = 0; i < G; ++i) {
    unsigned used = pad;
#pragma unroll
    for (int k = 0; k < C; ++k) minv[k] = LSA_INF;
    float ucur = 0.0f;          // u[i], the virtual column's row (0 until its turn)
    int j0 = Q;
    float ui0 = 0.0f;
    float x[C];                 // row i0 of a at the lane's columns
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = cols[(size_t)i * Q + k];
    for (;;) {
      float bv[C];   // minv, 3e38 on the used columns: the JAX solver's masked minv
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const bool free_k = !((used >> k) & 1u);
        const float cur = (x[k] - ui0) - v[k];
        if (free_k && cur < minv[k]) {
          minv[k] = cur;
          way[k] = j0;
        }
        bv[k] = free_k ? minv[k] : LSA_INF;
      }
      // the lane's least masked minv (fminf: a zero's sign aside, the same),
      // and beside the warp's reduction its first column holding it
      float lmin = bv[0];
#pragma unroll
      for (int k = 1; k < C; ++k) lmin = fminf(lmin, bv[k]);
      int kb = C - 1;
#pragma unroll
      for (int k = C - 1; k >= 0; --k) kb = bv[k] == lmin ? k : kb;
      // the warp's least key, and its lowest lane: the first column holding it
      const unsigned key = order_key(lmin);
      const unsigned wmin = __reduce_min_sync(FULL, key);
      const int src = __ffs(__ballot_sync(FULL, key == wmin)) - 1;
      const float delta = key_value(wmin);
      const int k1 = __shfl_sync(FULL, kb, src);
      const int p1 = __shfl_sync(FULL, pick(pc, kb), src);
      const float u1 = __shfl_sync(FULL, pick(uc, kb), src);
      // the next iteration's row (row 0 after the last iteration)
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = cols[(size_t)max(p1, 0) * Q + k];
      // potentials: used columns' rows +delta and their v -delta, the others' minv -delta
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if ((used >> k) & 1u) {
          uc[k] += delta;
          v[k] -= delta;
        } else {
          minv[k] -= delta;
        }
      }
      ucur += delta;
      if (lane == src) used |= 1u << k1;
      j0 = src * C + k1;
      if (p1 < 0) break;
      ui0 = u1;
    }
    // the augmenting walk from the free column j0: p[j] = p[way[j]] back to
    // the virtual column, each row's u with it
    int owner = j0 / C, kk = j0 - owner * C;
    int jn = __shfl_sync(FULL, pick(way, kk), owner);
    for (;;) {
      int pn = i, on = 0, kn = 0, wn = 0;
      float un = ucur;
      if (jn != Q) {
        on = jn / C;
        kn = jn - on * C;
        pn = __shfl_sync(FULL, pick(pc, kn), on);
        un = __shfl_sync(FULL, pick(uc, kn), on);
        wn = __shfl_sync(FULL, pick(way, kn), on);
      }
      if (lane == owner) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          if (k == kk) {
            pc[k] = pn;
            uc[k] = un;
          }
        }
      }
      if (jn == Q) break;
      owner = on;
      kk = kn;
      jn = wn;
    }
  }

  long long* out = assign + (size_t)blockIdx.x * G;
  for (int r = nv + lane; r < G; r += 32) out[r] = -1;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (base + k < Q && pc[k] >= 0 && pc[k] < nv) out[pc[k]] = base + k;
}

template <int C>
int launch(const float* cost, const long long* n_valid, long long* assign, int P, int Q, int G,
           size_t smem, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lsa_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, LSA_SMEM_MAX);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  lsa_kernel<C><<<P, LSA_THREADS, smem, stream>>>(cost, n_valid, assign, Q, G);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a problem of Q queries and G gt rows (the
// wrapper, ops/lsa.py::smem_bytes, computes the same to refuse a shape).
long long lsa_smem_bytes(int Q, int G) { return 4LL * (G * Q + 32); }

}  // namespace

extern "C" int grit_lsa(const void* cost, const void* n_valid, void* assign, int P, int Q, int G,
                        void* stream) {
  if (P <= 0) return 0;
  const long long smem = lsa_smem_bytes(Q, G);
  if (Q <= 0 || G <= 0 || Q > LSA_MAX_Q || G > Q || smem > LSA_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const float*>(cost);
  const auto* nv = static_cast<const long long*>(n_valid);
  auto* out = static_cast<long long*>(assign);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  // the least instance with 32 * C >= Q
  switch ((Q + 31) / 32) {
    case 1: return launch<1>(c, nv, out, P, Q, G, sm, st);
    case 2: return launch<2>(c, nv, out, P, Q, G, sm, st);
    case 3: return launch<3>(c, nv, out, P, Q, G, sm, st);
    case 4: return launch<4>(c, nv, out, P, Q, G, sm, st);
    case 5: return launch<5>(c, nv, out, P, Q, G, sm, st);
    case 6: return launch<6>(c, nv, out, P, Q, G, sm, st);
    case 7: case 8: return launch<8>(c, nv, out, P, Q, G, sm, st);
    case 9: case 10: case 11: case 12: return launch<12>(c, nv, out, P, Q, G, sm, st);
    case 13: case 14: case 15: case 16: return launch<16>(c, nv, out, P, Q, G, sm, st);
    case 17: case 18: case 19: case 20: case 21: case 22: case 23: case 24:
      return launch<24>(c, nv, out, P, Q, G, sm, st);
    default: return launch<32>(c, nv, out, P, Q, G, sm, st);
  }
}
