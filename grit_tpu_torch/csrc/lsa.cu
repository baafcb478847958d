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
// Design: one block a problem (grid P), one thread a column, Q rounded up to
// whole warps (160 threads at Q = 150).  The problem's a is staged in shared
// memory transposed, so that row i0 is a contiguous read (Q x G x 4 bytes,
// 60 KB at the detector step's 150 x 100), with u, p and way beside it; a
// column's v, minv and used live in its thread's registers.  An iteration
// is the column-parallel update; the warp's least value by __reduce_min_sync
// on an order-preserving key, its first column by a ballot; the warps' minima
// to shared memory and one barrier; every thread merges them in column
// order, reads the loop's test (p[j1] < 0) and updates the potentials.  One
// barrier an iteration is enough: the next iteration reads u only at a row
// that this one did not write, and the minima go to two sets of slots in
// turn.  A barrier before the walk (thread 0) keeps it from writing p under
// the last iteration's reads.  n_valid is read on the device, so a launch needs no host value
// (CUDA graphs can capture it).
//
// What bounds it: neither bytes nor operations.  It reads the costs once
// (1.68 MB at P = 28, about 0.5 us at 3.35 TB/s), but each problem is a chain
// of dependent iterations, each a barrier and two reductions long, and the
// JAX solver's padding rows cost the most of them (row i of a zero row takes
// i + 1 iterations: ~5000 a problem at G = 100); 28 problems fill 28 of 132
// SMs.
#include "common.cuh"

namespace {

constexpr float LSA_INF = 3e38f;
constexpr int LSA_MAX_Q = 1024;
constexpr int LSA_SMEM_MAX = 232448;   // an H100 block's dynamic shared memory

// A float's bits as an unsigned key in the float's order; -0 reads as +0, as
// the two compare equal in the JAX solver's argmin.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// cost [P, Q, G] f32, n_valid [P] int64 -> assign [P, G] int64
__global__ void lsa_kernel(const float* __restrict__ cost, const long long* __restrict__ n_valid,
                           long long* __restrict__ assign, int Q, int G) {
  extern __shared__ float smem[];
  float* a = smem;                                     // [G][Q]
  float* u = a + (size_t)G * Q;                        // [G] row potentials
  int* p = reinterpret_cast<int*>(u + G);              // [Q + 1] column -> row, -1 free
  int* way = p + Q + 1;                                // [Q]
  // the warps' minima, two sets used in turn: [2][32] keys, columns, values
  unsigned* red_k = reinterpret_cast<unsigned*>(way + Q);
  int* red_j = reinterpret_cast<int*>(red_k + 64);
  float* red_v = reinterpret_cast<float*>(red_j + 64);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long nvl = n_valid[blockIdx.x];
  const int nv = nvl < 0 ? 0 : (nvl > G ? G : (int)nvl);
  const float* c = cost + (size_t)blockIdx.x * Q * G;
  for (int e = tid; e < Q * G; e += blockDim.x) {      // coalesced over the gt axis
    const int j = e / G, i = e - j * G;
    a[(size_t)i * Q + j] = i < nv ? c[e] : 0.0f;
  }
  for (int i = tid; i < G; i += blockDim.x) u[i] = 0.0f;
  for (int j = tid; j <= Q; j += blockDim.x) p[j] = -1;
  __syncthreads();   // before thread 0 sets p[Q] for row 0

  const bool col = tid < Q;
  float v = 0.0f;   // column tid's potential (the virtual column's is never read)

  for (int i = 0; i < G; ++i) {
    float minv = LSA_INF;
    bool used = false;
    if (tid == 0) p[Q] = i;
    if (col) way[tid] = 0;
    __syncthreads();
    int j0 = Q;
    for (int t = 0;; t ^= 1) {
      if (tid == j0) used = true;
      // u[i0] is not written in the iteration before: i0 = p[j0] is the row of
      // a column that was unused there, and no other column holds that row
      const int i0 = p[j0];
      const float ui0 = u[i0];
      float bv = LSA_INF;
      if (col && !used) {
        const float cur = (a[(size_t)i0 * Q + tid] - ui0) - v;
        if (cur < minv) {
          minv = cur;
          way[tid] = j0;
        }
        bv = minv;
      }
      // the warp's least (value, column): the lowest lane holding the least key
      const unsigned key = order_key(bv);
      const unsigned wmin = __reduce_min_sync(0xffffffffu, key);
      const int src = __ffs(__ballot_sync(0xffffffffu, key == wmin)) - 1;
      const float wv = __shfl_sync(0xffffffffu, bv, src);
      if (lane == 0) {
        red_k[t * 32 + warp] = wmin;
        red_j[t * 32 + warp] = warp * 32 + src;
        red_v[t * 32 + warp] = wv;
      }
      __syncthreads();
      unsigned bk = red_k[t * 32];
      int j1 = red_j[t * 32];
      float delta = red_v[t * 32];
      for (int w = 1; w < nwarps; ++w) {   // warps in column order: a tie keeps the first
        const unsigned k = red_k[t * 32 + w];
        if (k < bk) {
          bk = k;
          j1 = red_j[t * 32 + w];
          delta = red_v[t * 32 + w];
        }
      }
      const bool free_column = p[j1] < 0;
      if (col) {
        if (used) {
          u[p[tid]] += delta;
          v -= delta;
        } else {
          minv -= delta;
        }
      }
      if (tid == 0) u[i] += delta;   // the virtual column's row: p[Q] == i
      j0 = j1;
      if (free_column) break;
    }
    __syncthreads();   // every thread's reads of p and writes of u done
    if (tid == 0) {
      for (int j = j0; j != Q;) {
        const int jn = way[j];
        p[j] = p[jn];
        j = jn;
      }
    }
    __syncthreads();
  }

  long long* out = assign + (size_t)blockIdx.x * G;
  for (int i = tid; i < G; i += blockDim.x) out[i] = -1;
  __syncthreads();
  if (col) {
    const int r = p[tid];
    if (r >= 0 && r < nv) out[r] = tid;
  }
}

// The dynamic shared memory of a problem of Q queries and G gt rows (the
// wrapper, ops/lsa.py::smem_bytes, computes the same to refuse a shape).
long long lsa_smem_bytes(int Q, int G) { return 4LL * ((long long)G * Q + G + (Q + 1) + Q + 192); }

}  // namespace

extern "C" int grit_lsa(const void* cost, const void* n_valid, void* assign, int P, int Q, int G,
                        void* stream) {
  if (P <= 0) return 0;
  const long long smem = lsa_smem_bytes(Q, G);
  if (Q <= 0 || G <= 0 || Q > LSA_MAX_Q || G > Q || smem > LSA_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LSA_SMEM_MAX);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int threads = (Q + 31) / 32 * 32;
  lsa_kernel<<<P, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const long long*>(n_valid),
      static_cast<long long*>(assign), Q, G);
  return static_cast<int>(cudaGetLastError());
}
