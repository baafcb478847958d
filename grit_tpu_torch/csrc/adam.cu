// K12: the single-pass Adam update, as one multi-tensor launch per parameter
// group.
//
// Replaces the TPU's grit_tpu/ops/fused_adam.py::_adam_kernel (reached through
// _adam_flat_pallas / scale_by_adam_flat) and folds in the two jnp ops that
// follow it there, apply_lr and optax.apply_updates: the kernel also applies
// the update to the parameter in the same pass, p += -lr (u + wd p).
//
// What it computes is _adam_math op for op in f32, each operation rounded
// once (the __f*_rn intrinsics are never contracted into an FMA, so the
// result is the plain version's, up to an ulp of sqrt and division):
//   mu' = (1 - b1) g + b1 mu          nu' = (1 - b2) g^2 + b2 nu
//   u   = (mu' / c1) / (sqrt(nu' / c2 + eps_root) + eps)
// with c1 = 1 - b1^t, c2 = 1 - b2^t computed on the host in f32.
//
// What bounds it on an H100: bytes.  4 reads (p, g, mu, nu) and 3 writes
// (p, mu', nu') of 4 bytes per element, 28 bytes against ~12 operations, so
// the least time is 28 x elements / 3.35 TB/s.  The TPU version concatenated
// the gradients into flat ~32 MB buckets because XLA fuses per leaf; here
// nothing is moved: a table in device memory holds each leaf's four pointers
// and its size, a second table maps every block to (leaf, chunk of the leaf),
// and one launch walks all leaves of a group.  A chunk is 4096 elements: 256
// threads x 4 rounds of one float4 (16 bytes a thread, neighbouring threads
// on neighbouring addresses) where the leaf's four pointers are 16-byte
// aligned, scalar accesses otherwise and on a leaf's ragged tail.
#include "common.cuh"

namespace grit {

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_CHUNK = 4096;

struct AdamScalars {
  float omb1, b1, omb2, b2, c1, c2, eps, eps_root, neg_lr, wd;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& mu, float& nu,
                                         const AdamScalars& s) {
  const float mu2 = __fadd_rn(__fmul_rn(s.omb1, g), __fmul_rn(s.b1, mu));
  const float nu2 = __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(g, g)), __fmul_rn(s.b2, nu));
  const float mu_hat = __fdiv_rn(mu2, s.c1);
  const float nu_hat = __fdiv_rn(nu2, s.c2);
  float u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, s.eps_root)), s.eps));
  if (s.wd != 0.0f) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
  mu = mu2;
  nu = nu2;
}

// ptrs: [leaves, 4] addresses (p, g, mu, nu); sizes: [leaves] elements;
// chunks: [blocks] (leaf, chunk index within the leaf)
__global__ void __launch_bounds__(ADAM_THREADS) adam_kernel(
    const long long* __restrict__ ptrs, const long long* __restrict__ sizes,
    const int2* __restrict__ chunks, AdamScalars s) {
  const int2 ch = chunks[blockIdx.x];
  const long long* lp = ptrs + 4 * (size_t)ch.x;
  float* p = reinterpret_cast<float*>(lp[0]);
  const float* g = reinterpret_cast<const float*>(lp[1]);
  float* mu = reinterpret_cast<float*>(lp[2]);
  float* nu = reinterpret_cast<float*>(lp[3]);
  const long long n = sizes[ch.x];
  const long long start = (long long)ch.y * ADAM_CHUNK;
  const long long end = start + ADAM_CHUNK < n ? start + ADAM_CHUNK : n;
  const bool aligned = (((lp[0] | lp[1] | lp[2] | lp[3]) & 15) == 0);
  // whole float4 groups of this chunk (start is a multiple of 4)
  const long long vec_end = aligned ? start + ((end - start) & ~3LL) : start;
  for (long long i = start + 4 * threadIdx.x; i < vec_end; i += 4 * ADAM_THREADS) {
    float4 pv = *reinterpret_cast<float4*>(p + i);
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    float4 mv = *reinterpret_cast<float4*>(mu + i);
    float4 nv = *reinterpret_cast<float4*>(nu + i);
    adam_one(pv.x, gv.x, mv.x, nv.x, s);
    adam_one(pv.y, gv.y, mv.y, nv.y, s);
    adam_one(pv.z, gv.z, mv.z, nv.z, s);
    adam_one(pv.w, gv.w, mv.w, nv.w, s);
    *reinterpret_cast<float4*>(p + i) = pv;
    *reinterpret_cast<float4*>(mu + i) = mv;
    *reinterpret_cast<float4*>(nu + i) = nv;
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += ADAM_THREADS) {
    float pv = p[i], mv = mu[i], nv = nu[i];
    adam_one(pv, g[i], mv, nv, s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
  }
}

}  // namespace grit

extern "C" int grit_adam(const void* ptrs, const void* sizes, const void* chunks, int n_chunks,
                         float omb1, float b1, float omb2, float b2, float c1, float c2,
                         float eps, float eps_root, float neg_lr, float wd, void* stream) {
  using namespace grit;
  if (n_chunks > 0) {
    const AdamScalars s = {omb1, b1, omb2, b2, c1, c2, eps, eps_root, neg_lr, wd};
    adam_kernel<<<n_chunks, ADAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(ptrs), static_cast<const long long*>(sizes),
        static_cast<const int2*>(chunks), s);
  }
  return static_cast<int>(cudaGetLastError());
}
