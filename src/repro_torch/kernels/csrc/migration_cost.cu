// Algorithm-3 pairwise migration-cost matrix, f64.
//
// Replaces the TPU kernel src/repro/kernels/migration_cost.py:
// migration_cost_pallas (_cost_kernel).  For GPU u (previous round) holding
// job set JS_u and GPU v (new round) holding JS_v:
//   C[u, v] = sum_{j in JS_u symdiff JS_v} 1 / (2 * num_gpus(j)),
// from the dense slot encoding (P = MAX_PACK = 2 job ids per GPU, -1 empty)
// and per-slot weights (0 for empty slots, gathered by the wrapper with
// EMPTY remapped explicitly — never by wrap-around indexing).
//
// Exactness: the host path computes this in numpy f64
// (repro core/migration.py:pairwise_migration_cost), and the engine's
// tie-break test `benefit == rint(benefit)` makes a single ulp change the
// round's path, so the kernel is f64 and reproduces numpy's operation order
// bit for bit:  cost_out = w_u0*m0 + w_u1*m1, cost_in likewise, then
// cost_out + cost_in.  The 0/1 mask products are written as selects
// (present ? 0 : w), which are exact for the non-negative weights and leave
// nothing for FMA contraction to change.  (The TPU kernel is f32 only
// because the TPU lacks f64.)
//
// What bounds it on an H100: bytes written.  The (U, V) f64 output is the
// whole traffic (inputs are 24 bytes per GPU, U + V GPUs); each cell costs
// four int compares and three adds.  One thread per output cell, row-major,
// so a warp stores 256 contiguous bytes and the u-row operands are
// broadcast loads from L1.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void migration_cost_kernel(const int* __restrict__ su,
                                      const int* __restrict__ sv,
                                      const double* __restrict__ wu,
                                      const double* __restrict__ wv,
                                      double* __restrict__ out,
                                      long long U, long long V) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= U * V) return;
  const long long u = idx / V;
  const long long v = idx - u * V;
  const int u0 = su[2 * u], u1 = su[2 * u + 1];
  const int v0 = sv[2 * v], v1 = sv[2 * v + 1];
  const bool u0_in = (u0 == v0) || (u0 == v1);
  const bool u1_in = (u1 == v0) || (u1 == v1);
  const bool v0_in = (v0 == u0) || (v0 == u1);
  const bool v1_in = (v1 == u0) || (v1 == u1);
  const double cost_out = (u0_in ? 0.0 : wu[2 * u]) + (u1_in ? 0.0 : wu[2 * u + 1]);
  const double cost_in = (v0_in ? 0.0 : wv[2 * v]) + (v1_in ? 0.0 : wv[2 * v + 1]);
  out[idx] = cost_out + cost_in;
}

}  // namespace

extern "C" int migration_cost(const void* slots_u, const void* slots_v,
                              const void* w_u, const void* w_v, void* out,
                              long long U, long long V, void* stream) {
  const int threads = 256;
  const long long blocks = (U * V + threads - 1) / threads;
  migration_cost_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)slots_u, (const int*)slots_v, (const double*)w_u,
      (const double*)w_v, (double*)out, U, V);
  return (int)cudaGetLastError();
}
