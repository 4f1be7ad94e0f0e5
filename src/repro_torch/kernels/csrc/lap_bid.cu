// Auction bid step: batched masked row-wise top-2 of (a - p).
//
// Replaces the TPU kernels src/repro/kernels/lap_bid.py:lap_bid_pallas
// (_bid_kernel, _tile_top2, _merge_top2) and
// src/repro/kernels/lap_bid.py:lap_bid_pallas_batched (_bid_kernel_batched).
// For every (instance b, row i):
//   vals[j]  = a[b, i, j] - p[b, j]           over the m real columns
//   best_v   = max_j vals[j],  best_j = first argmax
//   second   = max over j != best_j of vals[j], or -1e30 when m == 1
//              (the Pallas kernel's NEG_INF fill of the argmax cell)
//
// What bounds it on an H100: bytes.  Each call reads a (B, n, m) f32 matrix
// and (B, m) prices once and writes 12 bytes per row; there are three
// compares per element, so it sits far below the card's compute ridge.
// On the auction's main path the instances are tiny (4x4 node-pair LAPs,
// B = k_c^2) or one large square (the node match), so the design must keep
// lanes busy for both:
//   * a GROUP of G lanes owns one row, G = next_pow2(m) capped at 32 (a
//     4-column row uses 4 lanes, so a warp covers 8 rows and reads 32
//     consecutive floats); each lane strides the real columns
//     j = lane, lane+G, ... — no padded copy and no -1e30 fill, the ragged
//     edge is simply the loop bound;
//   * each lane keeps (best, arg, second) in registers, then a butterfly of
//     __shfl_xor_sync inside the group merges them.
// Ties (the repo's fact F4): the Pallas merge lets the running (earlier
// tile) summary win; lanes here interleave columns, so the equivalent rule
// is "on equal values the LOWER column index wins".  The merged second is
// max(loser's best, both seconds), so a duplicated maximum gives
// second == best exactly as the reference does.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // lap_bid.py:NEG_INF

__device__ __forceinline__ void merge_top2(float& best, int& arg, float& second,
                                           float o_best, int o_arg, float o_second) {
  const bool other = (o_best > best) || (o_best == best && o_arg < arg);
  const float loser = other ? best : o_best;
  if (other) {
    best = o_best;
    arg = o_arg;
  }
  second = fmaxf(loser, fmaxf(second, o_second));
}

__global__ void lap_bid_batched_kernel(const float* __restrict__ a,
                                       const float* __restrict__ p,
                                       float* __restrict__ best_v,
                                       int* __restrict__ best_j,
                                       float* __restrict__ second_v,
                                       long long rows, int n, int m,
                                       int group_log2) {
  const int group = 1 << group_log2;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid >> group_log2;
  const int lane = (int)(tid & (group - 1));
  const bool valid = row < rows;

  float best = -INFINITY, second = -INFINITY;
  int arg = INT_MAX;  // an empty lane loses every tie
  if (valid) {
    const float* arow = a + row * (long long)m;
    const float* prow = p + (row / n) * (long long)m;
    for (int j = lane; j < m; j += group) {
      const float v = arow[j] - prow[j];
      if (v > best) {  // strict: this lane's earlier (lower) column keeps a tie
        second = fmaxf(second, best);
        best = v;
        arg = j;
      } else {
        second = fmaxf(second, v);
      }
    }
  }
  // every lane of the warp takes part in the shuffles (no early return)
  for (int off = group >> 1; off > 0; off >>= 1) {
    const float o_best = __shfl_xor_sync(0xffffffffu, best, off);
    const int o_arg = __shfl_xor_sync(0xffffffffu, arg, off);
    const float o_second = __shfl_xor_sync(0xffffffffu, second, off);
    merge_top2(best, arg, second, o_best, o_arg, o_second);
  }
  if (valid && lane == 0) {
    best_v[row] = best;
    best_j[row] = arg;
    second_v[row] = fmaxf(second, kNegInf);
  }
}

}  // namespace

extern "C" int lap_bid_batched(const void* a, const void* prices, void* best_v,
                               void* best_j, void* second_v, long long batch,
                               long long n, long long m, void* stream) {
  const long long rows = batch * n;
  int group_log2 = 0;
  while ((1LL << group_log2) < m && group_log2 < 5) ++group_log2;
  const int threads = 256;
  const long long total = rows << group_log2;
  const long long blocks = (total + threads - 1) / threads;
  lap_bid_batched_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)prices, (float*)best_v, (int*)best_j,
      (float*)second_v, rows, (int)n, (int)m, group_log2);
  return (int)cudaGetLastError();
}
