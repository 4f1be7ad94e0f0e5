// Auction bid step: batched masked row-wise top-2 of (a - p), plain or with
// the benefit assembled from a raw cost matrix (the fused variant).
//
// Replaces the TPU kernels src/repro/kernels/lap_bid.py:lap_bid_pallas
// (_bid_kernel, _tile_top2, _merge_top2),
// src/repro/kernels/lap_bid.py:lap_bid_pallas_batched (_bid_kernel_batched)
// and, with kFused, src/repro/kernels/lap_bid.py:lap_bid_fused_pallas
// (_bid_fused_kernel, _fused_vals) and
// src/repro/kernels/lap_bid.py:lap_bid_fused_pallas_batched
// (_bid_fused_kernel_batched).  For every (instance b, row i):
//   vals[j]  = a[b, i, j] - p[b, j]           over the m real columns
//              (kFused: a[b, i, j] = (tb[b] * (i+1)^2) * (j+1) - cost[b, i, j],
//               i the row WITHIN the instance, assembled in registers)
//   best_v   = max_j vals[j],  best_j = first argmax
//   second   = max over j != best_j of vals[j], or -1e30 when m == 1
//              (the Pallas kernel's NEG_INF fill of the argmax cell)
//
// What bounds it on an H100: bytes read.  Each call reads a (B, n, m) f32
// matrix and (B, m) prices once (plus B tie-break scales when fused) and
// writes 12 bytes per row; there are a handful of flops per element, so it
// sits far below the card's compute ridge.  To reach HBM's rate every warp
// must keep many bytes in flight, in 16-byte loads:
//   * a GROUP of G lanes owns a row (the wrapper's launch_geometry picks G,
//     the fewest lanes, a power of two up to a warp, that leave each lane
//     about 16 columns or more): a row of m <= 16 columns (the auction's
//     4x4 / 8x8 pair LAPs) is one thread's, so a warp reads 32 consecutive
//     rows and writes each output as one coalesced 128-byte store; a row of
//     512 or 4096 columns is a warp's.  Rows are packed blockDim.x / G to a
//     CTA;
//   * a row is read as a scalar head up to the first 16-byte boundary
//     (from the row's address, so a ragged m or an offset view is taken
//     as it comes), a body of float4 chunks and a scalar tail.  Lane l of
//     the group reads chunks l, l + G, l + 2G, ... (G consecutive chunks per
//     step, so the group's loads are contiguous), kUnroll chunks at a time,
//     all loads issued before any is used;
//   * the instance's prices are read as float4 beside each chunk when the
//     price row has the same alignment as the cost row, and as four
//     scalars otherwise (they are L1/L2-resident: n rows share them);
//   * each lane keeps (best, arg, second) in registers, then a butterfly of
//     __shfl_xor_sync inside the group merges them.
//   * a row's instance, row / n, is a multiply and a shift by a divisor
//     the host computes once per launch (lap_bid.row_divisor), not a
//     division per row.
// Ties (the repo's fact F4): the Pallas merge lets the running (earlier
// tile) summary win; the equivalent rule here is "on equal values the
// LOWER column index wins".  A lane visits its columns in ascending order
// (lane 0's head, then chunks l, l + G, ... in the unrolled steps and the
// remainder, then the last lane's tail), so a strict compare keeps its
// first maximum; the lanes are merged comparing (v, j) explicitly, so the
// rule holds across them whatever their columns.
// The merged second is max(loser's best, both seconds), so a duplicated
// maximum gives second == best exactly as the reference does.
// Fused assembly: nvcc -O3 would contract "x * y - c" into one fma, which
// rounds once where the reference (XLA on the TPU, PyTorch's plain version)
// rounds after the multiply and again after the subtraction.  The assembly
// is written with __fmul_rn / __fsub_rn, which are never contracted, so
// every value is bit-identical to the plain version's even when the cost
// is not an integer.
// The launch geometry (lanes per row, threads per CTA, grid) and the
// divisor are decided by lap_bid.launch_geometry in Python and passed in;
// the entry points only refuse a geometry that would leave a row unread.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // lap_bid.py:NEG_INF
constexpr int kMaxThreads = 256;  // __launch_bounds__; the block may be smaller
constexpr int kUnroll = 4;        // float4 chunks each lane has in flight per step

// row / n without a division on the device: for row < 2^31 and n >= 2,
// row / n == umulhi(row, mul) >> shr (Granlund and Montgomery's rounding-up
// multiplier, exact on 31-bit dividends; lap_bid.row_divisor computes it).
struct RowDiv {
  unsigned mul;
  int shr;
};

// A running top-2: best value, its column, the best of the other columns.
struct Top2 {
  float best = -INFINITY, second = -INFINITY;
  int arg = INT_MAX;  // an empty summary loses every tie
};

// Column j after every column t has seen so far: a strict compare keeps the
// first maximum.
__device__ __forceinline__ void push(float v, int j, Top2& t) {
  if (v > t.best) {
    t.second = fmaxf(t.second, t.best);
    t.best = v;
    t.arg = j;
  } else {
    t.second = fmaxf(t.second, v);
  }
}

// Two summaries of any columns: on equal values the lower column wins.
__device__ __forceinline__ void merge_top2(Top2& t, const Top2& o) {
  const bool other = (o.best > t.best) || (o.best == t.best && o.arg < t.arg);
  const float loser = other ? t.best : o.best;
  if (other) {
    t.best = o.best;
    t.arg = o.arg;
  }
  t.second = fmaxf(loser, fmaxf(t.second, o.second));
}

template <bool kFused>
__device__ __forceinline__ float value(float a, float p, float ramp_i, int j) {
  if (kFused) return __fsub_rn(__fsub_rn(__fmul_rn(ramp_i, (float)(j + 1)), a), p);
  return __fsub_rn(a, p);
}

template <bool kFused>
__device__ __forceinline__ void push4(float4 x, float4 q, float ramp_i, int j, Top2& t) {
  push(value<kFused>(x.x, q.x, ramp_i, j), j, t);
  push(value<kFused>(x.y, q.y, ramp_i, j + 1), j + 1, t);
  push(value<kFused>(x.z, q.z, ramp_i, j + 2), j + 2, t);
  push(value<kFused>(x.w, q.w, ramp_i, j + 3), j + 3, t);
}

__device__ __forceinline__ float4 load_prices(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool kFused>
__global__ void __launch_bounds__(kMaxThreads)
lap_bid_kernel(const float* __restrict__ a, const float* __restrict__ p,
               const float* __restrict__ tb, float* __restrict__ best_v,
               int* __restrict__ best_j, float* __restrict__ second_v, long long rows,
               int n, int m, int group_log2, RowDiv div) {
  const int group = 1 << group_log2;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> group_log2) + (threadIdx.x >> group_log2);
  const int lane = threadIdx.x & (group - 1);
  const bool valid = row < rows;

  Top2 t;  // this lane's columns
  if (valid) {
    // rows < 2^31 on every real launch: a multiply and a shift, no division
    long long inst = row;
    if (rows >= (1LL << 31))
      inst = row / n;
    else if (n > 1)
      inst = __umulhi((unsigned)row, div.mul) >> div.shr;
    const float* arow = a + row * (long long)m;
    const float* prow = p + inst * (long long)m;
    float ramp_i = 0.0f;  // tb * (i+1)^2, i the row within the instance
    if (kFused) {
      const float gi = (float)(row - inst * n + 1);
      ramp_i = __fmul_rn(__ldg(tb + inst), __fmul_rn(gi, gi));
    }
    // scalar head up to the row's first 16-byte boundary, float4 body, tail
    int head = (int)((16 - (reinterpret_cast<uintptr_t>(arow) & 15)) & 15) >> 2;
    head = head < m ? head : m;
    const int chunks = (m - head) >> 2;
    const int body_end = head + 4 * chunks;
    const bool p_vec = (reinterpret_cast<uintptr_t>(prow + head) & 15) == 0;
    if (lane == 0) {
      for (int j = 0; j < head; ++j)
        push(value<kFused>(__ldg(arow + j), __ldg(prow + j), ramp_i, j), j, t);
    }
    const float4* body = reinterpret_cast<const float4*>(arow + head);
    int c = lane;
    for (; c + (kUnroll - 1) * group < chunks; c += kUnroll * group) {
      float4 x[kUnroll], q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(body + c + u * group);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) q[u] = load_prices(prow + head + 4 * (c + u * group), p_vec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        push4<kFused>(x[u], q[u], ramp_i, head + 4 * (c + u * group), t);
    }
    for (; c < chunks; c += group) {
      push4<kFused>(__ldg(body + c), load_prices(prow + head + 4 * c, p_vec), ramp_i,
                    head + 4 * c, t);
    }
    if (lane == group - 1) {
      for (int j = body_end; j < m; ++j)
        push(value<kFused>(__ldg(arow + j), __ldg(prow + j), ramp_i, j), j, t);
    }
  }
  // every lane of the warp takes part in the shuffles (no early return)
  for (int off = group >> 1; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.arg = __shfl_xor_sync(0xffffffffu, t.arg, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    merge_top2(t, o);
  }
  if (valid && lane == 0) {
    best_v[row] = t.best;
    best_j[row] = t.arg;
    second_v[row] = fmaxf(t.second, kNegInf);
  }
}

// grid CTAs of `threads` threads, `group` lanes to a row; row / n as
// umulhi(row, div_mul) >> div_shr.  cudaErrorInvalidValue where the group
// is not a power of two up to a warp, the block not whole warps, or the
// grid does not reach every row.
template <bool kFused>
int launch(const void* a, const void* prices, const void* tb, void* best_v,
           void* best_j, void* second_v, long long batch, long long n, long long m,
           int group, int threads, long long grid, unsigned div_mul, int div_shr,
           void* stream) {
  const long long rows = batch * n;
  int group_log2 = 0;
  while ((1 << group_log2) < group && group_log2 < 5) ++group_log2;
  const bool valid = group >= 1 && (1 << group_log2) == group && threads >= 32 &&
                     threads <= kMaxThreads && threads % 32 == 0 && grid >= 1 &&
                     grid <= INT_MAX && grid * (threads / group) >= rows;
  if (!valid) return (int)cudaErrorInvalidValue;
  lap_bid_kernel<kFused><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)prices, (const float*)tb, (float*)best_v,
      (int*)best_j, (float*)second_v, rows, (int)n, (int)m, group_log2,
      RowDiv{div_mul, div_shr});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lap_bid_batched(const void* a, const void* prices, void* best_v,
                               void* best_j, void* second_v, long long batch,
                               long long n, long long m, int group, int threads,
                               long long grid, unsigned div_mul, int div_shr,
                               void* stream) {
  return launch<false>(a, prices, nullptr, best_v, best_j, second_v, batch, n, m, group,
                       threads, grid, div_mul, div_shr, stream);
}

extern "C" int lap_bid_fused_batched(const void* cost, const void* prices,
                                     const void* tb, void* best_v, void* best_j,
                                     void* second_v, long long batch, long long n,
                                     long long m, int group, int threads,
                                     long long grid, unsigned div_mul, int div_shr,
                                     void* stream) {
  return launch<true>(cost, prices, tb, best_v, best_j, second_v, batch, n, m, group,
                      threads, grid, div_mul, div_shr, stream);
}
