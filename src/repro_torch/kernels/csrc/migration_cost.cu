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
// four int compares and three adds.  The design keeps everything but the
// stores off the critical path:
//   * a 2-D grid of 2-D blocks: threadIdx.x / blockIdx.x walk the columns in
//     pairs (TX pairs), threadIdx.y the rows (TY rows at once), and each
//     thread takes R rows.  The wrapper's launch_geometry picks them: TX =
//     next_pow2(ceil(V / 2)) clamped to [32, 256], so a narrow output does
//     not idle most of a block, TY = 256 / TX, and R = 8 on outputs of 2^21
//     cells and more, where fewer v-side loads per store pay (R = 1 below,
//     where latency rules: (g)'s 48x48 is one store per thread).  A y-block
//     covers TY * R rows and loops over row tiles past the grid's y limit.
//     No cell index is ever divided back into (u, v);
//   * each thread loads its v-side slots and weights once (two v's slots as
//     one int4, each v's weights as one double2) and keeps them in
//     registers for all its rows; a row's u-side operands are one broadcast
//     int2 + double2 load per warp;
//   * each thread writes two consecutive cells as one 16-byte double2
//     streaming store (__stcs), so a warp writes 512 contiguous bytes of a
//     row.  When V is odd an odd row starts 8 bytes past a 16-byte boundary:
//     there the thread's pair is shifted by one column (v = 2k + 1, 2k + 2)
//     and the row's cell 0 is a scalar head written by the pair-0 thread,
//     while an even row's last cell is a scalar tail.  Every cell is written
//     exactly once (held on the CPU by tests/test_torch_kernel_geometry.py).
// The launch geometry (block, rows per thread, row tiles, grid) is decided
// by migration_cost.launch_geometry in Python and passed in; the entry
// point only refuses one that would leave a cell unwritten.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // __launch_bounds__; the block may be smaller

__device__ __forceinline__ double cell(int2 a, double2 wa, int2 b, double2 wb) {
  const bool u0_in = (a.x == b.x) || (a.x == b.y);
  const bool u1_in = (a.y == b.x) || (a.y == b.y);
  const bool v0_in = (b.x == a.x) || (b.x == a.y);
  const bool v1_in = (b.y == a.x) || (b.y == a.y);
  const double cost_out = (u0_in ? 0.0 : wa.x) + (u1_in ? 0.0 : wa.y);
  const double cost_in = (v0_in ? 0.0 : wb.x) + (v1_in ? 0.0 : wb.y);
  return cost_out + cost_in;
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
migration_cost_kernel(const int* __restrict__ su, const int* __restrict__ sv,
                      const double* __restrict__ wu, const double* __restrict__ wv,
                      double* __restrict__ out, long long U, long long V,
                      long long row_tiles) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // column pair
  const long long v0 = 2 * k;
  if (v0 >= V) return;
  const int2* su2 = reinterpret_cast<const int2*>(su);
  const int2* sv2 = reinterpret_cast<const int2*>(sv);
  const double2* wu2 = reinterpret_cast<const double2*>(wu);
  const double2* wv2 = reinterpret_cast<const double2*>(wv);
  // the v-side operands of columns 2k, 2k+1 and (V odd: odd rows) 2k+2
  int2 b0, b1 = make_int2(0, 0), b2 = b1;
  double2 w0, w1 = make_double2(0.0, 0.0), w2 = w1;
  if (v0 + 1 < V) {
    const int4 b01 = __ldg(reinterpret_cast<const int4*>(sv) + k);
    b0 = make_int2(b01.x, b01.y);
    b1 = make_int2(b01.z, b01.w);
    w1 = __ldg(wv2 + v0 + 1);
  } else {
    b0 = __ldg(sv2 + v0);
  }
  w0 = __ldg(wv2 + v0);
  const bool odd_v = (V & 1) != 0;
  if (odd_v && v0 + 2 < V) {
    b2 = __ldg(sv2 + v0 + 2);
    w2 = __ldg(wv2 + v0 + 2);
  }
  const long long tile_rows = (long long)blockDim.y * R;
  for (long long tile = blockIdx.y; tile < row_tiles; tile += gridDim.y) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long u = tile * tile_rows + (long long)r * blockDim.y + threadIdx.y;
      if (u >= U) break;
      const int2 a = __ldg(su2 + u);
      const double2 wa = __ldg(wu2 + u);
      double* row = out + u * V;
      // row u starts 8 bytes past a 16-byte boundary iff u * V is odd
      const bool shifted = odd_v && (u & 1);
      const long long v = v0 + (shifted ? 1 : 0);
      const int2 bl = shifted ? b1 : b0, bh = shifted ? b2 : b1;
      const double2 wl = shifted ? w1 : w0, wh = shifted ? w2 : w1;
      if (v + 1 < V) {
        __stcs(reinterpret_cast<double2*>(row + v),
               make_double2(cell(a, wa, bl, wl), cell(a, wa, bh, wh)));
      } else if (v < V) {
        __stcs(row + v, cell(a, wa, bl, wl));  // tail: an even row's last cell
      }
      if (shifted && k == 0) __stcs(row, cell(a, wa, b0, w0));  // head: cell 0
    }
  }
}

}  // namespace

// grid (grid_x, grid_y) of blocks (tx, ty), each thread taking `rows` rows
// (1, 2, 4 or 8) of each row tile; cudaErrorInvalidValue where that does
// not cover the (U, V) output.  ev_start / ev_end, when not null, are CUDA
// events recorded on the stream right before and right after the launch
// (a traced span's device timer).
extern "C" int migration_cost(const void* slots_u, const void* slots_v,
                              const void* w_u, const void* w_v, void* out,
                              long long U, long long V, int tx, int ty, int rows,
                              long long row_tiles, long long grid_x, long long grid_y,
                              void* stream, void* ev_start, void* ev_end) {
  const bool covers = tx >= 1 && ty >= 1 && tx * ty <= kMaxThreads && grid_x >= 1 &&
                      grid_x <= INT_MAX && grid_y >= 1 && grid_y <= 65535 &&
                      grid_x * tx * 2 >= V && row_tiles * ty * rows >= U;
  void (*kernel)(const int*, const int*, const double*, const double*, double*, long long,
                 long long, long long) = nullptr;
  switch (rows) {
    case 1: kernel = migration_cost_kernel<1>; break;
    case 2: kernel = migration_cost_kernel<2>; break;
    case 4: kernel = migration_cost_kernel<4>; break;
    case 8: kernel = migration_cost_kernel<8>; break;
  }
  if (!covers || kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (ev_start != nullptr && (e = cudaEventRecord((cudaEvent_t)ev_start, s)) != cudaSuccess)
    return (int)e;
  kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), dim3(tx, ty), 0, s>>>(
      (const int*)slots_u, (const int*)slots_v, (const double*)w_u, (const double*)w_v,
      (double*)out, U, V, row_tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (ev_end != nullptr && (e = cudaEventRecord((cudaEvent_t)ev_end, s)) != cudaSuccess)
    return (int)e;
  return (int)cudaSuccess;
}
