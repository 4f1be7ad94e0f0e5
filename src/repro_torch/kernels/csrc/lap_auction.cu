// The whole Jacobi forward auction on the card: one launch per solve, from
// the first bid round to each instance's own stop, with no host read inside.
//
// Replaces, on the auction's main path, the host-driven loop around the bid
// kernels: the TPU kernels src/repro/kernels/lap_bid.py:lap_bid_pallas
// (:149) and lap_bid_pallas_batched (:176) (K1/K2), lap_bid_fused_pallas
// (:343) and lap_bid_fused_pallas_batched (:373) (K3/K4), each called once
// per bid round, and the JAX loop around them,
// src/repro/core/matching/auction.py:173-207 (the lax.while_loop body/cond,
// which XLA compiles into one program on the TPU).  Per instance it computes
// what lap_auction.py's docstring states: top-2 of (a - p) for every
// unassigned row (first argmax; the lower column wins a tie (F4); second =
// max(max over the other columns, neg)); offer = p[j*] + ((best - second) +
// eps); offers > -5e17 bid; each column takes the highest offer, the lowest
// row on a tie, at the offer's own bits; a complete assignment with eps >
// thr restarts the phase at max(eps * 0.2f, eps_min); every step counts one
// iteration.  Every float operation is the plain loop's, written with the
// _rn intrinsics so nvcc contracts nothing, so results are bit-identical.
// kFused assembles the benefit as lap_bid.cu does:
// (tb * (i+1)^2) * (j+1) - cost.
//
// What bounds it on an H100: neither bytes nor operations.  The inputs are
// read once (1 MiB for a 512x512 f32 instance: 0.31 us at 3.35 TB/s), but
// an auction is a serial chain of thousands of data-dependent rounds, most
// with a handful of bidders.  A round's cost is its latency: a few barriers
// and one pass over the bidders' rows.  The design keeps that chain on the
// chip and each round short:
//   * warp regime (m <= 32, the 262,144 4x4 or 8x8 pair LAPs): a group of
//     G = next_pow2(m) lanes owns one instance; lane l holds row l of the
//     benefit in registers and column l's price and owner.  A bid round is
//     shuffles inside the group (prices to the rows, offers to the columns,
//     owners back to the rows); no shared memory and no block barrier.  Each
//     group stops on its own; a warp loops until its last group has stopped
//     and the stopped groups do nothing.
//   * cluster regime (larger m: the 512x512 node match, the packing LAPs up
//     to ~640x1320): a thread-block cluster of up to 16 CTAs per instance.
//     Each CTA holds a band of rows in shared memory (loaded once; from L2
//     when the band does not fit) and its own replica of the prices and
//     owners, so the top-2's reads never leave the SM.  Warps take the
//     band's unassigned rows from a compacted list.  A bid is a 64-bit
//     atomicMax of (order-preserving bits of offer) << 32 | (0xFFFFFFFF -
//     row) into the bidder's OWN CTA's partial keys: the highest offer
//     wins, the lowest row on a tie.  After a cluster barrier each CTA
//     merges the partials of its slice of the columns (j % cluster == rank)
//     by remote reads through distributed shared memory; after a second one
//     every CTA reads the merged winners and applies the same updates to its
//     replica, so every CTA decides to go on or stop from the same state.
//     (64-bit atomics into ANOTHER CTA's shared memory lost updates on the
//     H100, so remote memory is only read.)  Partial and merged keys are
//     double-buffered by round: a CTA clears its partials of the last round
//     before this round's first barrier, when every merge of them is done.
//   * wide regime (an instance whose replicated column state, 40 bytes a
//     column, does not fit a CTA's shared memory: m above ~5,700): one CTA
//     per instance, its per-column state in global memory (L2-resident:
//     12 bytes a column besides the prices), the prices and the assignment
//     kept in place in the outputs.  Nothing is shared across CTAs, so a
//     bid is a 64-bit atomicMax into the instance's own keys in global
//     memory, read back after a block barrier.  Right before fast: it is
//     the only plan for such widths.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBidFloor = -5e17f;  // lap_auction.py:BID_FLOOR
constexpr float kEpsStep = 0.2f;     // lap_auction.py:EPS_STEP
constexpr int kWarpThreads = 256;     // lap_auction.py:WARP_THREADS
constexpr int kClusterThreads = 512;  // lap_auction.py:CLUSTER_THREADS
constexpr int kMaxCluster = 16;       // lap_auction.py:MAX_CLUSTER
constexpr int kWideThreads = 1024;    // lap_auction.py:WIDE_THREADS

// the offer a row bids: p[j*] + ((best - second) + eps), second floored at neg
__device__ __forceinline__ float offer_of(float best, float second, float pbest, float eps,
                                          float neg) {
  return __fadd_rn(pbest, __fadd_rn(__fsub_rn(best, fmaxf(second, neg)), eps));
}

// a f32 as an unsigned integer of the same order (larger float, larger key)
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long bid_key(float offer, int row) {
  return ((unsigned long long)ordered_bits(offer) << 32) | (0xffffffffu - (unsigned)row);
}

// --------------------------------------------------------------------------
// warp regime: one group of G lanes per instance, all state in registers
// --------------------------------------------------------------------------
template <bool kFused, int G>
__global__ void __launch_bounds__(kWarpThreads)
auction_warp_kernel(const float* __restrict__ a, const float* __restrict__ tb,
                    const float* __restrict__ p0, const int* __restrict__ col0,
                    const float* __restrict__ eps0, const float* __restrict__ eps_min_v,
                    const float* __restrict__ thr_v, int* __restrict__ col_out,
                    float* __restrict__ p_out, int* __restrict__ it_out,
                    float* __restrict__ eps_out, long long batch, int n, int m,
                    int max_iters, float neg) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long inst = tid / G;
  const int l = (int)(tid % G);  // my row and my column within the instance
  const bool valid = inst < batch;
  const unsigned wl = threadIdx.x & 31u;
  const unsigned gmask = G == 32 ? kFull : (((1u << G) - 1u) << (wl & ~(unsigned)(G - 1)));

  float arow[G];  // row l of the benefit (assembled when fused)
  float price = 0.f, eps = 0.f, eps_min = 0.f, thr = 0.f;
  int mycol = -1, owner = -1;
#pragma unroll
  for (int j = 0; j < G; ++j) arow[j] = 0.f;
  if (valid) {
    eps = eps0[inst];
    eps_min = eps_min_v[inst];
    thr = thr_v[inst];
    if (l < m) price = p0[inst * m + l];
    if (l < n) {
      mycol = col0[inst * n + l];
      const float* ar = a + (inst * n + l) * (long long)m;
      float ramp = 0.f;  // tb * (i+1)^2
      if (kFused) {
        const float gi = (float)(l + 1);
        ramp = __fmul_rn(tb[inst], __fmul_rn(gi, gi));
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < m) {
          const float c = ar[j];
          arow[j] = kFused ? __fsub_rn(__fmul_rn(ramp, (float)(j + 1)), c) : c;
        }
      }
    }
  }
  // the owner of my column in the initial assignment
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int c = __shfl_sync(kFull, mycol, i, G);
    if (i < n && c == l) owner = i;
  }

  int it = 0;
  while (true) {
    const int assigned = __popc(__ballot_sync(kFull, valid && l < n && mycol >= 0) & gmask);
    const bool all = assigned == n;
    const bool active = valid && !(all && eps <= thr) && it < max_iters;
    if (!__any_sync(kFull, active)) break;
    const bool phase = all;  // active and complete: eps > thr

    // top-2 of my row against the group's prices (lowest column on a tie)
    float best = 0.f, second = -INFINITY, pbest = 0.f;
    int arg = -1;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float pj = __shfl_sync(kFull, price, j, G);
      if (j < m) {
        const float v = __fsub_rn(arow[j], pj);
        if (arg < 0 || v > best) {
          if (arg >= 0) second = fmaxf(second, best);
          best = v;
          arg = j;
          pbest = pj;
        } else {
          second = fmaxf(second, v);
        }
      }
    }
    float offer = 0.f;
    int bid_col = -1;
    if (active && !phase && l < n && mycol < 0) {
      offer = offer_of(best, second, pbest, eps, neg);
      if (offer > kBidFloor) bid_col = arg;
    }
    // my column takes the highest offer, the lowest row first
    int win = -1;
    float win_offer = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float oi = __shfl_sync(kFull, offer, i, G);
      const int ci = __shfl_sync(kFull, bid_col, i, G);
      if (ci == l && (win < 0 || oi > win_offer)) {
        win = i;
        win_offer = oi;
      }
    }
    const int new_owner = win >= 0 ? win : owner;
    // my row learns whether it holds (or won) its column
    const int target = mycol >= 0 ? mycol : (bid_col >= 0 ? bid_col : 0);
    const int o = __shfl_sync(kFull, new_owner, target, G);
    if (active) {
      if (phase) {
        mycol = -1;
        owner = -1;
        eps = fmaxf(__fmul_rn(eps, kEpsStep), eps_min);
      } else {
        if (win >= 0) {
          price = win_offer;
          owner = win;
        }
        if (mycol >= 0) {
          if (o != l) mycol = -1;
        } else if (bid_col >= 0) {
          mycol = o == l ? bid_col : -1;
        }
      }
      ++it;
    }
  }
  if (valid) {
    if (l < n) col_out[inst * n + l] = mycol;
    if (l < m) p_out[inst * m + l] = price;
    if (l == 0) {
      it_out[inst] = it;
      eps_out[inst] = eps;
    }
  }
}

// --------------------------------------------------------------------------
// cluster regime: one thread-block cluster per instance
// --------------------------------------------------------------------------
__host__ __device__ inline long long cluster_smem(long long m, long long rows, bool smem_rows) {
  // lap_auction.py:cluster_smem
  return 40 * m + 8 * rows + (smem_rows ? 4 * rows * m : 0);
}

// one warp's top-2 of row arow[0..m) - price (lanes stride the columns,
// then a butterfly merge; lap_bid.cu's rule: the lower column wins a tie)
template <bool kFused>
__device__ __forceinline__ void warp_top2(const float* arow, const float* price, int m,
                                          float ramp_i, int lane, float& best, int& arg,
                                          float& second, float& pbest) {
  best = -INFINITY;
  second = -INFINITY;
  pbest = 0.f;
  arg = INT_MAX;  // a lane with no column loses every tie
  for (int j = lane; j < m; j += 32) {
    const float pj = price[j];
    const float aj = arow[j];
    const float v = kFused ? __fsub_rn(__fsub_rn(__fmul_rn(ramp_i, (float)(j + 1)), aj), pj)
                           : __fsub_rn(aj, pj);
    if (arg == INT_MAX || v > best) {  // strict: this lane's lower column keeps a tie
      second = fmaxf(second, best);
      best = v;
      arg = j;
      pbest = pj;
    } else {
      second = fmaxf(second, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o_best = __shfl_xor_sync(kFull, best, off);
    const int o_arg = __shfl_xor_sync(kFull, arg, off);
    const float o_second = __shfl_xor_sync(kFull, second, off);
    const float o_pbest = __shfl_xor_sync(kFull, pbest, off);
    const bool other = (o_best > best) || (o_best == best && o_arg < arg);
    const float loser = other ? best : o_best;
    if (other) {
      best = o_best;
      arg = o_arg;
      pbest = o_pbest;
    }
    second = fmaxf(loser, fmaxf(second, o_second));
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kClusterThreads)
auction_cluster_kernel(const float* __restrict__ a, const float* __restrict__ tb,
                       const float* __restrict__ p0, const int* __restrict__ col0,
                       const float* __restrict__ eps0, const float* __restrict__ eps_min_v,
                       const float* __restrict__ thr_v, int* __restrict__ col_out,
                       float* __restrict__ p_out, int* __restrict__ it_out,
                       float* __restrict__ eps_out, int n, int m, int max_iters, float neg,
                       int rows_per_cta, int smem_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long inst = blockIdx.x / csize;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* part = reinterpret_cast<unsigned long long*>(smem);  // [2][m] my bids
  unsigned long long* merged = part + 2 * (size_t)m;  // [2][m] my column slice's winners
  float* price = reinterpret_cast<float*>(merged + 2 * (size_t)m);  // [m] replica
  int* owner = reinterpret_cast<int*>(price + m);                   // [m] replica
  int* colof = owner + m;                                           // [rows] my band
  int* list = colof + rows_per_cta;                                 // [rows] bidders
  float* rows = reinterpret_cast<float*>(list + rows_per_cta);      // [rows][m]
  __shared__ int s_nlist, s_assigned, s_new[2];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int row0 = rank * rows_per_cta;
  const int nrows = max(0, min(rows_per_cta, n - row0));
  const float* ainst = a + inst * (long long)n * m;
  const int* cinst = col0 + inst * (long long)n;

  for (int k = tid; k < 2 * m; k += nthreads) part[k] = 0ull;
  for (int j = tid; j < m; j += nthreads) {
    price[j] = p0[inst * m + j];
    owner[j] = -1;
  }
  for (int r = tid; r < nrows; r += nthreads) colof[r] = cinst[row0 + r];
  if (smem_rows) {
    const float* band = ainst + (long long)row0 * m;
    for (long long k = tid; k < (long long)nrows * m; k += nthreads) rows[k] = band[k];
  }
  if (tid == 0) {
    s_nlist = 0;
    s_assigned = 0;
    s_new[0] = s_new[1] = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < n; i += nthreads) {
    const int c = cinst[i];
    if (c >= 0) {
      owner[c] = i;
      ++mine;
    }
  }
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0 && mine) atomicAdd(&s_assigned, mine);
  __syncthreads();
  int assigned = s_assigned;
  float eps = eps0[inst];
  const float eps_min = eps_min_v[inst], thr = thr_v[inst];
  const float tbi = kFused ? tb[inst] : 0.f;
  cluster.sync();  // every CTA of the cluster runs before any remote read

  int it = 0, round = 0;
  while (true) {
    const bool all = assigned == n;
    if ((all && eps <= thr) || it >= max_iters) break;
    if (all) {  // phase change: keep the prices, restart the assignment
      for (int j = tid; j < m; j += nthreads) owner[j] = -1;
      for (int r = tid; r < nrows; r += nthreads) colof[r] = -1;
      assigned = 0;
      eps = fmaxf(__fmul_rn(eps, kEpsStep), eps_min);
      ++it;
      __syncthreads();
      continue;
    }
    const int q = round & 1;
    unsigned long long* part_q = part + (size_t)q * m;
    unsigned long long* merged_q = merged + (size_t)q * m;
    // (1) this CTA's unassigned rows, compacted
    for (int r = tid; r < nrows; r += nthreads)
      if (colof[r] < 0) list[atomicAdd(&s_nlist, 1)] = r;
    __syncthreads();
    const int nbid = s_nlist;
    // (2) one warp per bidder: top-2, offer, a 64-bit atomicMax into this
    // CTA's own partial keys
    for (int k = warp; k < nbid; k += nwarps) {
      const int r = list[k];
      const int i = row0 + r;
      const float* arow = smem_rows ? rows + (size_t)r * m : ainst + (long long)i * m;
      float ramp_i = 0.f;
      if (kFused) {
        const float gi = (float)(i + 1);
        ramp_i = __fmul_rn(tbi, __fmul_rn(gi, gi));
      }
      float best, second, pbest;
      int arg;
      warp_top2<kFused>(arow, price, m, ramp_i, lane, best, arg, second, pbest);
      if (lane == 0) {
        const float offer = offer_of(best, second, pbest, eps, neg);
        if (offer > kBidFloor) atomicMax(part_q + arg, bid_key(offer, i));
      }
    }
    // my partial keys of two rounds back: every CTA merged them before the
    // last round's second barrier, and I write them again after this one's
    unsigned long long* part_old = part + (size_t)(q ^ 1) * m;
    for (int j = tid; j < m; j += nthreads) part_old[j] = 0ull;
    cluster.sync();  // (3) every CTA's bids are in
    // (4) merge: column j's winner over the cluster's partial keys, in the
    // CTA that owns j's slice (j % csize == rank)
    for (int j = rank + tid * csize; j < m; j += nthreads * csize) {
      unsigned long long best = 0ull;
      for (int c = 0; c < csize; ++c) {
        const unsigned long long v = cluster.map_shared_rank(part_q, c)[j];
        best = v > best ? v : best;
      }
      merged_q[j] = best;
    }
    cluster.sync();  // (5) every column's winner is published
    // (6) every CTA applies the same winners to its replica
    int fresh = 0;
    for (int j = tid; j < m; j += nthreads) {
      const unsigned long long key = cluster.map_shared_rank(merged_q, j % csize)[j];
      if (key) {
        const int w = (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
        const int prev = owner[j];
        owner[j] = w;
        price[j] = from_ordered((unsigned)(key >> 32));
        if (prev < 0) {
          ++fresh;
        } else if (prev >= row0 && prev < row0 + nrows) {
          colof[prev - row0] = -1;
        }
        if (w >= row0 && w < row0 + nrows) colof[w - row0] = j;
      }
    }
    fresh = __reduce_add_sync(kFull, fresh);
    if (lane == 0 && fresh) atomicAdd(&s_new[q], fresh);
    if (tid == 0) {
      s_nlist = 0;
      s_new[q ^ 1] = 0;
    }
    __syncthreads();
    assigned += s_new[q];
    ++it;
    ++round;
  }
  cluster.sync();  // no CTA leaves while another may still read its keys
  for (int r = tid; r < nrows; r += nthreads) col_out[inst * n + row0 + r] = colof[r];
  if (rank == 0) {
    for (int j = tid; j < m; j += nthreads) p_out[inst * m + j] = price[j];
    if (tid == 0) {
      it_out[inst] = it;
      eps_out[inst] = eps;
    }
  }
}

// --------------------------------------------------------------------------
// wide regime: one CTA per instance, the per-column state in global memory
// --------------------------------------------------------------------------
template <bool kFused>
__global__ void __launch_bounds__(kWideThreads)
auction_wide_kernel(const float* __restrict__ a, const float* __restrict__ tb,
                    const float* __restrict__ p0, const int* __restrict__ col0,
                    const float* __restrict__ eps0, const float* __restrict__ eps_min_v,
                    const float* __restrict__ thr_v, int* col_out, float* p_out,
                    int* __restrict__ it_out, float* __restrict__ eps_out, long long batch,
                    int n, int m, int max_iters, float neg, unsigned char* scratch) {
  const long long inst = blockIdx.x;
  const float* ainst = a + inst * (long long)n * m;
  // the instance's working state: prices and assignment in place in the
  // outputs (no __restrict__: written and read back), the rest in the
  // scratch of lap_auction.py:wide_scratch bytes: (B, m) u64 bid keys,
  // (B, m) int32 owners, (B, n) int32 bidders
  float* price = p_out + inst * m;
  int* colof = col_out + inst * n;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch) + inst * m;
  int* owner = reinterpret_cast<int*>(scratch + 8 * batch * m) + inst * m;
  int* list = reinterpret_cast<int*>(scratch + 12 * batch * m) + inst * n;
  __shared__ int s_nlist, s_assigned, s_new[2];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  for (int j = tid; j < m; j += nthreads) {
    price[j] = p0[inst * m + j];
    owner[j] = -1;
    keys[j] = 0ull;
  }
  for (int i = tid; i < n; i += nthreads) colof[i] = col0[inst * n + i];
  if (tid == 0) {
    s_nlist = 0;
    s_assigned = 0;
    s_new[0] = s_new[1] = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < n; i += nthreads) {
    const int c = colof[i];
    if (c >= 0) {
      owner[c] = i;
      ++mine;
    }
  }
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0 && mine) atomicAdd(&s_assigned, mine);
  __syncthreads();
  int assigned = s_assigned;
  float eps = eps0[inst];
  const float eps_min = eps_min_v[inst], thr = thr_v[inst];
  const float tbi = kFused ? tb[inst] : 0.f;

  // every thread holds the same assigned / eps / it: one decision per instance
  int it = 0, round = 0;
  while (true) {
    const bool all = assigned == n;
    if ((all && eps <= thr) || it >= max_iters) break;
    if (all) {  // phase change: keep the prices, restart the assignment
      for (int j = tid; j < m; j += nthreads) owner[j] = -1;
      for (int i = tid; i < n; i += nthreads) colof[i] = -1;
      assigned = 0;
      eps = fmaxf(__fmul_rn(eps, kEpsStep), eps_min);
      ++it;
      __syncthreads();
      continue;
    }
    const int q = round & 1;
    // (1) the unassigned rows, compacted
    for (int i = tid; i < n; i += nthreads)
      if (colof[i] < 0) list[atomicAdd(&s_nlist, 1)] = i;
    __syncthreads();
    const int nbid = s_nlist;
    // (2) one warp per bidder: top-2, offer, a 64-bit atomicMax into the keys
    for (int k = warp; k < nbid; k += nwarps) {
      const int i = list[k];
      float ramp_i = 0.f;
      if (kFused) {
        const float gi = (float)(i + 1);
        ramp_i = __fmul_rn(tbi, __fmul_rn(gi, gi));
      }
      float best, second, pbest;
      int arg;
      warp_top2<kFused>(ainst + (long long)i * m, price, m, ramp_i, lane, best, arg, second,
                        pbest);
      if (lane == 0) {
        const float offer = offer_of(best, second, pbest, eps, neg);
        if (offer > kBidFloor) atomicMax(keys + arg, bid_key(offer, i));
      }
    }
    __syncthreads();
    // (3) every column with bids takes its winner; the keys are read past L1
    int fresh = 0;
    for (int j = tid; j < m; j += nthreads) {
      const unsigned long long key = __ldcg(keys + j);
      if (key) {
        __stcg(keys + j, 0ull);
        const int w = (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
        const int prev = owner[j];
        owner[j] = w;
        price[j] = from_ordered((unsigned)(key >> 32));
        if (prev < 0) {
          ++fresh;
        } else {
          colof[prev] = -1;
        }
        colof[w] = j;
      }
    }
    fresh = __reduce_add_sync(kFull, fresh);
    if (lane == 0 && fresh) atomicAdd(&s_new[q], fresh);
    if (tid == 0) {
      s_nlist = 0;
      s_new[q ^ 1] = 0;
    }
    __syncthreads();
    assigned += s_new[q];
    ++it;
    ++round;
  }
  if (tid == 0) {
    it_out[inst] = it;
    eps_out[inst] = eps;
  }
}

template <bool kFused>
cudaError_t launch_wide(const float* a, const float* tb, const float* p0, const int* col0,
                        const float* eps0, const float* eps_min, const float* thr, int* col_out,
                        float* p_out, int* it_out, float* eps_out, long long batch, int n, int m,
                        int max_iters, float neg, unsigned char* scratch, cudaStream_t stream) {
  auction_wide_kernel<kFused><<<(unsigned)batch, kWideThreads, 0, stream>>>(
      a, tb, p0, col0, eps0, eps_min, thr, col_out, p_out, it_out, eps_out, batch, n, m,
      max_iters, neg, scratch);
  return cudaGetLastError();
}

template <bool kFused>
cudaError_t launch_cluster(const float* a, const float* tb, const float* p0, const int* col0,
                           const float* eps0, const float* eps_min, const float* thr,
                           int* col_out, float* p_out, int* it_out, float* eps_out,
                           long long batch, int n, int m, int max_iters, float neg,
                           int csize, int rows, int smem_rows, size_t smem,
                           cudaStream_t stream) {
  auto kernel = auction_cluster_kernel<kFused>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  if (csize > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * csize));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, tb, p0, col0, eps0, eps_min, thr, col_out, p_out,
                            it_out, eps_out, n, m, max_iters, neg, rows, smem_rows);
}

template <bool kFused, int G>
cudaError_t launch_warp(const float* a, const float* tb, const float* p0, const int* col0,
                        const float* eps0, const float* eps_min, const float* thr, int* col_out,
                        float* p_out, int* it_out, float* eps_out, long long batch, int n, int m,
                        int max_iters, float neg, cudaStream_t stream) {
  const long long blocks = (batch * G + kWarpThreads - 1) / kWarpThreads;
  auction_warp_kernel<kFused, G><<<(unsigned)blocks, kWarpThreads, 0, stream>>>(
      a, tb, p0, col0, eps0, eps_min, thr, col_out, p_out, it_out, eps_out, batch, n, m,
      max_iters, neg);
  return cudaGetLastError();
}

template <bool kFused>
cudaError_t dispatch_warp(int group, const float* a, const float* tb, const float* p0,
                          const int* col0, const float* eps0, const float* eps_min,
                          const float* thr, int* col_out, float* p_out, int* it_out,
                          float* eps_out, long long batch, int n, int m, int max_iters,
                          float neg, cudaStream_t s) {
#define LAP_AUCTION_WARP(G)                                                               \
  case G:                                                                                 \
    return launch_warp<kFused, G>(a, tb, p0, col0, eps0, eps_min, thr, col_out, p_out,   \
                                  it_out, eps_out, batch, n, m, max_iters, neg, s);
  switch (group) {
    LAP_AUCTION_WARP(1)
    LAP_AUCTION_WARP(2)
    LAP_AUCTION_WARP(4)
    LAP_AUCTION_WARP(8)
    LAP_AUCTION_WARP(16)
    LAP_AUCTION_WARP(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef LAP_AUCTION_WARP
}

}  // namespace

// a (B, n, m) f32 (a COST matrix when fused, with tb (B,)); p0 (B, m) f32;
// col0 (B, n) int32; eps0, eps_min, thr (B,) f32.  Writes col_out (B, n)
// int32, p_out (B, m) f32, it_out (B,) int32, eps_out (B,) f32.  group > 0
// is the warp regime with that many lanes per instance; cluster > 0 the
// cluster regime, CTAs of rows_per_cta rows each with smem bytes of dynamic
// shared memory; both 0 the wide regime, one CTA per instance working in
// scratch (wide_scratch bytes of device memory).  The wrapper's plan is
// checked against this file's.
extern "C" int lap_auction(const void* a, const void* tb, const void* p0, const void* col0,
                           const void* eps0, const void* eps_min, const void* thr,
                           void* col_out, void* p_out, void* it_out, void* eps_out,
                           long long batch, long long n, long long m, long long max_iters,
                           double neg, int fused, int group, int cluster, int rows_per_cta,
                           int threads, int smem_rows, long long smem, void* scratch,
                           void* stream) {
  if (batch <= 0 || n <= 0 || m < n || max_iters < 0 || max_iters > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float ng = (float)neg;
  const float* A = (const float*)a;
  const float* TB = (const float*)tb;
  const float* P0 = (const float*)p0;
  const int* C0 = (const int*)col0;
  const float* E0 = (const float*)eps0;
  const float* EM = (const float*)eps_min;
  const float* TH = (const float*)thr;
  int* CO = (int*)col_out;
  float* PO = (float*)p_out;
  int* IO = (int*)it_out;
  float* EO = (float*)eps_out;
  cudaError_t e;
  if (group > 0) {
    int want = 1;
    while (want < m) want *= 2;
    if (group != want || group > 32 || threads != kWarpThreads || cluster != 0)
      return (int)cudaErrorInvalidValue;  // the plan and this file disagree
    e = fused ? dispatch_warp<true>(group, A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch,
                                    (int)n, (int)m, (int)max_iters, ng, s)
              : dispatch_warp<false>(group, A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch,
                                     (int)n, (int)m, (int)max_iters, ng, s);
  } else if (cluster == 0) {
    if (threads != kWideThreads || rows_per_cta != n || smem != 0 || smem_rows != 0 ||
        scratch == nullptr || batch > INT_MAX)
      return (int)cudaErrorInvalidValue;  // the plan and this file disagree
    unsigned char* SC = (unsigned char*)scratch;
    e = fused ? launch_wide<true>(A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch, (int)n,
                                  (int)m, (int)max_iters, ng, SC, s)
              : launch_wide<false>(A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch, (int)n,
                                   (int)m, (int)max_iters, ng, SC, s);
  } else {
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
        threads != kClusterThreads || (long long)rows_per_cta * cluster < n ||
        smem != cluster_smem(m, rows_per_cta, smem_rows != 0))
      return (int)cudaErrorInvalidValue;  // the plan and this file disagree
    e = fused ? launch_cluster<true>(A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch, (int)n,
                                     (int)m, (int)max_iters, ng, cluster, rows_per_cta,
                                     smem_rows, (size_t)smem, s)
              : launch_cluster<false>(A, TB, P0, C0, E0, EM, TH, CO, PO, IO, EO, batch, (int)n,
                                      (int)m, (int)max_iters, ng, cluster, rows_per_cta,
                                      smem_rows, (size_t)smem, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
