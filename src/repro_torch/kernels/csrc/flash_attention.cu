// Flash attention forward (online softmax), causal or not, with GQA routing.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel).  For every (batch b, query head h)
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(D)) v[b, j, h/G]
// over keys j < S (and j <= i when causal), G = H / KV query heads per KV
// head.  Inputs are read in their (B, S, heads, D) layout (last dim
// contiguous), so the model's q/k/v need no transpose and the KV heads are
// never repeated; the output is written contiguous (B, S, H, D).  Running
// max, denominator and accumulator are f32; denom = max(l, 1e-30); the
// result is cast to the input type (round to nearest even for bf16).  The
// ragged S edge is masked from indices (keys >= S get no weight, rows >= S
// are not written): no zero-padded copy of the inputs.  Tiles above the
// causal diagonal are never loaded and only the diagonal tile is masked;
// query tiles are issued heaviest first (reverse order), so the long causal
// rows do not trail the grid.
//
// What bounds it on an H100: operations.  A causal call does 4*B*H*S^2*D/2
// flops (S = 8192, H = 32, D = 128: 5.5e11, 0.56 ms at the 989 TFLOP/s bf16
// tensor-core peak) against a few bytes per flop of traffic.
//
// Two instances:
//
// * bf16 (namespace tc): the tensor-core kernel, in the layout of
//   FlashAttention-3.
//   - Work.  A work item is a (b*h, 128-query tile) pair.  A persistent
//     grid of one CTA an SM (the block's registers and shared memory allow
//     no second) walks the items heaviest first, each CTA taking one a
//     round and the rounds running back and forth over the CTAs, so that
//     their sums of work stay even.  The next item's Q and K/V then load
//     under this one's last tiles and epilogue (2.5-5 % over one CTA an
//     item at S 8192).
//   - Roles.  384 threads, three warpgroups, split by one if/else that
//     never reconverges.  Warpgroup 2, the producer, runs setmaxnreg.dec to
//     24 registers; one of its threads issues every TMA load: each item's Q,
//     then its K/V tiles of 128 keys through a 3-stage ring whose stages
//     and phases run on across the items.  A 4-D tensor map per operand,
//     dims (D, heads, S, B), reads through the caller's strides; with the
//     128-byte swizzle a row of D = 128 is two 64-wide boxes, "panels".
//     Q and each stage have a full and an empty mbarrier.  Warpgroups 0 and
//     1, the consumers, own 64 query rows each and run setmaxnreg.inc to
//     240: 24 x 128 + 240 x 256 = 168 x 384, the block's grant under
//     __launch_bounds__(384, 1).  The launch refuses an instance that ptxas
//     granted fewer, since setmaxnreg.inc would then wait for ever.  ptxas
//     allocates past 168 in the consumers' branch only while that branch
//     holds no trap instruction (with one it spills and serialises the
//     wgmma, C7512), so only the producer's barrier waits trap (after ~10 s).
//   - Q in registers.  Each consumer loads its 64 rows of an item's Q once,
//     by ldmatrix, into the A fragments of Q K^T (D/4 registers a thread)
//     and gives Q's buffer back (its empty barrier counts the 8 consumer
//     warps).  S = Q K^T is then a register-A wgmma (m64n128k16, K K-major
//     in shared memory) that reads only K there: at D = 192 an m64n64k16
//     step from shared memory would read as many bytes of Q as of K (Q in
//     registers measured 1-6 % faster at every D).
//   - Softmax.  The online softmax runs on the f32 accumulator fragment
//     (row max and sum over the 4 threads of a quad, exp2 on the SFU); P is
//     rounded to bf16 in registers, where the accumulator's pairs are
//     already the A fragment of the register-A wgmma that computes
//     O += P V (V read MN-major, the transpose flag set).
//   - Overlap inside a warpgroup.  S(t+1) = Q K(t+1)^T and O += P(t) V(t)
//     are issued together as two commit groups; the warpgroup waits for
//     S(t+1) only (wgmma.wait_group 1) and runs softmax(t+1) while P(t) V(t)
//     is still on the tensor cores, then rescales O once that group has
//     retired.  O, S(t+1), P(t) and Q are live at once (D 128: 64 + 64 + 32
//     + 32 registers), which is what the 240 registers are for.  A stage
//     goes back to the producer (its empty barrier counts one arrival per
//     warpgroup) once the P V that read its V has retired.
//   - Overlap between the warpgroups, up to a 128-wide row.  Two named
//     barriers (ids 1 and 2, 256 threads: a warpgroup waits on its own, the
//     other arrives) hand the turn to issue GEMMs back and forth: warpgroup
//     0 issues its tile's GEMMs, then lets warpgroup 1 issue its own and
//     runs its softmax while they run.  Per item, warpgroup 1 arrives once
//     before its first tile, so warpgroup 0 goes first, and skips its
//     arrival after its last: both see the same number of tiles, so every
//     wait meets its arrival and none is left over.  Past a 128-wide row
//     (D = 192, 64-key tiles) the warpgroups issue as they come
//     (takes_turns): with turns that instance measured 4-8 % slower.
//   - D = 80 (zamba2's), not a whole number of panels, is laid out at the
//     padded width DP = 128, the D = 128 instance's shared memory.  The
//     tensor maps keep the real D as their innermost dim, so TMA zero-fills
//     columns D .. DP-1 of the second panel (out of the map's bounds even
//     where memory runs on, as in a fused-qkv view; the transaction count
//     is the whole box).  Q K^T runs only the D/16 k-steps that hold data;
//     P V runs at n = D (m64n80k16: the first panel whole and 16 columns of
//     the second, the leading byte offset apart), so no zero column is
//     computed and O holds D/2 floats a thread.
//   - D = 192 (nemotron-4's: three whole panels) takes K/V tiles of 64 keys
//     instead of 128 (block_k): Q (48 KB) plus three stages of 64-key K and
//     V (144 KB) fit the 227 KB of shared memory, where 128-key stages
//     (288 KB) would not.  Q K^T is then m64n64k16, P V one m64n192k16 over
//     the three V panels (O 96 floats, S 32, P 16, Q 48), and a causal
//     128-row query tile's last two key tiles reach above its diagonal, so
//     both are masked.
//   TMA fills rows past S with zeros, so keys >= S are masked from their
//   indices, not by their contents.
// * f32 (namespace cc): the CUDA-core kernel, a register-tiled SIMT flash
//   attention laid out like an SGEMM.  Its products stay exact f32 FFMAs
//   (no mma of any kind, no TF32): the f32 path must stay within 2e-5 of
//   the plain version, which TF32 would not.  Bound: operations at the 67
//   TFLOP/s f32 rate, so the FFMA issue rate is what the layout serves.
//   - Work.  One CTA of 256 threads per (b*h, 128-query tile), heaviest
//     tiles first; 157-231 KB of shared memory, so one CTA an SM.
//   - Micro-tiles.  A warp owns 16 query rows.  TPR lanes share a row
//     (16, or 8 at D = 192); a lane holds an 8 x 4 (4 x 4 at D = 192)
//     micro-tile of S and the same rows' D / TPR columns of O in
//     registers, so each FFMA takes both operands from registers, loaded
//     from shared memory as float4s: at least 8 FFMAs a load (Q K^T: 8 rows
//     x 4 keys from 12 float4s per 4 columns; P V: D / 2 FFMAs from P's 2
//     float4s and V's D / 64 per key).
//   - Shared memory.  Q once per item (rows swizzled by their group, so the
//     groups of a warp read distinct banks); K/V tiles of 4 * TPR keys (64,
//     32 at D = 192) in two stages, K's rows padded to an odd number of
//     float4s (a row group's keys hit distinct banks), V row-major; each
//     warp's P (keys x its 16 rows, float4s swizzled by key).  Q, K and V
//     are read as they lie, row-major, so every copy is a 16-byte cp.async.
//   - Copies in flight.  Tile t + 1's cp.async is issued before tile t is
//     scored, into the other stage: one barrier per tile.  P is written and
//     read only by its own warp (__syncwarp).
//   - Softmax on the micro-tile: the row max by shuffles over the row's
//     lanes, exp2 (ex2.approx.ftz) of scores scaled by log2(e)/sqrt(D) in
//     one FFMA, O rescaled once a tile, the row sum kept per lane until the
//     epilogue; only tiles that reach past S or above a warp's first row
//     are masked, and a warp skips a tile above all of its rows.
//   - Epilogue: one reciprocal of max(l, 1e-30) a row and float4 stores.
//
// The wrapper (kernels/flash_attention.py, launch_plan) computes each
// instance's dynamic shared memory, the work items and grid it launches
// (to hold them to one launch's limits) and the three tensor maps' dims,
// strides and boxes; this file encodes the maps (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no -lcuda),
// checks each instance's shared-memory size against its own and sizes the
// persistent grid to the card's SMs.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
namespace cc {

constexpr int BQ = 128;       // query rows per CTA
constexpr int THREADS = 256;  // eight warps
constexpr int WARP_ROWS = BQ / (THREADS / 32);  // query rows a warp owns: 16
constexpr int P_ROW = 16;     // P's floats per key in a warp's buffer (one per row)
constexpr float kNegInf = -1e30f;  // the running max before any key

// Threads that share a query row (a row group): 16, or 8 past a 128-wide
// row, where O's 24 columns a thread are what the registers are for.
__host__ __device__ constexpr int threads_per_row(int d) { return d > 128 ? 8 : 16; }
// Keys per K/V tile: four a thread of a row group (64, or 32 at D = 192,
// where Q and two 64-key K/V stages would not fit the shared memory).
__host__ __device__ constexpr int block_k(int d) { return 4 * threads_per_row(d); }

// Dynamic shared memory in floats: Q (BQ x D, each row's float4 chunks
// XOR-swizzled by the row's group), two K stages (BK x KS: rows padded by
// one float4, an odd number of chunks, so the row group's keys fall in
// distinct banks), two V stages (BK x D) and each warp's P (BK x 16).
template <int D>
struct Smem {
  static constexpr int BK = block_k(D);
  static constexpr int KS = D + 4;
  static constexpr int Q = BQ * D;
  static constexpr int K = BK * KS;
  static constexpr int V = BK * D;
  static constexpr int P = (THREADS / 32) * BK * P_ROW;
  static constexpr int BYTES = 4 * (Q + 2 * K + 2 * V + P);
};

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
// (src then points at a valid row and is not read).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// Register-tiled flash attention on the CUDA cores, one CTA per (b*h,
// 128-query tile).  Warp w owns rows 16w .. 16w + 15 of the tile; within
// it, row group g (TPR lanes) owns rows 16w + RGW*r + g (r < RG) and lane t
// of the group keys t + TPR*i (i < 4) of each K/V tile and O's columns
// 4(t + TPR*c) .. +3 (c < NC), plus, at D = 80, column 64 + t.  So S is an
// RG x 4 micro-tile and O an RG x D/TPR one, both in registers; every FFMA
// takes both operands from registers, loaded from shared memory as float4s.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_ffma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int H, int G,
                     int causal, float scale_log2, Strides st) {
  constexpr int TPR = threads_per_row(D);
  constexpr int RGW = 32 / TPR;           // row groups a warp
  constexpr int RG = WARP_ROWS / RGW;     // rows a thread: 8, or 4
  constexpr int QUADS = RG / 4;           // its float4s of P a key
  constexpr int BK = block_k(D);
  constexpr int NK = BK / TPR;            // keys a thread a tile: 4
  constexpr int CH = D / 4;               // float4 chunks a row
  constexpr int NC = D / (4 * TPR);       // O's float4 chunks a thread
  constexpr int NR = (D - 4 * TPR * NC) / TPR;  // O's single columns a thread (D 80: 1)
  constexpr int NO = 4 * NC + NR;         // O's columns a thread
  constexpr int KS = Smem<D>::KS;
  static_assert(NK == 4 && RG % 4 == 0 && (D - 4 * TPR * NC) % TPR == 0, "micro-tiles");
  static_assert((KS / 4) % 2 == 1 && CH % RGW == 0, "conflict-free layouts");
  static_assert((BQ * CH) % THREADS == 0 && (BK * CH) % THREADS == 0, "whole copy rounds");

  extern __shared__ __align__(16) float smem[];
  float* const sq = smem;
  float* const sk = sq + Smem<D>::Q;
  float* const sv = sk + 2 * Smem<D>::K;
  float* const pw = sv + 2 * Smem<D>::V + (threadIdx.x >> 5) * BK * P_ROW;  // this warp's P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / TPR, t = lane % TPR;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int w0 = q0 + warp * WARP_ROWS;               // the warp's first row
  const float* const qb = q + b * st.qb + h * st.qh;
  const float* const kb = k + b * st.kb + kvh * st.kh;
  const float* const vb = v + b * st.vb + kvh * st.vh;

  // Q once (rows >= S zero), K/V tile 0 with it
#pragma unroll
  for (int n = 0; n < BQ * CH / THREADS; ++n) {
    const int i = tid + n * THREADS, r = i / CH, c = i - (i / CH) * CH;
    const bool ok = q0 + r < S;
    cp16(sq + r * D + 4 * (c ^ (r % RGW)), qb + (ok ? (long long)(q0 + r) * st.qs : 0) + 4 * c, ok);
  }
  auto load_kv = [&](int tile, int stage) {
#pragma unroll
    for (int n = 0; n < BK * CH / THREADS; ++n) {
      const int i = tid + n * THREADS, r = i / CH, c = i - (i / CH) * CH;
      const int key = tile * BK + r;
      const bool ok = key < S;
      const long long kk = ok ? key : 0;
      cp16(sk + stage * Smem<D>::K + r * KS + 4 * c, kb + kk * st.ks + 4 * c, ok);
      cp16(sv + stage * Smem<D>::V + r * D + 4 * c, vb + kk * st.vs + 4 * c, ok);
    }
    cp_commit();
  };
  const int key_end = causal ? min(q0 + BQ, S) : S;  // keys this tile can see
  const int ntiles = (key_end + BK - 1) / BK;
  load_kv(0, 0);

  float acc[RG][NO], m[RG], l[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[r][j] = 0.f;
  }
  // this thread's rows of Q (chunk c of row RGW*r + g sits at c ^ g)
  const float* const qrow = sq + (warp * WARP_ROWS + g) * D;

  for (int tile = 0; tile < ntiles; ++tile) {
    // tile's K/V landed, and every warp is done with tile - 1's stage
    cp_wait_all();
    __syncthreads();
    if (tile + 1 < ntiles) load_kv(tile + 1, (tile + 1) & 1);
    const int k0 = tile * BK;
    if (w0 >= S || (causal && k0 > w0 + WARP_ROWS - 1)) continue;  // no key for the warp's rows
    const float* const kt = sk + (tile & 1) * Smem<D>::K + t * KS;
    const float* const vt = sv + (tile & 1) * Smem<D>::V;

    // S = Q K^T on the RG x 4 micro-tile
    float s[RG][NK];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int i = 0; i < NK; ++i) s[r][i] = 0.f;
    }
#pragma unroll
    for (int c0 = 0; c0 < CH; c0 += RGW) {
#pragma unroll
      for (int u = 0; u < RGW; ++u) {
        float4 kv[NK];
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          kv[i] = *reinterpret_cast<const float4*>(kt + i * TPR * KS + 4 * (c0 + u));
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + r * RGW * D + 4 * (c0 + (u ^ g)));
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            s[r][i] = fmaf(qv.x, kv[i].x, s[r][i]);
            s[r][i] = fmaf(qv.y, kv[i].y, s[r][i]);
            s[r][i] = fmaf(qv.z, kv[i].z, s[r][i]);
            s[r][i] = fmaf(qv.w, kv[i].w, s[r][i]);
          }
        }
      }
    }
    // the scores below the diagonal of a causal tile and past S
    if (k0 + BK > S || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int row = w0 + RGW * r + g;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int key = k0 + t + TPR * i;
          if (key >= S || (causal && key > row)) s[r][i] = __int_as_float(0xff800000);  // -inf
        }
      }
    }
    // online softmax: the row max over the row group's lanes, P = exp2 of
    // log2-scaled scores, O rescaled once a tile; l stays per lane until the end
    float alpha[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      alpha[r] = exp2_ftz((m[r] - mn) * scale_log2);
      m[r] = mn;
      const float nb = -mn * scale_log2;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        s[r][i] = exp2_ftz(fmaf(s[r][i], scale_log2, nb));
        ps += s[r][i];
      }
      l[r] = fmaf(l[r], alpha[r], ps);
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[r][j] *= alpha[r];
    }
    // P to the warp's buffer, key-major: float4 (g * QUADS + qd) of key j
    // sits at chunk (g * QUADS + qd) ^ ((j >> 1) & 3), so a warp's stores
    // and loads meet no bank twice more than their width needs
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int j = t + TPR * i;
#pragma unroll
      for (int qd = 0; qd < QUADS; ++qd) {
        *reinterpret_cast<float4*>(pw + j * P_ROW + 4 * ((g * QUADS + qd) ^ ((j >> 1) & 3))) =
            make_float4(s[4 * qd][i], s[4 * qd + 1][i], s[4 * qd + 2][i], s[4 * qd + 3][i]);
      }
    }
    __syncwarp();
    // O += P V on the RG x D/TPR micro-tile
#pragma unroll 16
    for (int j = 0; j < BK; ++j) {
      float p[RG];
#pragma unroll
      for (int qd = 0; qd < QUADS; ++qd) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pw + j * P_ROW + 4 * ((g * QUADS + qd) ^ ((j >> 1) & 3)));
        p[4 * qd] = p4.x;
        p[4 * qd + 1] = p4.y;
        p[4 * qd + 2] = p4.z;
        p[4 * qd + 3] = p4.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(vt + j * D + 4 * (t + TPR * c));
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          acc[r][4 * c] = fmaf(p[r], v4.x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(p[r], v4.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(p[r], v4.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(p[r], v4.w, acc[r][4 * c + 3]);
        }
      }
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const float x = vt[j * D + 4 * TPR * NC + t + TPR * e];
#pragma unroll
        for (int r = 0; r < RG; ++r) acc[r][4 * NC + e] = fmaf(p[r], x, acc[r][4 * NC + e]);
      }
    }
  }

  // epilogue: l over the row group, one reciprocal a row, float4 stores
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float inv = __frcp_rn(fmaxf(lt, 1e-30f));
    const int row = w0 + RGW * r + g;
    if (row < S) {
      float* const op = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        *reinterpret_cast<float4*>(op + 4 * (t + TPR * c)) =
            make_float4(acc[r][4 * c] * inv, acc[r][4 * c + 1] * inv, acc[r][4 * c + 2] * inv,
                        acc[r][4 * c + 3] * inv);
      }
#pragma unroll
      for (int e = 0; e < NR; ++e) op[4 * TPR * NC + t + TPR * e] = acc[r][4 * NC + e] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int causal, const Strides& st, int smem, cudaStream_t stream) {
  constexpr int BYTES = Smem<D>::BYTES;
  if (smem != BYTES) return cudaErrorInvalidValue;  // the plan and this file disagree
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_attention_ffma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_ffma<D><<<grid, THREADS, BYTES, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, H / KV, causal,
      1.4426950408889634f / sqrtf((float)D), st);
  return cudaGetLastError();
}

}  // namespace cc

// --------------------------------------------------------------------------
// bf16: TMA + wgmma
// --------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;                   // query rows per CTA (two warpgroups of 64)
constexpr int BN = 128;                   // keys per K/V tile up to a 128-wide row
constexpr int BN_WIDE = 64;               // keys per K/V tile past it (D = 192)
constexpr int STAGES = 3;                 // K/V ring depth
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // plus the producer warpgroup
constexpr int PRODUCER_REGS = 24;         // setmaxnreg.dec: the producer only issues TMA
constexpr int CONSUMER_REGS = 240;        // setmaxnreg.inc: O, S(t+1) and P(t) at once
constexpr int TURN_BAR = 1;               // named barriers TURN_BAR + wg: warpgroup wg's turn
constexpr int PANEL = 64;                 // bf16 per 128-byte swizzled row
// the registers the launch grants (168 a thread under __launch_bounds__(THREADS, 1))
// cover what the roles take after setmaxnreg
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 168 * THREADS,
              "setmaxnreg would ask for more registers than the block holds");

// The width an instance lays a row of head dim d out at: whole panels.
__host__ __device__ constexpr int padded(int d) { return (d + PANEL - 1) / PANEL * PANEL; }

// Keys per K/V tile at laid-out row width dp: shared memory (see the
// header) allows 128 keys up to dp = 128 and 64 past it.
__host__ __device__ constexpr int block_k(int dp) { return dp > 128 ? BN_WIDE : BN; }

// Whether the consumer warpgroups take turns to issue GEMMs (named
// barriers) at laid-out row width dp: up to dp = 128.  Past it the 64-key
// tiles make a turn too short to hide the other's softmax, and waiting for
// the turn costs more than it orders (FA3 drops its scheduler barrier past
// head dim 128 too).
__host__ __device__ constexpr bool takes_turns(int dp) { return dp <= 128; }

// Dynamic shared memory at row width D (a whole number of panels): Q, then
// STAGES x (K, V), each a multiple of the 1024-byte swizzle atom, then the
// mbarriers (Q full and empty, a full and an empty one per stage); 1024
// bytes of slack to align the base to the atom.
template <int D>
struct Smem {
  static constexpr int Q = BM * D * 2;
  static constexpr int TILE = block_k(D) * D * 2;
  static constexpr int BARRIERS = 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 1024 + Q + STAGES * 2 * TILE + BARRIERS;
};

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
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The producer's wait: one that lasts ~10 s of SM clock traps, so a
// pipeline fault (consumers that stop releasing stages) ends the launch
// with an error instead of hanging the card.  Only the producer traps: a
// trap in the consumers' code holds their registers to the launch's 168
// whatever setmaxnreg grants (ptxas then spills and serialises their
// wgmma, C7512).
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) asm volatile("trap;");
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's commit groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pin a fragment's registers at this point of the program: after a wait,
// no read of it moves above the wait; before a batch of wgmma, no copy of it
// lands inside the batch (ptxas would then serialise the batch).
template <int N>
__device__ __forceinline__ void fence_all(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_all(uint32_t* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// The two consumer warpgroups' turns to issue GEMMs: wait on one's own
// named barrier, arrive on the other's (CONSUMERS threads complete either).
__device__ __forceinline__ void turn_wait(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int bar) {
  asm volatile("bar.arrive %0, %1;" ::"r"(bar), "n"(CONSUMERS) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

#define ACC8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC40(d) ACC32(d), ACC8(d, 32)
#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define ACC96(d) ACC64(d), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88)

// S (64 x 128, f32) = A (64 x 16, bf16 in registers) * B (128 x 16)^T [+ S], B K-major in shared memory.
__device__ __forceinline__ void wgmma_rk_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S (64 x 64, f32) = A (64 x 16, bf16 in registers) * B (64 x 16)^T [+ S], B K-major in shared memory.
__device__ __forceinline__ void wgmma_rk_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, f32) += A (64 x 16, bf16 in registers) * B (16 x 192), B MN-major in shared memory
// (three 64-wide panels, leading byte offset apart).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : ACC96(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, bf16 in registers) * B (16 x 80), B MN-major in shared memory:
// the first 64-wide panel whole and the first 16 columns of the next, a leading byte offset on.
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : ACC40(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one k16 step at n = D, the real head dim.
template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(D == 64 || D == 80 || D == 128 || D == 192, "no P V instruction for this D");
  if constexpr (D == 192) {
    wgmma_rs_n192(d, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// This warpgroup's 64 rows of Q as the A fragments of the D/16 k-steps of
// Q K^T, 4 registers a step (the layout of an mma.m16n8k16 A fragment for
// the warp's 16 rows): ldmatrix.x4 from the 128-byte-swizzled panels, lane
// l giving the address of row l % 16 and 8-column half l / 16 of the step.
// Held in registers, Q is read from shared memory once instead of at every
// Q K^T, whose m64n64k16 steps (D = 192) would otherwise read as many bytes
// of A as of B.
template <int D>
__device__ __forceinline__ void load_q(uint32_t* qa, uint32_t sq_wg, int warp_in_wg, int lane) {
  const int r = 16 * warp_in_wg + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, chunk = 2 * (kk % 4) + (lane >> 4);
    const uint32_t addr = sq_wg + p * BM * 128 + r * 128 + ((chunk ^ (r & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(qa[4 * kk]), "=r"(qa[4 * kk + 1]), "=r"(qa[4 * kk + 2]), "=r"(qa[4 * kk + 3])
                 : "r"(addr)
                 : "memory");
  }
}

// S (64 x BK) = Q K^T for this warpgroup's 64 rows: D/16 k-steps (the
// real head dim's; padded columns are zero and skipped), Q from registers,
// K K-major in shared memory, 4 steps per 64-wide panel, the k-step
// advancing 32 bytes inside the swizzled 128-byte rows.
template <int D, int BK>
__device__ __forceinline__ void qk(float* s, const uint32_t* qa, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t db = desc_sw128(sk + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
    if constexpr (BK == 128) {
      wgmma_rk_n128(s, qa + 4 * kk, db, kk > 0);
    } else {
      wgmma_rk_n64(s, qa + 4 * kk, db, kk > 0);
    }
  }
}

// O += P V: P (64 x BK) in bf16 registers, V key-major with D contiguous
// (MN-major B): 8 keys are a 1024-byte atom (stride byte offset), the next
// 64 columns of D the next panel (leading byte offset).  D is the real head
// dim: the columns past it in a padded panel are never read.
template <int D, int BK>
__device__ __forceinline__ void pv(float* acc, const uint32_t* pa, uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<D>(acc, pa + 4 * kk, desc_sw128(sv + kk * 16 * 128, BK * 128, 1024));
  }
}

// 2^x in one SFU instruction.  exp2f adds a range check and two scalings
// around it to keep results below 2^-126; those are flushed to zero here,
// far below what a P that is rounded to bf16 beside a row maximum of 1 keeps.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax step on the S fragment of one BK-key tile (rows r0 and
// r0 + 8 of this thread, columns 8j + cq, +1): mask it if it is one of the
// last tiles (the only ones with keys >= S or above the diagonal), update
// the running max m and this thread's share of the row sums l, overwrite S
// with P (f32), and return the factors alpha by which the accumulator must
// be rescaled.
template <int BK>
__device__ __forceinline__ void softmax(float* s, float& m0, float& m1, float& l0, float& l1,
                                        float& alpha0, float& alpha1, bool last, int k0, int r0,
                                        int cq, int S, int causal, float scale_log2) {
  if (last) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + cq + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        if (key >= S || (causal && key > row)) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // a row with no key yet keeps max -inf: subtract 0 so exp2 gives 0, not NaN
  const float sub0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
  const float sub1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
  alpha0 = exp2_ftz(m0 * scale_log2 - sub0);
  alpha1 = exp2_ftz(m1 * scale_log2 - sub1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = exp2_ftz(fmaf(s[4 * j], scale_log2, -sub0));
    s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -sub0));
    s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -sub1));
    s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -sub1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
}

// O *= alpha, row by row (alpha0 for row r0, alpha1 for r0 + 8).
template <int N>
__device__ __forceinline__ void rescale(float* acc, float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }
}

// P in bf16: the pairs of the S fragment, in order, are the A fragments of
// the k16 steps of P V (step kk = keys 16kk .. 16kk + 15).
template <int NS>
__device__ __forceinline__ void to_bf16(const float* s, uint32_t* pa) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// One work item: a (b*h, 128-query tile) pair.  Items are numbered
// heaviest query tiles first (every head of the last query tile, then the
// one before it, ...), so the long causal rows do not trail the walk.
struct Item {
  int b, h, kvh, q0, ntiles, first_masked;
};

template <int BK>
__device__ __forceinline__ Item item_at(int i, int BH, int QT, int S, int H, int G, int causal) {
  Item w;
  const int bh = i % BH;
  w.q0 = (QT - 1 - i / BH) * BM;
  w.b = bh / H;
  w.h = bh - w.b * H;
  w.kvh = w.h / G;
  const int key_end = causal ? min(w.q0 + BM, S) : S;
  w.ntiles = (key_end + BK - 1) / BK;  // the same for both consumer warpgroups
  // the tiles that may hold keys >= S or above a row's diagonal: the last
  // one, and with BK < BM under causality every tile of the query tile's
  // own BM keys
  w.first_masked = w.ntiles - (causal ? BM / BK : 1);
  return w;
}

// The item CTA c takes in round r of a persistent grid of g CTAs: the
// rounds run back and forth (c, then 2g - 1 - c, ...), so that the heavier
// end of a round goes to every CTA in turn and their sums of work stay even.
__device__ __forceinline__ int item_of(int r, int c, int g) { return r * g + ((r & 1) ? g - 1 - c : c); }

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int B,
                      int S, int H, int G, int causal, float scale_log2) {
  static_assert(D % 16 == 0, "a k-step of Q K^T takes 16 columns");
  constexpr int DP = padded(D);           // the row's laid-out width
  constexpr int NP = DP / PANEL;          // 64-wide panels per row
  constexpr int BK = block_k(DP);         // keys per K/V tile
  constexpr int Q_BYTES = Smem<DP>::Q, T_BYTES = Smem<DP>::TILE;
  constexpr int NACC = D / 2;             // O fragment: 64 x D over 128 threads
  constexpr int NS = BK / 2;              // S fragment: 64 x BK over 128 threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t ring = base + Q_BYTES;   // stage st: K at ring + 2*st*T, V after it
  const uint32_t q_full = ring + STAGES * 2 * T_BYTES, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * STAGES;
  const int BH = B * H, QT = (S + BM - 1) / BM, items = BH * QT;
  // the warpgroup, read through a shuffle so that ptxas sees it uniform per warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS / 32);  // one arrival per consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The roles split here and never meet again (ptxas honours setmaxnreg only so).
  // Both walk the same items; the K/V ring's stages and phases run on across
  // them (tile g of the CTA's walk uses stage g % STAGES), and so does Q's
  // buffer, which a consumer warp gives back once it holds its rows in
  // registers: the producer loads the next item's Q and K/V while the
  // consumers finish this one.
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA load -------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int g = 0;
      for (int r = 0, i = item_of(0, blockIdx.x, gridDim.x); i < items;
           i = item_of(++r, blockIdx.x, gridDim.x)) {
        const Item w = item_at<BK>(i, BH, QT, S, H, G, causal);
        mbar_wait_or_trap(q_empty, (r & 1) ^ 1);  // the first pass is free
        mbar_expect_tx(q_full, Q_BYTES);
        for (int p = 0; p < NP; ++p) tma_load(sq + p * BM * 128, &tq, q_full, p * PANEL, w.h, w.q0, w.b);
        for (int t = 0; t < w.ntiles; ++t, ++g) {
          const int st = g % STAGES;
          const uint32_t sk = ring + 2 * st * T_BYTES, sv = sk + T_BYTES;
          mbar_wait_or_trap(empty0 + 8 * st, ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * st, 2 * T_BYTES);
          for (int p = 0; p < NP; ++p) {
            tma_load(sk + p * BK * 128, &tk, full0 + 8 * st, p * PANEL, w.kvh, t * BK, w.b);
            tma_load(sv + p * BK * 128, &tv, full0 + 8 * st, p * PANEL, w.kvh, t * BK, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64*wg .. +63 ----------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool leader = (threadIdx.x & 127) == 0;
    const int my_turn = TURN_BAR + wg, their_turn = TURN_BAR + (wg ^ 1);
    constexpr bool TURNS = takes_turns(DP);
    const uint32_t sq_wg = sq + wg * 64 * 128;
    float acc[NACC], s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t pa[NS / 2], qa[D / 4];
    float alpha0, alpha1;
    int g = 0;
    for (int r = 0, i = item_of(0, blockIdx.x, gridDim.x); i < items;
         i = item_of(++r, blockIdx.x, gridDim.x)) {
      const Item w = item_at<BK>(i, BH, QT, S, H, G, causal);
      // accumulator fragment: this thread holds rows r0 and r0 + 8, and in every
      // 8-column chunk j the columns 8j + cq and 8j + cq + 1
      const int r0 = w.q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
      const int cq = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's share

      if (TURNS && wg == 1) turn_pass(TURN_BAR);  // warpgroup 0 issues first
      mbar_wait(q_full, r & 1);
      load_q<D>(qa, sq_wg, warp & 3, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);  // this warp holds its rows of Q

      // tile 0: S(0) alone (O is still zero)
      mbar_wait(full0 + 8 * (g % STAGES), (g / STAGES) & 1);
      if (TURNS) turn_wait(my_turn);
      // The fragments are defined and fenced before each batch of wgmma, so
      // ptxas can keep the batch asynchronous instead of serialising it.
      fence_all<NS>(s);
      wgmma_fence();
      qk<D, BK>(s, qa, ring + 2 * (g % STAGES) * T_BYTES);
      wgmma_commit();
      if (TURNS && (wg == 0 || w.ntiles > 1)) turn_pass(their_turn);
      wgmma_wait<0>();
      fence_all<NS>(s);
      softmax<BK>(s, m0, m1, l0, l1, alpha0, alpha1, 0 >= w.first_masked, 0, r0, cq, S, causal,
                  scale_log2);
      to_bf16<NS>(s, pa);

      for (int t = 1; t < w.ntiles; ++t) {
        const int st = (g + t) % STAGES, prev = (g + t - 1) % STAGES;
        mbar_wait(full0 + 8 * st, ((g + t) / STAGES) & 1);
        if (TURNS) turn_wait(my_turn);
        // S(t) = Q K(t)^T and O += P(t-1) V(t-1), two commit groups
        fence_all<NS>(s);
        fence_all<NACC>(acc);
        fence_all<NS / 2>(pa);
        wgmma_fence();
        qk<D, BK>(s, qa, ring + 2 * st * T_BYTES);
        wgmma_commit();
        pv<D, BK>(acc, pa, ring + 2 * prev * T_BYTES + T_BYTES);
        wgmma_commit();
        if (TURNS && (wg == 0 || t + 1 < w.ntiles)) turn_pass(their_turn);
        wgmma_wait<1>();  // S(t) is in; P(t-1) V(t-1) may still run
        fence_all<NS>(s);
        softmax<BK>(s, m0, m1, l0, l1, alpha0, alpha1, t >= w.first_masked, t * BK, r0, cq, S,
                    causal, scale_log2);
        wgmma_wait<0>();
        fence_all<NACC>(acc);
        fence_all<NS / 2>(pa);
        if (leader) mbar_arrive(empty0 + 8 * prev);  // this warpgroup is done with stage prev
        rescale<NACC>(acc, alpha0, alpha1);
        to_bf16<NS>(s, pa);
      }

      // the last tile's P V
      g += w.ntiles;
      const int last = (g - 1) % STAGES;
      fence_all<NACC>(acc);
      fence_all<NS / 2>(pa);
      wgmma_fence();
      pv<D, BK>(acc, pa, ring + 2 * last * T_BYTES + T_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all<NACC>(acc);
      if (leader) mbar_arrive(empty0 + 8 * last);

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      // 1 / max(l, 1e-30) by the SFU's reciprocal (l >= 1 in every row that
      // sees a key): an IEEE division is a call to a slow path, and a call
      // holds the consumers' registers to the ABI's budget
      const float inv0 = __fdividef(1.f, fmaxf(l0, 1e-30f)), inv1 = __fdividef(1.f, fmaxf(l1, 1e-30f));
      __nv_bfloat16* o0 = o + (((long long)w.b * S + r0) * H + w.h) * D + cq;
      __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r0 < S) {
          *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        }
        if (r0 + 8 < S) {
          *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
        }
      }
    }
  }  // consumers
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// One operand's map from the wrapper's plan: dims[4], strides[3] (bytes),
// box[4].  Out-of-bounds elements are filled with zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, const unsigned long long* plan) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {plan[0], plan[1], plan[2], plan[3]};
  const cuuint64_t strides[3] = {plan[4], plan[5], plan[6]};
  const cuuint32_t box[4] = {(cuuint32_t)plan[7], (cuuint32_t)plan[8], (cuuint32_t)plan[9],
                             (cuuint32_t)plan[10]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int causal, const unsigned long long* maps, int smem,
                   cudaStream_t stream) {
  constexpr int BYTES = Smem<padded(D)>::BYTES;
  constexpr unsigned long long BK = block_k(padded(D));
  // the plan and this file disagree: shared memory, or a box's rows (maps
  // hold dims[4], strides[3], box[4] per operand; box[2] is the rows)
  if (smem != BYTES || maps[9] != BM || maps[20] != BK || maps[31] != BK) return cudaErrorInvalidValue;
  // Opt in to the shared memory once per instance (not a stream operation,
  // so legal before any graph capture that later replays the launch).
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (opt_in != cudaSuccess) return opt_in;
  // The block is granted numRegs a thread at launch; setmaxnreg.inc waits
  // until the producer's setmaxnreg.dec has freed enough of them, for ever
  // if the grant is smaller than what the roles take.
  static const int granted = [] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, flash_attention_wgmma<D>) == cudaSuccess ? attr.numRegs : 0;
  }();
  if (granted * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS) {
    return cudaErrorInvalidConfiguration;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t e = encode(&tq, q, maps);
  if (e == cudaSuccess) e = encode(&tk, k, maps + 11);
  if (e == cudaSuccess) e = encode(&tv, v, maps + 22);
  if (e != cudaSuccess) return e;
  // a persistent grid: one CTA an SM (the block's registers and shared
  // memory allow no second), each walking its share of the items
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = (long long)B * H * ((S + BM - 1) / BM);
  flash_attention_wgmma<D><<<(unsigned)(items < sms ? items : sms), THREADS, BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, B, S, H, H / KV, causal, 1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace tc


// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements (the f32
// instance reads through them); the last dim of q/k/v is contiguous and
// the output is contiguous (B, S, H, D).  maps: the bf16 instance's tensor
// maps for q, k, v (11 values each: dims[4], byte strides[3], box[4]),
// ignored for f32; smem: the instance's dynamic shared memory in bytes.
// Returns a cudaError_t (cudaErrorInvalidValue for a D or dtype without an
// instance, or a plan this file does not agree with).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int S, int H, int KV, int D,
                               int causal, long long qb, long long qs, long long qh,
                               long long kb, long long ks, long long kh, long long vb,
                               long long vs, long long vh, const unsigned long long* maps,
                               int smem, void* stream) {
  const cc::Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return (int)cc::launch<64>(q, k, v, o, B, S, H, KV, causal, st, smem, s);
  if (dtype == 0 && D == 80) return (int)cc::launch<80>(q, k, v, o, B, S, H, KV, causal, st, smem, s);
  if (dtype == 0 && D == 128) return (int)cc::launch<128>(q, k, v, o, B, S, H, KV, causal, st, smem, s);
  if (dtype == 0 && D == 192) return (int)cc::launch<192>(q, k, v, o, B, S, H, KV, causal, st, smem, s);
  if (dtype == 1 && D == 64) return (int)tc::launch<64>(q, k, v, o, B, S, H, KV, causal, maps, smem, s);
  if (dtype == 1 && D == 80) return (int)tc::launch<80>(q, k, v, o, B, S, H, KV, causal, maps, smem, s);
  if (dtype == 1 && D == 128) return (int)tc::launch<128>(q, k, v, o, B, S, H, KV, causal, maps, smem, s);
  if (dtype == 1 && D == 192) return (int)tc::launch<192>(q, k, v, o, B, S, H, KV, causal, maps, smem, s);
  return (int)cudaErrorInvalidValue;
}
