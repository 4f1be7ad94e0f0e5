// Flash decoding: one query token per (batch, head) against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:
// flash_decode_pallas (_decode_kernel).  For q (B, H, D) and a cache
// k/v (B, S, KV, D), G = H / KV, and a scalar valid_len:
//   out[b, h] = softmax_{s < valid_len}(q[b, h] . k[b, s, h/G] / sqrt(D)) v[b, s, h/G]
// with f32 running max / denominator / accumulator, denom = max(l, 1e-30),
// and zeros when valid_len = 0 (every tile skipped), as the Pallas kernel
// gives.  valid_len is read on the device from a pointer (a 0-d int32
// tensor) or taken as a host int, so no host sync is needed.
//
// What bounds it on an H100: bytes.  Every valid cache slot's K and V are
// read once (B = 32, S = 32768, KV = 8, D = 128, bf16: 4.29 GB, 1.28 ms at
// 3.35 TB/s); the flops are 4*B*H*valid*D, two per byte.  Design: split-K.
// The grid is (B*KV, splits): a block owns one KV head of one sequence and
// a contiguous range of 64-slot tiles, brings each K/V tile into shared
// memory once and serves all G query heads of the group from it, so the
// cache is read once and not G times.  Tiles at or past valid_len are never
// loaded.  Each block writes its (m, l, acc) per head; a second small
// kernel merges the splits per (b, h).  The split count is chosen by the
// wrapper from B*KV and S so that the grid fills the card's 132 SMs even at
// batch 1.
//
// Two partial kernels:
//
// * bf16 (mma::flash_decode_partial_mma<D>), at every head dim.  Bytes
//   bound it (D = 192, B 8 x 32768 slots x 8 KV heads: 1.61 GB, 0.481 ms at
//   3.35 TB/s), but a CUDA-core scorer would not keep up: at D = 192 and
//   group 12 its 4*B*H*S*D = 1.93e10 multiply-adds take 0.288 ms at 67
//   TFLOP/s before any shuffle or exp, and at group 1 a scorer that gives
//   each warp heads of the group leaves three warps in four idle, so the
//   scoring runs on the tensor cores, where it costs almost nothing.
//   1. cp.async.cg 16-byte chunks into a ring of `stages<D>` 64-slot K and V
//      tiles, zero-filled past valid_len.  A staged row is laid out so that
//      the 8 rows one ldmatrix reads at one chunk take 8 distinct bank
//      groups (`chunk_offset`): a 128-, 256- or 384-byte row (D = 64, 128,
//      192) is 0 mod 128, so chunk c of row r is stored at chunk c ^ (r & 7)
//      of its row; D = 80's 10 chunks would reach chunk 15 that way, and a
//      160-byte stride puts the 8 rows in 4 bank groups, so its rows are
//      padded to 11 chunks (176 bytes), an odd stride.
//   2. Warp w owns slots [16w, 16w + 16) of every tile, so all four warps
//      score at any group size (group 1 too) and each K/V byte is read from
//      shared memory once.
//   3. mma.sync m16n8k16 (bf16 in, f32 sums; a wgmma needs 64 rows of M,
//      which one KV head's query heads do not have).  The group's G <= 16
//      heads are the M rows (zero rows past G), the warp's 16 slots the N
//      of S = Q K^T and the K of O = P V: S's f32 accumulators are then P's
//      A fragment as they stand, rounded to bf16 in registers.  (Slots as M
//      and heads as N would waste less at group 1, but P^T would have to be
//      reshuffled across lanes into a B fragment; the tensor cores are idle
//      either way.)  Q's A fragments are loaded once per block, unscaled;
//      S is scaled in f32 by log2(e)/sqrt(D) after the product.  K's B
//      fragments come by ldmatrix (D / 16 k-steps), V's by ldmatrix.trans
//      (D / 8 n8 tiles, two an x4), from the staged tile.  The online
//      softmax runs per head row in log2 units; slots >= valid_len score
//      -inf (a zero-filled row would score 0).  Each lane holds its rows of
//      the 16 x D f32 accumulator as D/8 n8 tiles (D / 2 registers).
//   4. After the last tile the ring is free: each warp's (m, l, acc) for the
//      group's heads goes there (4 x 16 x (D + 2) floats at most, 49.7 KB at
//      D = 192), and one pass merges the four warps and writes the split's
//      state, which a second kernel merges across the splits.  A block
//      whose split holds no valid tile writes the empty state and loads
//      nothing.
//   5. Residency: 3 / 3 / 2 / 2 stages at D = 64 / 80 / 128 / 192, and the
//      launch bounds ask for as many blocks an SM as that shared memory
//      holds (`min_blocks`: 4 / 3 / 3 / 2), so registers never bind first.
//      On an H100 a whole cache reads at 91-93 % of 3.35 TB/s at D = 64,
//      128, 192, but at 76-79 % at D = 80 with 2 to 5 stages or 1 to 8
//      splits: a 160-byte row spans two 128-byte lines, and D = 64's rows
//      read 32 bytes off a line fall to 61-66 % the same way.  The
//      wrapper's plan sizes the split-K grid to those blocks: B*KV*splits
//      within one wave where B*KV allows (at D = 192, B 8 x 8 KV heads x
//      32768 slots: 4 splits of 128 tiles, 256 blocks), else one split per
//      (b, kv).
//   6. The C entry checks the plan's shared memory and heads per warp (G)
//      against this file's, and G <= 16.
// * f32 (ffma::flash_decode_partial_ffma<D, GP>): exact f32 on the CUDA
//   cores, FFMAs only.  Bytes bound it too (D = 192, B 8 x 32768 slots x 8
//   KV heads: 3.22 GB, 0.962 ms at 3.35 TB/s; at group 12 its 9.7e9 FFMAs
//   take 0.29 ms at 67 TFLOP/s), so the copies must stay in flight and the
//   FFMAs must not wait on shared memory.
//   1. cp.async.cg 16-byte copies into a ring of 32-slot K and V tiles, as
//      many as fit in ~110 KB, at most 4 (4 at D = 64, 80, 3 at 128, 2 at
//      192), zero-filled past valid_len; a staged row is D / 4 + 1 float4s
//      (an odd count, so the 8 rows a quarter-warp reads at one chunk take 8
//      distinct bank groups).  Tiles t + 1 .. t + stages - 1 are in flight
//      while tile t is scored: 50-68 KB a block.
//   2. Warp w owns slots [8w, 8w + 8) of every tile; its scores, online
//      softmax (exp2, log2(e)/sqrt(D) folded into Q) and P stay in the
//      warp, which keeps its own (m, l, O) in registers: one block barrier a
//      tile.  After the last tile the warps merge through the freed ring and
//      the split's state is written as the bf16 instance writes it, so the
//      merge kernel serves both.
//   3. Lane (sl, dl) = (lane & 7, lane >> 3) scores slot sl against every
//      head of the chunk over float4 chunks dl, dl + 4, ... of the row (a K
//      float4 from the ring, Q's float4s broadcast from shared memory: 4
//      FFMAs a load, the four lanes of a slot summed by two xor shuffles),
//      so at group 1 no lane idles.  For P V a lane holds every head at
//      float2 columns lane, lane + 32, ... of O (72 floats at D = 192,
//      chunk 12), reading P as broadcast float4s from the warp's buffer:
//      GP / 4 + D / 64 loads for 2 GP D / 32 FFMAs a slot.  Every sum is
//      taken in a fixed order, so a second call gives the same bits.
//   4. A block serves a chunk of at most 16 heads, 12 at D = 192 (16 heads'
//      96 floats of O a lane spilled there, 40-120 B at 255 registers), a
//      grid z for each chunk, each reading its KV head's cache once; the
//      chunk runs on the instance of the least GP in {1, 2, 4, 8, 12, 16}
//      that holds it.  The shared memory holds 3 blocks an SM at D = 64 and
//      2 at D = 80, 128, 192, the launch bounds keep registers from binding
//      first, and the wrapper sizes the split-K grid to those blocks (one
//      wave where B * KV * chunks allows).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int DBK = 64;       // cache slots per tile
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;  // an H100 SM's shared memory

struct Strides {
  long long qb, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ int valid_of(const int* valid_ptr, long long valid_host, int S) {
  const long long vl = valid_ptr ? (long long)*valid_ptr : valid_host;
  return (int)(vl < 0 ? 0 : (vl > S ? S : vl));
}

// 16 bytes from global into shared memory, the rest of the 16 zero-filled
// past src_bytes (0: zeros, nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- bf16: tensor-core scoring --------------------------------------------
namespace mma {

constexpr int WARP_SLOTS = DBK / WARPS;     // warp w owns slots [16w, 16w + 16) of every tile
constexpr int MAX_GROUP = 16;               // query heads: the M rows of one m16n8k16

// 64-slot K+V tiles in the ring
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 80 ? 2 : 3;
}
// 16-byte chunks of a staged K or V row: D / 8, and at D = 80 one of
// padding, an odd count
template <int D>
__host__ __device__ constexpr int row_chunks() {
  return D % 64 == 0 ? D / 8 : D / 8 + 1;
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return stages<D>() * 2 * DBK * row_chunks<D>() * 16;
}
// Blocks per SM the launch bounds ask for: as many as the shared memory
// holds (4 at D = 64, 3 at D = 80, 128, 2 at D = 192), so the registers
// (at most 128, 168 or 255 a thread) never bind first.
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return SM_SMEM / (smem_bytes<D>() + BLOCK_RESERVED);
}

// Byte offset in a tile of 16-byte chunk c of cache row r.  A row of D * 2
// = 128, 256 or 384 bytes is 0 mod 128, so the 8 rows that one ldmatrix
// reads at one chunk would share a bank group; stored at chunk c ^ (r & 7)
// of its row they take 8 distinct ones.  At D = 80 the row is padded to 11
// chunks, whose odd stride does the same.  The copy and the reads use this
// one map.
template <int D>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  if constexpr (D % 64 == 0) {
    return r * (D * 2) + ((c ^ (r & 7)) << 4);
  } else {
    return (r * row_chunks<D>() + c) << 4;
  }
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in register i (.trans: transposed).
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one warp (lane = 4 gr + tq): an A register i holds row
// gr + 8 (i & 1), columns 8 (i >> 1) + 2 tq and + 1; a B register i rows
// (k) 8 i + 2 tq and + 1 of column gr; C element i row gr + 8 (i >> 1),
// column 2 tq + (i & 1).  Heads are M, slots are N of S = Q K^T and K of
// O = P V, so S's accumulators are P V's A operand as they stand.
template <int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
flash_decode_partial_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid_ptr,
                         long long valid_host, float* __restrict__ part, int S, int KV, int G,
                         int tiles_per_split, float scale_log2, Strides st) {
  static_assert(D % 16 == 0, "a cache row is whole k16 steps, and pairs of n8 tiles");
  static_assert(WARP_SLOTS == 16, "a warp's slots are the N of two n8 tiles, the K of one k16");
  static_assert(WARPS * 16 * (D + 2) * 4 <= smem_bytes<D>(), "the warps' states fit in the ring");
  constexpr int STAGES = stages<D>();
  constexpr int CH = D / 8;     // 16-byte chunks in a cache row
  constexpr int TILEB = DBK * row_chunks<D>() * 16;
  constexpr int KSTEPS = D / 16;  // k16 steps of Q K^T
  constexpr int NTILES = D / 8;   // n8 tiles of P V
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int valid = valid_of(valid_ptr, valid_host, S);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (valid + DBK - 1) / DBK);
  float* out = part + ((long long)bk * nsplit + split) * G * (D + 2);
  if (t_begin >= t_end) {  // no valid tile: the empty state, without loading Q
    for (int i = tid; i < G * (D + 2); i += THREADS) out[i] = i < G ? kNegInf : 0.f;
    return;
  }

  // Q's A fragments, once: the group's heads, zero rows past G, unscaled
  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* qg = q + b * st.qb + (long long)(kvh * G) * st.qh;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = gr + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * tq;
      qa[kk][i] = row < G ? __ldg(reinterpret_cast<const unsigned int*>(qg + row * st.qh + col)) : 0u;
    }
  }
  float acc[NTILES][4];
#pragma unroll
  for (int j = 0; j < NTILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows gr, gr + 8; log2 units
  float l[2] = {0.f, 0.f};              // this lane's columns only, summed at the end

  const __nv_bfloat16* kbase = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vbase = v + b * st.vb + kvh * st.vh;
  // tile t into stage `stage` by `chunk_offset`: slots at or past valid_len are zero-filled
  auto load_tile = [&](int t, int stage) {
    const uint32_t ks = ring0 + stage * 2 * TILEB, vs = ks + TILEB;
    for (int c = tid; c < DBK * CH; c += THREADS) {
      const int r = c / CH, ch = c - (c / CH) * CH;
      const int slot = t * DBK + r;
      const bool ok = slot < valid;
      const long long koff = ok ? (long long)slot * st.ks + ch * 8 : 0;
      const long long voff = ok ? (long long)slot * st.vs + ch * 8 : 0;
      cp_async16(ks + chunk_offset<D>(r, ch), kbase + koff, ok ? 16 : 0);
      cp_async16(vs + chunk_offset<D>(r, ch), vbase + voff, ok ? 16 : 0);
    }
  };
  // ldmatrix rows: lane feeds row lane & 7 of matrix mi = lane >> 3.  K:
  // (slots 0-7, chunk 2kk), (0-7, 2kk + 1), (8-15, 2kk), (8-15, 2kk + 1) of
  // the warp's 16, the B registers of its two n8 tiles of S.  V, transposed:
  // (0-7, chunk 2jj), (8-15, 2jj), (0-7, 2jj + 1), (8-15, 2jj + 1), the B
  // registers of P V's n8 tiles 2jj and 2jj + 1.
  const int mi = lane >> 3;
  const int k_row = WARP_SLOTS * warp + 8 * (mi >> 1) + (lane & 7), k_ch = mi & 1;
  const int v_row = WARP_SLOTS * warp + 8 * (mi & 1) + (lane & 7), v_ch = mi >> 1;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t are done
    __syncthreads();              // everyone's are, and the stage reloaded below is consumed
    if (t + STAGES - 1 < t_end) load_tile(t + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int s0 = t * DBK + WARP_SLOTS * warp;  // the warp's first slot
    if (s0 >= valid) continue;                   // none of its slots is valid
    const uint32_t ks = ring0 + (it % STAGES) * 2 * TILEB, vs = ks + TILEB;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(ks + chunk_offset<D>(k_row, 2 * kk + k_ch), kb);
      mma_16816(s[0], qa[kk], kb[0], kb[1]);
      mma_16816(s[1], qa[kk], kb[2], kb[3]);
    }
    // scale in f32, mask (a zero-filled row scores 0, not -inf), row maxima
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = s0 + 8 * n + 2 * tq + (i & 1);
        s[n][i] = slot < valid ? s[n][i] * scale_log2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    }
    float sub[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      sub[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // no valid slot yet: no NaN
      alpha[h] = exp2f(m[h] - sub[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P in bf16, straight from S's registers into P V's A operand; l sums
    // the rounded weights, so they are the ones P V applies
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(exp2f(s[n][2 * h] - sub[h]),
                                                       exp2f(s[n][2 * h + 1] - sub[h]));
        l[h] += __low2float(p) + __high2float(p);
        pa[2 * n + h] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int jj = 0; jj < NTILES / 2; ++jj) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vs + chunk_offset<D>(v_row, 2 * jj + v_ch), vb);
      mma_16816(acc[2 * jj], pa, vb[0], vb[1]);
      mma_16816(acc[2 * jj + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();     // and no warp reads the ring any more: it holds the merge

  // the four warps' (m, l, acc) per head row of the group (rows past G are
  // not stored), then one pass merges them and writes this split's state:
  // part[(bk, split)] = [m (G), l (G), acc (G x D)], m in natural-log units
  float* ms = reinterpret_cast<float*>(smem);  // [WARPS][16]
  float* ls = ms + WARPS * 16;                 // [WARPS][16]
  float* as = ls + WARPS * 16;                 // [WARPS][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = gr + 8 * h;
    if (row < G) {
      if (tq == 0) {
        ms[warp * 16 + row] = m[h];
        ls[warp * 16 + row] = l[h];
      }
      float* a = as + (warp * 16 + row) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < NTILES; ++j)
        *reinterpret_cast<float2*>(a + 8 * j) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * 16 + g]);
    const float sub = mx == -INFINITY ? 0.f : mx;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(ms[w * 16 + g] - sub);
      a = fmaf(as[(w * 16 + g) * D + d], c, a);
      lsum = fmaf(ls[w * 16 + g], c, lsum);
    }
    out[2 * G + idx] = a;
    if (d == 0) {
      out[g] = mx == -INFINITY ? kNegInf : mx * 0.6931471805599453f;
      out[G + g] = lsum;
    }
  }
}

template <int D>
cudaError_t prepare() {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_decode_partial_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  return opt_in;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, float* part, int B, int S, int KV, int G, int nsplit,
                   int tiles_per_split, const Strides& st, cudaStream_t stream) {
  const cudaError_t opt_in = prepare<D>();
  if (opt_in != cudaSuccess) return opt_in;
  flash_decode_partial_mma<D><<<dim3(B * KV, nsplit), THREADS, smem_bytes<D>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, valid_ptr,
      valid_host, part, S, KV, G, tiles_per_split, 1.4426950408889634f / sqrtf((float)D), st);
  return cudaGetLastError();
}

template <int D>
cudaError_t blocks_per_sm(int* blocks) {
  cudaError_t e = prepare<D>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_decode_partial_mma<D>, THREADS,
                                                      smem_bytes<D>());
  return e;
}

}  // namespace mma

// ---- f32: register-tiled FFMA split-K --------------------------------------
namespace ffma {

constexpr int TS = 32;                      // cache slots per tile
constexpr int WARP_SLOTS = TS / WARPS;      // warp w owns slots [8w, 8w + 8) of every tile
constexpr int RING_BYTES = 110 * 1024;      // the ring's budget, at most MAX_STAGES tiles
constexpr int MAX_STAGES = 4;

// Query heads a block serves, a chunk of the group: 16, but 12 at D = 192,
// where 16 heads' 96 floats of O a lane spill past 255 registers.
__host__ __device__ constexpr int max_group(int d) { return d > 128 ? 12 : 16; }
// The chunk sizes with an instance: a chunk of g heads runs on the least one
// >= g, its rows past g zero.
__host__ __device__ constexpr int head_class(int g) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : g <= 12 ? 12 : 16;
}
// float4s of a staged K or V row: D / 4 and one of padding, an odd count,
// so the 8 rows a quarter-warp reads at one chunk take 8 distinct bank groups
__host__ __device__ constexpr int row4(int d) { return d / 4 + 1; }
__host__ __device__ constexpr int stage_bytes(int d) { return 2 * TS * row4(d) * 16; }
__host__ __device__ constexpr int stages(int d) {
  return RING_BYTES / stage_bytes(d) < MAX_STAGES ? RING_BYTES / stage_bytes(d) : MAX_STAGES;
}
// The ring, Q (gp x D, scaled) and each warp's P (WARP_SLOTS x gp).
__host__ __device__ constexpr int smem_bytes(int d, int gp) {
  return stages(d) * stage_bytes(d) + 4 * gp * d + 4 * WARPS * WARP_SLOTS * gp;
}
// Blocks per SM the launch bounds ask for: as many as the shared memory holds
// at the largest chunk (3 at D = 64, 2 at D = 80, 128, 192; the smaller
// chunks hold no more), so the registers (at most 168 or 255) never bind first.
__host__ __device__ constexpr int min_blocks(int d) {
  return SM_SMEM / (smem_bytes(d, max_group(d)) + BLOCK_RESERVED);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block per (b, kv head, split, chunk of <= max_group(D) heads).  Lane (sl, dl) =
// (lane & 7, lane >> 3) scores slot sl of its warp's 8 against every head of
// the chunk over float4 chunks dl, dl + 4, ... of the row (K from the ring,
// Q broadcast from shared memory), and the four lanes of a slot sum by xor
// shuffles.  The online softmax runs per head in log2 units in every lane;
// P goes through the warp's own buffer, and for P V a lane holds every head
// of the chunk at float2 columns lane, lane + 32, ... of O.
template <int D, int GP>
__global__ void __launch_bounds__(THREADS, min_blocks(D))
flash_decode_partial_ffma(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ valid_ptr,
                          long long valid_host, float* __restrict__ part, int S, int KV, int G,
                          int tiles_per_split, float scale_log2, Strides st) {
  constexpr int CH = D / 4;                 // float4 chunks of a cache row
  constexpr int R4 = row4(D);               // and of a staged row
  constexpr int NST = stages(D);
  constexpr int STAGE = 2 * TS * R4;        // float4s of a K+V stage
  constexpr int KC = CH / 4;                // a score lane's chunks of a row
  constexpr int NV = (D / 2 + 31) / 32;     // a P V lane's float2 columns (D = 80: lanes 8-31 one)
  static_assert(CH % 4 == 0 && WARP_SLOTS == 8, "8 slots a warp, 4 lanes a slot");
  static_assert((TS * CH) % THREADS == 0, "whole copy rounds");
  static_assert(NST >= 2, "tile t + 1 in flight while tile t is scored");
  static_assert(GP <= max_group(D), "a chunk's O fits in the registers");
  static_assert(WARPS * GP * (D + 2) * 4 <= NST * stage_bytes(D), "the warps' states fit in the ring");
  extern __shared__ __align__(16) float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4 + NST * STAGE);
  float* const pw = qs + GP * D + (threadIdx.x >> 5) * WARP_SLOTS * GP;  // this warp's P

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int g0 = blockIdx.z * max_group(D);  // the chunk's first head of the group
  const int gc = min(GP, G - g0);            // and its heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = lane & 7, dl = lane >> 3;
  const int valid = valid_of(valid_ptr, valid_host, S);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (valid + TS - 1) / TS);
  // this split's state: part[(bk, split)] = [m (G), l (G), acc (G x D)], the chunk's heads
  float* const out = part + ((long long)bk * nsplit + split) * G * (D + 2);
  if (t_begin >= t_end) {  // no valid tile: the empty state, without loading Q
    for (int g = tid; g < gc; g += THREADS) {
      out[g0 + g] = kNegInf;
      out[G + g0 + g] = 0.f;
    }
    for (int i = tid; i < gc * D; i += THREADS) out[2 * G + g0 * D + i] = 0.f;
    return;
  }

  const float* const kbase = k + b * st.kb + kvh * st.kh;
  const float* const vbase = v + b * st.vb + kvh * st.vh;
  const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  // tile t into stage `stage`: its K rows, then its V rows, R4 float4s each;
  // slots at or past valid_len are zero-filled without a read
  auto load_tile = [&](int t, int stage) {
    const uint32_t ks = ring0 + stage * STAGE * 16, vs = ks + TS * R4 * 16;
#pragma unroll
    for (int n = 0; n < TS * CH / THREADS; ++n) {
      const int i = tid + n * THREADS, r = i / CH, c = i - (i / CH) * CH;
      const int slot = t * TS + r;
      const bool ok = slot < valid;
      const long long row = ok ? slot : 0;
      cp_async16(ks + (r * R4 + c) * 16, kbase + row * st.ks + 4 * c, ok ? 16 : 0);
      cp_async16(vs + (r * R4 + c) * 16, vbase + row * st.vs + 4 * c, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    cp_async_commit();
  }
  // Q of the chunk's heads, scaled by log2(e) / sqrt(D), zero rows past gc
  const float* const qg = q + b * st.qb + (long long)(kvh * G + g0) * st.qh;
  for (int i = tid; i < GP * CH; i += THREADS) {
    const int g = i / CH, c = i - (i / CH) * CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < gc) x = __ldg(reinterpret_cast<const float4*>(qg + g * st.qh + 4 * c));
    reinterpret_cast<float4*>(qs)[i] =
        make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2, x.w * scale_log2);
  }
  const float4* const q4 = reinterpret_cast<const float4*>(qs);

  float m[GP], l[GP], acc[GP][NV][2];  // m in log2 units; l over the lane's slot until the end
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[g][i][0] = acc[g][i][1] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    cp_async_wait<NST - 2>();  // this thread's copies of tile t are done
    __syncthreads();           // everyone's are (and Q is in); the stage reloaded below is consumed
    if (t + NST - 1 < t_end) load_tile(t + NST - 1, (it + NST - 1) % NST);
    cp_async_commit();
    const int s0 = t * TS + WARP_SLOTS * warp;  // the warp's first slot
    if (s0 >= valid) continue;                  // none of its slots is valid
    const float4* const kt = smem4 + (it % NST) * STAGE + WARP_SLOTS * warp * R4;
    const float* const vt = reinterpret_cast<const float*>(kt + TS * R4);

    // S: the lane's slot against every head, over a quarter of the row
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int c = dl + 4 * i;
      const float4 kv = kt[sl * R4 + c];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float4 qv = q4[g * CH + c];
        s[g] = fmaf(qv.x, kv.x, s[g]);
        s[g] = fmaf(qv.y, kv.y, s[g]);
        s[g] = fmaf(qv.z, kv.z, s[g]);
        s[g] = fmaf(qv.w, kv.w, s[g]);
      }
    }
    // the row's four quarters summed; the online softmax over the warp's 8
    // slots (a zero-filled slot would score 0, not -inf; slot s0 is valid,
    // so the new max is finite), O rescaled by each head's alpha
    const bool ok = s0 + sl < valid;
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 8);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
      if (!ok) s[g] = -INFINITY;
      float mx = fmaxf(s[g], __shfl_xor_sync(0xffffffffu, s[g], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[g], mx);
      const float alpha = exp2_ftz(m[g] - mn);
      m[g] = mn;
      s[g] = exp2_ftz(s[g] - mn);
      l[g] = fmaf(l[g], alpha, s[g]);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[g][i][0] *= alpha;
        acc[g][i][1] *= alpha;
      }
    }
    if (dl == 0) {  // P[slot][head] into the warp's buffer
      float* const prow = pw + sl * GP;
      if constexpr (GP % 4 == 0) {
#pragma unroll
        for (int g = 0; g < GP; g += 4)
          *reinterpret_cast<float4*>(prow + g) = make_float4(s[g], s[g + 1], s[g + 2], s[g + 3]);
      } else {
#pragma unroll
        for (int g = 0; g < GP; ++g) prow[g] = s[g];
      }
    }
    __syncwarp();
    // O += P V on the lane's columns, every head of the chunk
#pragma unroll
    for (int j = 0; j < WARP_SLOTS; ++j) {
      float p[GP];
      const float* const prow = pw + j * GP;
      if constexpr (GP % 4 == 0) {
#pragma unroll
        for (int g = 0; g < GP; g += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(prow + g);
          p[g] = p4.x;
          p[g + 1] = p4.y;
          p[g + 2] = p4.z;
          p[g + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < GP; ++g) p[g] = prow[g];
      }
      const float2* const vrow = reinterpret_cast<const float2*>(vt + j * R4 * 4);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c2 = lane + 32 * i;
        if (NV * 64 == D || c2 < D / 2) {
          const float2 x = vrow[c2];
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            acc[g][i][0] = fmaf(p[g], x.x, acc[g][i][0]);
            acc[g][i][1] = fmaf(p[g], x.y, acc[g][i][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();     // and no warp reads the ring any more: it holds the merge

  // the four warps' (m, l, O) per head of the chunk, then one pass merges
  // them and writes this split's state, m in natural-log units
  float* const ms = reinterpret_cast<float*>(smem4);  // [WARPS][GP]
  float* const ls = ms + WARPS * GP;                  // [WARPS][GP]
  float* const as = ls + WARPS * GP;                  // [WARPS][GP][D]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 1);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 2);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 4);
    if (lane == 0) {
      ms[warp * GP + g] = m[g];
      ls[warp * GP + g] = l[g];
    }
    float2* const arow = reinterpret_cast<float2*>(as + (warp * GP + g) * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c2 = lane + 32 * i;
      if (NV * 64 == D || c2 < D / 2) arow[c2] = make_float2(acc[g][i][0], acc[g][i][1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gc * D; idx += THREADS) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * GP + g]);
    const float sub = mx == -INFINITY ? 0.f : mx;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(ms[w * GP + g] - sub);
      a = fmaf(as[(w * GP + g) * D + d], c, a);
      lsum = fmaf(ls[w * GP + g], c, lsum);
    }
    out[2 * G + (g0 + g) * D + d] = a;
    if (d == 0) {
      out[g0 + g] = mx == -INFINITY ? kNegInf : mx * 0.6931471805599453f;
      out[G + g0 + g] = lsum;
    }
  }
}

// f(std::integral_constant<int, GP>{}) for the chunk size gp (head_class's values)
template <typename F>
cudaError_t with_class(int gp, F&& f) {
  switch (gp) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Opt the instance in to its shared memory, once (not a stream operation).
template <int D, int GP>
cudaError_t prepare() {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_decode_partial_ffma<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(D, GP));
  return opt_in;
}

template <int D>
cudaError_t launch(int gp, const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, float* part, int B, int S, int KV, int G, int nsplit,
                   int tiles_per_split, const Strides& st, cudaStream_t stream) {
  const dim3 grid(B * KV, nsplit, (G + max_group(D) - 1) / max_group(D));
  return with_class(gp, [&](auto c) {
    constexpr int GP = decltype(c)::value;
    if constexpr (GP > max_group(D)) {
      return cudaErrorInvalidValue;  // no instance
    } else {
      const cudaError_t opt_in = prepare<D, GP>();
      if (opt_in != cudaSuccess) return opt_in;
      flash_decode_partial_ffma<D, GP><<<grid, THREADS, smem_bytes(D, GP), stream>>>(
          (const float*)q, (const float*)k, (const float*)v, valid_ptr, valid_host, part, S, KV,
          G, tiles_per_split, 1.4426950408889634f / sqrtf((float)D), st);
      return cudaGetLastError();
    }
  });
}

template <int D>
cudaError_t blocks_per_sm(int gp, int* blocks) {
  return with_class(gp, [&](auto c) {
    constexpr int GP = decltype(c)::value;
    if constexpr (GP > max_group(D)) {
      return cudaErrorInvalidValue;  // no instance
    } else {
      cudaError_t e = prepare<D, GP>();
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_decode_partial_ffma<D, GP>,
                                                          THREADS, smem_bytes(D, GP));
      return e;
    }
  });
}

}  // namespace ffma

// Merge the splits of every (b, h): one block of D threads per (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_merge(const float* __restrict__ part, T* __restrict__ o, int H, int KV,
                   int G, int nsplit) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / G, g = h - (h / G) * G;
  const int d = threadIdx.x;
  const float* base = part + ((long long)b * KV + kvh) * nsplit * G * (D + 2);
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, base[(long long)s * G * (D + 2) + g]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* p = base + (long long)s * G * (D + 2);
    const float w = expf(p[g] - mx);
    l = fmaf(p[G + g], w, l);
    a = fmaf(p[2 * G + g * D + d], w, a);
  }
  store(o + (long long)bh * D + d, a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, void* o, float* part, int B, int S, int H,
                   int KV, int nsplit, int tiles_per_split, size_t smem, int hpw,
                   const Strides& st, cudaStream_t stream) {
  const int G = H / KV;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    // every warp scores every head of a chunk of at most 16, 12 at D = 192
    // (a chunk a grid z)
    const int gp = ffma::head_class(G < ffma::max_group(D) ? G : ffma::max_group(D));
    if (smem != (size_t)ffma::smem_bytes(D, gp) || hpw != gp)
      return cudaErrorInvalidValue;  // the plan and this file disagree
    err = ffma::launch<D>(gp, q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream);
  } else {
    // a warp scores every head of the group on the tensor cores
    if (smem != (size_t)mma::smem_bytes<D>() || hpw != G || G > mma::MAX_GROUP)
      return cudaErrorInvalidValue;  // the plan and this file disagree, or G > 16: no instance
    err = mma::launch<D>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream);
  }
  if (err != cudaSuccess) return err;
  flash_decode_merge<T, D><<<B * H, D, 0, stream>>>(part, (T*)o, H, KV, G, nsplit);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, last dims
// contiguous; the output is contiguous (B, H, D).  valid_ptr (device int32)
// wins over valid_host when it is not null.  part is f32 scratch of
// B*KV*nsplit*G*(D+2) floats.  smem: the partial kernel's dynamic shared
// memory and hpw its heads per warp (bf16: G; f32: the chunk size,
// head_class of min(G, 16), 12 at D = 192), as the wrapper's plan has them
// (checked against this file's).
// Returns a cudaError_t.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* valid_ptr, long long valid_host, void* o,
                            void* part, int dtype, int B, int S, int H, int KV, int D,
                            int nsplit, int tiles_per_split, long long qb, long long qh,
                            long long kb, long long ks, long long kh, long long vb,
                            long long vs, long long vh, long long smem, int hpw,
                            void* stream) {
  const Strides st{qb, qh, kb, ks, kh, vb, vs, vh};
  const cudaStream_t s = (cudaStream_t)stream;
  const int* vp = (const int*)valid_ptr;
  float* pt = (float*)part;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 0 && D == 80)
    return (int)launch<float, 80>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 0 && D == 192)
    return (int)launch<float, 192>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 1 && D == 80)
    return (int)launch<__nv_bfloat16, 80>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  if (dtype == 1 && D == 192)
    return (int)launch<__nv_bfloat16, 192>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, (size_t)smem, hpw, st, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the partial kernel that one SM holds, as the runtime's occupancy
// calculator has it: the instance the wrapper's plan takes for dtype (0 =
// float32, 1 = bfloat16), head dim D and hpw heads per warp (f32: ffma:: at
// chunk size hpw; bf16: mma::, whatever hpw).  Returns a cudaError_t.
extern "C" int flash_decode_blocks_per_sm(int dtype, int D, int hpw, int* blocks) {
  if (dtype == 0) {
    switch (D) {
      case 64: return (int)ffma::blocks_per_sm<64>(hpw, blocks);
      case 80: return (int)ffma::blocks_per_sm<80>(hpw, blocks);
      case 128: return (int)ffma::blocks_per_sm<128>(hpw, blocks);
      case 192: return (int)ffma::blocks_per_sm<192>(hpw, blocks);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return (int)mma::blocks_per_sm<64>(blocks);
    case 80: return (int)mma::blocks_per_sm<80>(blocks);
    case 128: return (int)mma::blocks_per_sm<128>(blocks);
    case 192: return (int)mma::blocks_per_sm<192>(blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
