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
// Three partial kernels:
//
// * bf16 at D = 64, 80 (ring::): K and V stay bf16 in shared memory, fed by
//   cp.async.cg 16-byte copies into a ring of 4 tiles (at most ~110 KB, so
//   3 blocks fit on an SM at D = 64 and 2 at D = 80), with one block
//   barrier per tile.  Warp w serves heads w, w + 4, ... of the group with
//   their scaled queries in registers; a cache row is read by D/8 lanes, 16
//   bytes each, in a lane group of the next power of two (8, or 16 at
//   D = 80, where lanes 10-15 of a group load nothing and add 0), and the
//   dot is reduced across the group with xor shuffles, so a warp scores 4
//   (D = 64) or 2 (D = 80) rows at once, each lane group keeping its own
//   online softmax (chunks of 8 rows per update, exp2 on log2-scaled
//   scores) that the warp merges with shuffles at the end.
// * bf16 at D = 128 and 192 (mma::).  Bytes bound it too (D = 192, B 8 x
//   32768 slots x 8 KV heads: 1.61 GB, 0.481 ms at 3.35 TB/s), but a
//   CUDA-core scorer would not keep up: at D = 192 and group 12 its
//   4*B*H*S*D = 1.93e10 multiply-adds take 0.288 ms at 67 TFLOP/s before
//   any shuffle or exp (the ring took 3.15 ms there, and 2x the bound at
//   D = 128, group 8), so the scoring runs on the tensor cores, where it
//   costs almost nothing.
//   1. The copy is the ring's: cp.async.cg 16-byte chunks into 2 stages of
//      64-slot K and V tiles (96 KB at D = 192, 64 KB at D = 128),
//      zero-filled past valid_len, each chunk c of row r stored at chunk
//      c ^ (r & 7) of its row (`swizzled`): a 384- or 256-byte row is 0 mod
//      128, and unswizzled the 8 rows one ldmatrix reads would share a bank
//      group (8-way conflicts).
//   2. Warp w owns slots [16w, 16w + 16) of every tile, so all four warps
//      score at any group size and each K/V byte is read from shared
//      memory once.
//   3. mma.sync m16n8k16 (bf16 in, f32 sums; a wgmma needs 64 rows of M,
//      which one KV head's query heads do not have).  The group's G <= 16
//      heads are the M rows (zero rows past G), the warp's 16 slots the N
//      of S = Q K^T and the K of O = P V: S's f32 accumulators are then P's
//      A fragment as they stand, rounded to bf16 in registers.  (Slots as M
//      and heads as N would waste less at group 1, but P^T would have to be
//      reshuffled across lanes into a B fragment; the tensor cores are idle
//      either way.)  Q's A fragments are loaded once per block, unscaled;
//      S is scaled in f32 by log2(e)/sqrt(D) after the product.  K's B
//      fragments come by ldmatrix, V's by ldmatrix.trans, from the
//      swizzled tile.  The online softmax runs per head row in log2 units;
//      slots >= valid_len score -inf (a zero-filled row would score 0).
//      Each lane holds its rows of the 16 x D f32 accumulator as D/8 n8
//      tiles (96 registers at D = 192).
//   4. After the last tile the ring is free: each warp's (m, l, acc) for the
//      group's heads goes there (4 x 16 x (D + 2) floats at most, 49.7 KB at
//      D = 192), and one pass merges the four warps and writes the split's
//      state as the ring kernel does, so the merge kernel is the same.  A
//      block whose split holds no valid tile writes the empty state and
//      loads nothing.
//   5. Its shared memory holds 2 blocks on an SM at D = 192 and 3 at
//      D = 128, and the launch bounds keep registers from binding first
//      (`min_blocks`): 264 or 396 on the card.  The wrapper's plan sizes the
//      split-K grid to that: B*KV*splits within one wave where B*KV allows
//      (at D = 192, B 8 x 8 KV heads x 32768 slots: 4 splits of 128 tiles,
//      256 blocks, where a target of 4 x 132 blocks gave 9 splits, 576
//      blocks, 2.18 waves), else one split per (b, kv).
//   6. The C entry checks the plan's shared memory and heads per warp (G)
//      against this file's, and G <= 16.
//   With two stages, the copy of tile t + 1 is in flight while tile t is
//   scored.
// * f32 (flash_decode_partial): tiles staged as f32 (K row-padded to D+1
//   floats so the score loop is bank-conflict free), scores and the update
//   through shared memory with four block barriers per tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int DBK = 64;       // cache slots per tile
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
// the head dims whose bf16 instance is mma:: (the others' is ring::)
__host__ __device__ constexpr bool on_mma(int D) { return D == 128 || D == 192; }

struct Strides {
  long long qb, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  if constexpr (std::is_same<T, float>::value) {
    dst[0] = __uint_as_float(raw.x);
    dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z);
    dst[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ int valid_of(const int* valid_ptr, long long valid_host, int S) {
  const long long vl = valid_ptr ? (long long)*valid_ptr : valid_host;
  return (int)(vl < 0 ? 0 : (vl > S ? S : vl));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ valid_ptr,
                     long long valid_host, float* __restrict__ part, int S, int KV,
                     int G, int tiles_per_split, float scale, Strides st) {
  constexpr int VN = Vec<T>::N;
  constexpr int KP = D + 1;  // padded K row
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // DBK x KP
  float* vs = ks + DBK * KP;      // DBK x D
  float* qs = vs + DBK * D;       // G x D, scaled
  float* acc = qs + G * D;        // G x D
  float* ps = acc + G * D;        // G x DBK: scores, then weights
  float* mrow = ps + G * DBK;     // G
  float* lrow = mrow + G;         // G
  float* arow = lrow + G;         // G: this tile's rescale

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = valid_of(valid_ptr, valid_host, S);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (valid + DBK - 1) / DBK);

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx - (idx / D) * D;
    qs[idx] = to_f32(q[b * st.qb + (long long)(kvh * G + g) * st.qh + d]) * scale;
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = kNegInf;
    lrow[g] = 0.f;
  }

  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  for (int t = t_begin; t < t_end; ++t) {
    const int s0 = t * DBK;
    __syncthreads();  // the previous tile is consumed (and the init is done)
    for (int idx = tid * VN; idx < DBK * D; idx += THREADS * VN) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int slot = s0 + r;
      float kf[VN], vf[VN];
      if (slot < valid) {
        load16(kbase + (long long)slot * st.ks + c, kf);
        load16(vbase + (long long)slot * st.vs + c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[r * KP + c + e] = kf[e];
        vs[r * D + c + e] = vf[e];
      }
    }
    __syncthreads();
    // scores: one (head, slot) pair per thread and step
    for (int idx = tid; idx < G * DBK; idx += THREADS) {
      const int g = idx / DBK, j = idx - (idx / DBK) * DBK;
      const float* qg = qs + g * D;
      const float* kr = ks + j * KP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
      ps[idx] = s0 + j < valid ? dot : kNegInf;
    }
    __syncthreads();
    // online-softmax update: one warp per head
    for (int g = warp; g < G; g += WARPS) {
      const float x0 = ps[g * DBK + lane], x1 = ps[g * DBK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 + lane < valid ? expf(x0 - m_new) : 0.f;
      const float p1 = s0 + lane + 32 < valid ? expf(x1 - m_new) : 0.f;
      ps[g * DBK + lane] = p0;
      ps[g * DBK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        lrow[g] = lrow[g] * alpha + sum;
        mrow[g] = m_new;
        arow[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: one (head, dim) pair per thread and step
    for (int idx = tid; idx < G * D; idx += THREADS) {
      const int g = idx / D, d = idx - (idx / D) * D;
      const float* pg = ps + g * DBK;
      float a = acc[idx] * arow[g];
#pragma unroll 16
      for (int j = 0; j < DBK; ++j) a = fmaf(pg[j], vs[j * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  // partial state of this split: part[(bk, split)] = [m (G), l (G), acc (G x D)]
  float* out = part + ((long long)bk * nsplit + split) * G * (D + 2);
  for (int g = tid; g < G; g += THREADS) {
    out[g] = mrow[g];
    out[G + g] = lrow[g];
  }
  for (int idx = tid; idx < G * D; idx += THREADS) out[2 * G + idx] = acc[idx];
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

// ---- bf16: cp.async ring ---------------------------------------------------
namespace ring {

// Ring depth: as many 64-slot K+V tiles as fit in ~110 KB, at most 4.
template <int D>
__host__ __device__ constexpr int stages() {
  return (110 * 1024) / (2 * DBK * D * 2) < 4 ? (110 * 1024) / (2 * DBK * D * 2) : 4;
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return stages<D>() * 2 * DBK * D * 2;
}

// 8 bf16 (16 bytes) into floats.
__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int D, int HPW>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial_ring(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid_ptr,
                          long long valid_host, float* __restrict__ part, int S, int KV, int G,
                          int tiles_per_split, float scale_log2, Strides st) {
  static_assert(D % 8 == 0 && D <= 128, "a cache row is whole 16-byte chunks, at most 16");
  constexpr int NST = stages<D>();
  constexpr int LPR = D / 8;        // lanes that load a cache row, 16 bytes each
  constexpr int LG = LPR <= 8 ? 8 : 16;  // lanes per row group
  constexpr int RPW = 32 / LG;      // rows a warp scores at once
  constexpr int ROWB = D * 2;       // bytes per cache row
  constexpr int TILEB = DBK * ROWB;
  constexpr int CHUNK = 8;          // rows per lane group per softmax update
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = valid_of(valid_ptr, valid_host, S);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (valid + DBK - 1) / DBK);
  const int grp = lane / LG, cl = lane % LG;  // row group, 16-byte chunk
  const bool loads = LPR == LG || cl < LPR;   // a lane past the row loads nothing
  // 16 bytes of a cache row in smem into floats (zeros for a lane past the row)
  auto row_chunk = [&](const uint8_t* tile, int j, float* f) {
    if (loads) {
      unpack8(*reinterpret_cast<const uint4*>(tile + j * ROWB + cl * 16), f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
  };

  float qr[HPW][8], acc[HPW][8], m[HPW], l[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + WARPS * i;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < G && loads) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(q + b * st.qb + (long long)(kvh * G + g) * st.qh + cl * 8)), f);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[i][e] = f[e] * scale_log2;
      acc[i][e] = 0.f;
    }
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  const __nv_bfloat16* kbase = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vbase = v + b * st.vb + kvh * st.vh;
  // tile t into stage `stage`: slots at or past valid_len are zero-filled
  auto load_tile = [&](int t, int stage) {
    const uint32_t ks = ring0 + stage * 2 * TILEB, vs = ks + TILEB;
    for (int c = tid; c < DBK * LPR; c += THREADS) {
      const int r = c / LPR, ch = c - (c / LPR) * LPR;
      const int slot = t * DBK + r;
      const bool ok = slot < valid;
      const long long koff = ok ? (long long)slot * st.ks + ch * 8 : 0;
      const long long voff = ok ? (long long)slot * st.vs + ch * 8 : 0;
      cp_async16(ks + r * ROWB + ch * 16, kbase + koff, ok ? 16 : 0);
      cp_async16(vs + r * ROWB + ch * 16, vbase + voff, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    cp_async_wait<NST - 2>();  // this thread's copies of tile t are done
    __syncthreads();           // everyone's are, and the stage reloaded below is consumed
    if (t + NST - 1 < t_end) load_tile(t + NST - 1, (it + NST - 1) % NST);
    cp_async_commit();
    if (warp >= G) continue;  // a warp with no head of the group only loads
    const uint8_t* ks = smem + (it % NST) * 2 * TILEB;
    const uint8_t* vs = ks + TILEB;
#pragma unroll 1
    for (int c0 = 0; c0 < DBK / RPW; c0 += CHUNK) {
      float sc[HPW][CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = (c0 + u) * RPW + grp;
        float kf[8];
        row_chunk(ks, j, kf);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[i][e], kf[e], dot);
#pragma unroll
          for (int off = LG / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[i][u] = t * DBK + j < valid ? dot : -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) mx = fmaxf(mx, sc[i][u]);
        const float sub = mx == -INFINITY ? 0.f : mx;  // no valid row yet: no NaN
        const float alpha = exp2f(m[i] - sub);
        m[i] = mx;
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          sc[i][u] = exp2f(sc[i][u] - sub);
          ps += sc[i][u];
        }
        l[i] = l[i] * alpha + ps;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = (c0 + u) * RPW + grp;
        float vf[8];
        row_chunk(vs, j, vf);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(sc[i][u], vf[e], acc[i][e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // merge the warp's lane groups, then write this split's state per head:
  // part[(bk, split)] = [m (G), l (G), acc (G x D)], m in natural-log units
  float* out = part + ((long long)bk * nsplit + split) * G * (D + 2);
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
#pragma unroll
    for (int off = LG; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mx = fmaxf(m[i], mo);
      const float sub = mx == -INFINITY ? 0.f : mx;
      const float a = exp2f(m[i] - sub), c = exp2f(mo - sub);
      l[i] = l[i] * a + lo * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * a + ao * c;
      }
      m[i] = mx;
    }
    const int g = warp + WARPS * i;
    if (g < G && lane < LPR) {
      if (lane == 0) {
        out[g] = m[i] == -INFINITY ? kNegInf : m[i] * 0.6931471805599453f;
        out[G + g] = l[i];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) out[2 * G + g * D + cl * 8 + e] = acc[i][e];
    }
  }
}

// Opt the instance in to its shared memory, once (not a stream operation).
template <int D, int HPW>
cudaError_t prepare() {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_decode_partial_ring<D, HPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  return opt_in;
}

template <int D, int HPW>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, float* part, int B, int S, int KV, int G, int nsplit,
                   int tiles_per_split, const Strides& st, cudaStream_t stream) {
  const cudaError_t opt_in = prepare<D, HPW>();
  if (opt_in != cudaSuccess) return opt_in;
  flash_decode_partial_ring<D, HPW><<<dim3(B * KV, nsplit), THREADS, smem_bytes<D>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, valid_ptr,
      valid_host, part, S, KV, G, tiles_per_split, 1.4426950408889634f / sqrtf((float)D), st);
  return cudaGetLastError();
}

template <int D, int HPW>
cudaError_t blocks_per_sm(int* blocks) {
  cudaError_t e = prepare<D, HPW>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_decode_partial_ring<D, HPW>,
                                                      THREADS, smem_bytes<D>());
  return e;
}

}  // namespace ring

// ---- bf16 at D = 128, 192: tensor-core scoring -----------------------------
namespace mma {

constexpr int STAGES = 2;                   // 64-slot K+V tiles in the ring
constexpr int WARP_SLOTS = DBK / WARPS;     // warp w owns slots [16w, 16w + 16) of every tile
constexpr int MAX_GROUP = 16;               // query heads: the M rows of one m16n8k16

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * 2 * DBK * D * 2;
}
// Blocks per SM the launch bounds ask for: as many as the shared memory
// holds (228 KB: 2 of 96 KB at D = 192, 3 of 64 KB at D = 128), so the
// registers (at most 255 or 168 a thread) never bind first.
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D > 128 ? 2 : 3;
}

// Byte offset in a tile of 16-byte chunk c of cache row r.  A row is D * 2
// = 256 or 384 bytes, 0 mod 128, so the 8 rows that one ldmatrix reads at
// one chunk would share a bank group; stored at chunk c ^ (r & 7) of its
// row they take 8 distinct ones.  The copy and the reads use this one map.
template <int D>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
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
  static_assert(D % 64 == 0, "a cache row is whole groups of eight 16-byte chunks");
  static_assert(WARP_SLOTS == 16, "a warp's slots are the N of two n8 tiles, the K of one k16");
  static_assert(WARPS * 16 * (D + 2) * 4 <= smem_bytes<D>(), "the warps' states fit in the ring");
  constexpr int CH = D / 8;     // 16-byte chunks in a cache row
  constexpr int TILEB = DBK * D * 2;
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
  // tile t into stage `stage`, swizzled: slots at or past valid_len are zero-filled
  auto load_tile = [&](int t, int stage) {
    const uint32_t ks = ring0 + stage * 2 * TILEB, vs = ks + TILEB;
    for (int c = tid; c < DBK * CH; c += THREADS) {
      const int r = c / CH, ch = c - (c / CH) * CH;
      const int slot = t * DBK + r;
      const bool ok = slot < valid;
      const long long koff = ok ? (long long)slot * st.ks + ch * 8 : 0;
      const long long voff = ok ? (long long)slot * st.vs + ch * 8 : 0;
      cp_async16(ks + swizzled<D>(r, ch), kbase + koff, ok ? 16 : 0);
      cp_async16(vs + swizzled<D>(r, ch), vbase + voff, ok ? 16 : 0);
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
      ldmatrix_x4(ks + swizzled<D>(k_row, 2 * kk + k_ch), kb);
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
      ldmatrix_x4_trans(vs + swizzled<D>(v_row, 2 * jj + v_ch), vb);
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

// The f32 partial kernel's dynamic shared memory.
template <int D>
size_t cc_smem_bytes(int G) {
  return sizeof(float) * ((size_t)DBK * (D + 1) + (size_t)DBK * D + 2 * (size_t)G * D +
                          (size_t)G * DBK + 3 * (size_t)G);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, void* o, float* part, int B, int S, int H,
                   int KV, int nsplit, int tiles_per_split, size_t smem, int hpw,
                   const Strides& st, cudaStream_t stream) {
  const int G = H / KV;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    if (smem != cc_smem_bytes<D>(G)) return cudaErrorInvalidValue;  // the plan disagrees
    // Opt in to the card's full shared memory once per instance (outside any
    // graph capture's stream work: it is not a stream operation).
    static const cudaError_t opt_in = [] {
      int dev = 0, optin = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(flash_decode_partial<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      return e;
    }();
    if (opt_in != cudaSuccess) return opt_in;
    flash_decode_partial<T, D><<<dim3(B * KV, nsplit), THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, valid_ptr, valid_host, part, S, KV, G,
        tiles_per_split, 1.0f / sqrtf((float)D), st);
    err = cudaGetLastError();
  } else if constexpr (on_mma(D)) {
    // a warp scores every head of the group on the tensor cores
    if (smem != (size_t)mma::smem_bytes<D>() || hpw != G || G > mma::MAX_GROUP)
      return cudaErrorInvalidValue;  // the plan and this file disagree, or G > 16: no instance
    err = mma::launch<D>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream);
  } else {
    if (smem != (size_t)ring::smem_bytes<D>() || hpw != (G + WARPS - 1) / WARPS)
      return cudaErrorInvalidValue;  // the plan and this file disagree
    switch (hpw) {
      case 1: err = ring::launch<D, 1>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream); break;
      case 2: err = ring::launch<D, 2>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream); break;
      case 3: err = ring::launch<D, 3>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream); break;
      case 4: err = ring::launch<D, 4>(q, k, v, valid_ptr, valid_host, part, B, S, KV, G, nsplit, tiles_per_split, st, stream); break;
      default: return cudaErrorInvalidValue;  // G > 16: no instance
    }
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
// memory and hpw the bf16 kernel's heads per warp (f32 ignores it), as the
// wrapper's plan has them (checked against this file's).
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

// Blocks of the bf16 partial kernel that one SM holds, as the runtime's
// occupancy calculator has it: the instance the wrapper's plan takes for
// head dim D and hpw heads per warp (the tensor-core instance at D = 128, 192).
// Returns a cudaError_t.
extern "C" int flash_decode_blocks_per_sm(int D, int hpw, int* blocks) {
  if (D == 128) return (int)mma::blocks_per_sm<128>(blocks);
  if (D == 192) return (int)mma::blocks_per_sm<192>(blocks);
  switch (D * 8 + hpw) {
    case 64 * 8 + 1: return (int)ring::blocks_per_sm<64, 1>(blocks);
    case 64 * 8 + 2: return (int)ring::blocks_per_sm<64, 2>(blocks);
    case 64 * 8 + 3: return (int)ring::blocks_per_sm<64, 3>(blocks);
    case 64 * 8 + 4: return (int)ring::blocks_per_sm<64, 4>(blocks);
    case 80 * 8 + 1: return (int)ring::blocks_per_sm<80, 1>(blocks);
    case 80 * 8 + 2: return (int)ring::blocks_per_sm<80, 2>(blocks);
    case 80 * 8 + 3: return (int)ring::blocks_per_sm<80, 3>(blocks);
    case 80 * 8 + 4: return (int)ring::blocks_per_sm<80, 4>(blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
