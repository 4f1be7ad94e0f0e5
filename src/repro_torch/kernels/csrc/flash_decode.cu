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
// * bf16 (ring::): K and V stay bf16 in shared memory, fed by cp.async.cg
//   16-byte copies into a ring of STAGES tiles (2 at D = 192, 3 at D = 128,
//   4 at D = 64, 80: at most ~110 KB, so two blocks fit on an SM), with one
//   block barrier per tile.  Warp w serves heads w, w + 4, ... of the group
//   with their scaled queries in registers; a cache row is read by D/8
//   lanes, 16 bytes each, in a lane group of the next power of two (8, 16,
//   32; 16 at D = 80, where lanes 10-15 of a group load nothing and add 0,
//   and 32 at D = 192, where lanes 24-31 do), and the dot is reduced across
//   the group with xor shuffles, so a warp scores 1 (D = 192), 2 (D = 80,
//   128) or 4 (D = 64) rows at once, each lane group keeping its own online
//   softmax (chunks of 8 rows per update, exp2 on log2-scaled scores) that
//   the warp merges with shuffles at the end.  With two stages the copy of
//   tile t + 1 is in flight while tile t is scored.
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
  static_assert(D % 8 == 0 && D <= 256, "a cache row is whole 16-byte chunks, at most 32");
  constexpr int NST = stages<D>();
  constexpr int LPR = D / 8;        // lanes that load a cache row, 16 bytes each
  constexpr int LG = LPR <= 8 ? 8 : (LPR <= 16 ? 16 : 32);  // lanes per row group
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

template <int D, int HPW>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_ptr,
                   long long valid_host, float* part, int B, int S, int KV, int G, int nsplit,
                   int tiles_per_split, const Strides& st, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_decode_partial_ring<D, HPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (opt_in != cudaSuccess) return opt_in;
  flash_decode_partial_ring<D, HPW><<<dim3(B * KV, nsplit), THREADS, smem_bytes<D>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, valid_ptr,
      valid_host, part, S, KV, G, tiles_per_split, 1.4426950408889634f / sqrtf((float)D), st);
  return cudaGetLastError();
}

}  // namespace ring

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
