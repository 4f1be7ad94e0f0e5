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
// a contiguous range of 64-slot tiles, loads each K/V tile into shared
// memory once (16-byte global loads, K row-padded to D+1 floats so the
// score loop is bank-conflict free) and serves all G query heads of the
// group from it, so the cache is read once and not G times.  Tiles at or
// past valid_len are never loaded.  Each block writes its (m, l, acc) per
// head; a second small kernel merges the splits per (b, h).  The split
// count is chosen by the wrapper from B*KV and S so that the grid fills the
// card's 132 SMs even at batch 1.
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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
                   int KV, int nsplit, int tiles_per_split, const Strides& st,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)DBK * (D + 1) + (size_t)DBK * D +
                                       2 * (size_t)G * D + (size_t)G * DBK + 3 * (size_t)G);
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
  cudaError_t err;
  flash_decode_partial<T, D><<<dim3(B * KV, nsplit), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, valid_ptr, valid_host, part, S, KV, G,
      tiles_per_split, 1.0f / sqrtf((float)D), st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge<T, D><<<B * H, D, 0, stream>>>(part, (T*)o, H, KV, G, nsplit);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, last dims
// contiguous; the output is contiguous (B, H, D).  valid_ptr (device int32)
// wins over valid_host when it is not null.  part is f32 scratch of
// B*KV*nsplit*G*(D+2) floats.  Returns a cudaError_t.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* valid_ptr, long long valid_host, void* o,
                            void* part, int dtype, int B, int S, int H, int KV, int D,
                            int nsplit, int tiles_per_split, long long qb, long long qh,
                            long long kb, long long ks, long long kh, long long vb,
                            long long vs, long long vh, void* stream) {
  const Strides st{qb, qh, kb, ks, kh, vb, vs, vh};
  const cudaStream_t s = (cudaStream_t)stream;
  const int* vp = (const int*)valid_ptr;
  float* pt = (float*)part;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, st, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, st, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, st, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, vp, valid_host, o, pt, B, S, H, KV, nsplit, tiles_per_split, st, s);
  return (int)cudaErrorInvalidValue;
}
