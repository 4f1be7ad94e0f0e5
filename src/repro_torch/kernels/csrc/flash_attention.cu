// Flash attention forward (online softmax), causal or not, with GQA routing.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel).  For every (batch b, query head h)
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(D)) v[b, j, h/G]
// over keys j < S (and j <= i when causal), G = H / KV query heads per KV
// head.  Inputs are read in their (B, S, heads, D) layout through the
// strides the wrapper passes (last dim contiguous), so the model's q/k/v
// need no transpose and the KV heads are never repeated; the output is
// written contiguous (B, S, H, D).  Running max, denominator and
// accumulator are f32; denom = max(l, 1e-30); the result is cast to the
// input type (round to nearest even for bf16).  The ragged S edge is masked
// from indices (keys >= S get no weight, rows >= S are not written): no
// zero-padded copy of the inputs.
//
// What bounds it on an H100: operations.  It does 4*B*H*S^2*D/2 flops for
// a causal call (S = 8192, H = 32, D = 128: 5.5e11, 0.56 ms at the 989
// TFLOP/s bf16 tensor-core peak) against a few bytes per flop of traffic.
// This first kernel runs them on the f32 CUDA cores (67 TFLOP/s peak, so
// at best ~15x off the tensor-core bound); mma.sync / wgmma are later work.
// Design for that: one block of 128 threads per (b*h, 64-query tile), two
// threads per query row, each holding an interleaved half of D of the
// scaled query and of the accumulator in registers (the score is the sum
// of the two halves' dots, one shuffle).  K and V tiles of 32 keys are
// staged in shared memory as f32 and read by the whole warp as broadcast
// float4 loads, so each shared load feeds four FMAs; a loop over key tiles
// replaces the TPU's sequential k grid axis, and tiles above the causal
// diagonal are never loaded.  Query tiles are issued heaviest first
// (reverse order), so the long causal rows do not trail the grid.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per shared-memory tile
constexpr int THREADS = 2 * BQ;  // two threads per query row
constexpr int CH = 16;           // keys scored per online-softmax update

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of T from global memory (16-byte aligned) into floats.
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

// Dim of the c-th float4 chunk a thread of `half` owns: the two halves
// interleave by 4, so the warp's two broadcast addresses sit in different
// banks.
__device__ __forceinline__ int chunk_dim(int c, int half) { return (2 * c + half) * 4; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H,
                       int G, int causal, float scale, Strides st) {
  constexpr int HD = D / 2;   // dims per thread
  constexpr int NC = HD / 4;  // float4 chunks per thread
  constexpr int VN = Vec<T>::N;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x;
  const int row = q0 + (tid >> 1);
  const int half = tid & 1;

  float qr[HD], acc[HD];
  const T* qp = q + b * st.qb + (long long)row * st.qs + h * st.qh;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = row < S ? to_f32(qp[chunk_dim(c, half) + e]) * scale : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  const int key_end = causal ? min(q0 + BQ, S) : S;  // keys this tile can see
  const int ntiles = (key_end + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid * VN; idx < BK * D; idx += THREADS * VN) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int key = k0 + r;
      if (key < S) {
        load16(kbase + (long long)key * st.ks + c, &ks[r][c]);
        load16(vbase + (long long)key * st.vs + c, &vs[r][c]);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          ks[r][c + e] = 0.f;
          vs[r][c + e] = 0.f;
        }
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += CH) {
      float p[CH];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float* kr = &ks[c0 + j][0];
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + chunk_dim(c, half));
          dot = fmaf(qr[4 * c], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int key = k0 + c0 + j;
        const bool ok = key < S && (!causal || key <= row);
        p[j] = ok ? dot : kNegInf;
        cmax = fmaxf(cmax, p[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int key = k0 + c0 + j;
        const bool ok = key < S && (!causal || key <= row);
        p[j] = ok ? expf(p[j] - m_new) : 0.f;
        psum += p[j];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float* vr = &vs[c0 + j][0];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + chunk_dim(c, half));
          acc[4 * c] = fmaf(p[j], vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p[j], vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p[j], vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p[j], vv.w, acc[4 * c + 3]);
        }
      }
    }
  }

  if (row < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) store(op + chunk_dim(c, half) + e, acc[4 * c + e] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int KV, int causal, const Strides& st, cudaStream_t stream) {
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, H / KV, causal,
      1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of q/k/v is contiguous and the output is contiguous (B, S, H, D).
// Returns a cudaError_t (cudaErrorInvalidValue for a D or dtype without an
// instance).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int S, int H, int KV, int D,
                               int causal, long long qb, long long qs, long long qh,
                               long long kb, long long ks, long long kh, long long vb,
                               long long vs, long long vh, void* stream) {
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(q, k, v, o, B, S, H, KV, causal, st, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(q, k, v, o, B, S, H, KV, causal, st, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KV, causal, st, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KV, causal, st, s);
  return (int)cudaErrorInvalidValue;
}
