// K2: GroupNorm statistics for Hopper (sm_90a).
//
// Replaces the statistics half of the TPU kernels in
// sid_lsg_tpu/ops/groupnorm.py: the in-block reduction of
// _gn_silu_pallas_fwd and the reduce pass of _gn_tiled_pallas_fwd.  Same
// function as the plain reference _group_norm_ref: per (sample, group) f32
// mean and rstd = 1/sqrt(max(E[x^2] - E[x]^2, 0) + eps).  The clamp at 0
// follows the reference; the Pallas kernels leave it out.
//
// In NCHW each (sample, group) is one contiguous span of cg*H*W elements, so
// any channel count that the group count divides is taken (the TPU kernels'
// C % 128 lane rule does not apply here).
//
// What bounds it on the H100: it reads every activation once and does two
// f32 operations per element, far below the card's ~295 operations per byte,
// so device-memory bytes bound it.  The design reads 16 bytes per thread per
// step where the span allows it, and splits a long span (the VAE decoder's
// 512x512 maps hold 1M elements per group) over many blocks so that the whole
// card streams it: pass 1 writes per-block partial sums, pass 2 folds them
// per group.  No block depends on another's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GN_THREADS = 256;

__device__ __forceinline__ void add_vec(const float* p, float& s, float& ss) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  s += f.x + f.y + f.z + f.w;
  ss += f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
}

__device__ __forceinline__ void add_vec(const __nv_bfloat16* p, float& s, float& ss) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x + f.y;
    ss += f.x * f.x + f.y * f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// grid (groups_total, splits).  Block (g, split) reduces elements
// [split * chunk, min(span, (split + 1) * chunk)) of span g.
template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_partial(const T* __restrict__ x, float* __restrict__ part, long long span, long long chunk,
           int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x;
  const long long beg = (long long)blockIdx.y * chunk;
  const long long end = min(span, beg + chunk);
  const T* base = x + g * span;
  float s = 0.f, ss = 0.f;
  if (vec) {  // span, chunk multiples of VEC and x 16-byte aligned
    for (long long i = beg + threadIdx.x * VEC; i < end; i += GN_THREADS * VEC) add_vec(base + i, s, ss);
  } else {
    for (long long i = beg + threadIdx.x; i < end; i += GN_THREADS) {
      const float f = to_f32(base[i]);
      s += f;
      ss += f * f;
    }
  }
  __shared__ float red[2][GN_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int w = 0; w < GN_THREADS / 32; ++w) {
      ts += red[0][w];
      tss += red[1][w];
    }
    const size_t o = (size_t(g) * gridDim.y + blockIdx.y) * 2;
    part[o] = ts;
    part[o + 1] = tss;
  }
}

__global__ void gn_finalize(const float* __restrict__ part, float* __restrict__ mean,
                            float* __restrict__ rstd, int groups_total, int splits, long long span,
                            float eps) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups_total) return;
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < splits; ++i) {
    s += part[(size_t(g) * splits + i) * 2];
    ss += part[(size_t(g) * splits + i) * 2 + 1];
  }
  const float n = float(span);
  const float mu = s / n;
  const float var = fmaxf(ss / n - mu * mu, 0.f);
  mean[g] = mu;
  rstd[g] = 1.f / sqrtf(var + eps);
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* mean, float* rstd, int groups_total,
                   long long span, int splits, long long chunk, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec = (span % VEC == 0) && (chunk % VEC == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  gn_partial<T><<<dim3(groups_total, splits), GN_THREADS, 0, st>>>(static_cast<const T*>(x), part,
                                                                    span, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize<<<(groups_total + 255) / 256, 256, 0, st>>>(part, mean, rstd, groups_total, splits,
                                                          span, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: groups_total contiguous spans of `span` elements (NCHW viewed as
// (N*G, cg*H*W)).  part: f32 scratch of groups_total*splits*2.  mean, rstd:
// f32 (groups_total,).  Each of the `splits` blocks of a span reduces `chunk`
// elements.  dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t.
int sidlsg_gn_stats(const void* x, void* part, void* mean, void* rstd, int groups_total,
                    long long span, int splits, long long chunk, float eps, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups_total <= 0 || span <= 0 || splits <= 0 || splits > 65535 || chunk <= 0 ||
      chunk * splits < span)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return launch<float>(x, p, m, r, groups_total, span, splits, chunk, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, p, m, r, groups_total, span, splits, chunk, eps, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
