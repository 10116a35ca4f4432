// Pieces shared by the GroupNorm kernels K2 (gn_stats.cu), K3 (gn_apply.cu)
// and K8 (gn_fused.cu): conversions of the activation dtype (f32 or bf16) to
// f32 and back, the per-channel affine (+SiLU) as the plain version
// _group_norm_ref folds it, sums over 16-byte vectors, the block sum of a
// (sum, sum of squares) pair and the cluster launch.
//
// Every kernel computes in f32.  The affine is evaluated as
// x * scale_c + bias_c with scale_c = rstd * gamma_c and
// bias_c = beta_c - (mean * rstd) * gamma_c, so that kernels and plain
// version round alike.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) { *p = __float2bfloat16(y); }

__device__ __forceinline__ float act(float y, int silu) { return silu ? y / (1.f + expf(-y)) : y; }

// s += the 16 bytes' values, ss += their squares (4 f32 or 8 bf16); the
// pointer argument only picks the dtype.
__device__ __forceinline__ void add16(const uint4& raw, float& s, float& ss, const float*) {
  const float f[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                      __uint_as_float(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += f[i];
    ss += f[i] * f[i];
  }
}

__device__ __forceinline__ void add16(const uint4& raw, float& s, float& ss, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x + f.y;
    ss += f.x * f.x + f.y * f.y;
  }
}

// act(x * sc + bi) over the 16 bytes' values, in the same dtype.
__device__ __forceinline__ uint4 apply16(uint4 raw, float sc, float bi, int silu, const float*) {
  raw.x = __float_as_uint(act(__uint_as_float(raw.x) * sc + bi, silu));
  raw.y = __float_as_uint(act(__uint_as_float(raw.y) * sc + bi, silu));
  raw.z = __float_as_uint(act(__uint_as_float(raw.z) * sc + bi, silu));
  raw.w = __float_as_uint(act(__uint_as_float(raw.w) * sc + bi, silu));
  return raw;
}

__device__ __forceinline__ uint4 apply16(uint4 raw, float sc, float bi, int silu,
                                         const __nv_bfloat16*) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    f.x = act(f.x * sc + bi, silu);
    f.y = act(f.y * sc + bi, silu);
    h[i] = __float22bfloat162_rn(f);
  }
  return raw;
}

// The block's total of (s, ss), in thread 0 (other threads: undefined).
// `red` holds THREADS / 32 pairs of shared memory.  The order of the sums
// is fixed, so equal inputs give equal totals.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float s, float ss, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = make_float2(s, ss);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
  }
  return t;
}

// mean and 1 / sqrt(max(E[x^2] - E[x]^2, 0) + eps) of `count` values with
// sum s and sum of squares ss (the clamp follows the plain version).
__device__ __forceinline__ float2 moments(float s, float ss, float count, float eps) {
  const float mu = s / count;
  const float var = fmaxf(ss / count - mu * mu, 0.f);
  return make_float2(mu, 1.f / sqrtf(var + eps));
}

// Allow clusters of up to 16 blocks (8 is the portable limit) and `smem`
// bytes of dynamic shared memory for `kernel`.
inline cudaError_t prepare_cluster_kernel(const void* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launch `kernel` on `blocks` blocks of `threads` in clusters of `cluster`
// along x, with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads, int cluster,
                            size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gn
