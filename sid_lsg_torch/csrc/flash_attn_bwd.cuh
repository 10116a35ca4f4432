// What the flash-attention backward kernels share: K4 and K6
// (flash_attn_bwd.cu) and K5 (flash_attn_bwd_twopass.cu).
//
// Every kernel recomputes the probabilities from the forward's row
// logsumexp, P = exp(S * scale - lse), with S = Q K^T, and uses
// delta = rowsum(dO * O) (the pre-pass below):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
// Nothing of size S_q x S_k reaches device memory.  Here: the bf16
// packing (with the remainder of the dS split), the delta pre-pass, the
// shape and alignment check of the C entries, and K6 without its pre-pass,
// which the two-pass entry runs after K5 on one delta.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) less their bf16 pair `packed`, packed to bf16: what rounding left.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(lo - h.x, hi - h.y);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------- delta pre-pass

// delta[r] = sum_c dO[r, c] * O[r, c] in f32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
          long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, long long rows, int d,
                         cudaStream_t st) {
  const unsigned blocks = unsigned((rows + 7) / 8);
  bwd_delta<T><<<blocks, 256, 0, st>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                                       delta, rows, d);
  return cudaGetLastError();
}

inline cudaError_t run_delta(const void* out, const void* dout, float* delta, long long rows,
                             int d, int dtype, cudaStream_t st) {
  return dtype == 1 ? launch_delta<bf16>(out, dout, delta, rows, d, st)
                    : launch_delta<float>(out, dout, delta, rows, d, st);
}

// ------------------------------------------------------------- checks

constexpr int kMaxHeadDimBf16 = 160;
constexpr int kMaxHeadDimF32 = 512;

inline bool shape_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh > 0 && sq > 0 && sk > 0 && d > 0 &&
         ((dtype == 0 && d <= kMaxHeadDimF32) || (dtype == 1 && d <= kMaxHeadDimBf16));
}

// What the C entries require: shapes the kernels take, d a whole 16-byte
// row (the wrapper pads other head dims with zero columns), bh within the
// grid's y limit, and 16-byte aligned tensors.
inline bool inputs_ok(const void* q, const void* k, const void* v, const void* dout, const void* a,
                      const void* b, int bh, int sq, int sk, int d, int dtype) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return shape_ok(bh, sq, sk, d, dtype) && bh <= 65535 && d % (dtype == 1 ? 8 : 4) == 0 &&
         addr % 16 == 0;
}

}  // namespace

namespace sidlsg {

// K6 (dK and dV) on a delta already computed; inputs as inputs_ok takes
// them (flash_attn_bwd.cu).
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int sq,
                    int sk, int d, float scale, int dtype, cudaStream_t st);

}  // namespace sidlsg
