// K7: fused bias + activation (+gain, +clamp) for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/bias_act.py:_bias_act_pallas_fwd
// (its pl.pallas_call): y = clamp(gain * act(x + b), -clamp, clamp) in one
// pass, for the nine activations of that module's table.  The TPU wrapper
// first transposes x so that the bias axis is last; here x stays in place,
// viewed as (outer, C, inner) around the bias axis, and element i takes the
// bias of channel (i / inner) % C.  It reads and writes f32 or bf16 and
// computes in f32; b = nullptr means no bias.  The gradient is the plain
// formula's VJP (ops/bias_act.py), as the JAX custom VJP has no backward
// kernel either.
//
// What bounds it on the H100: one read and one write per element against a
// few f32 operations, so device-memory bytes bound it; at the SiDA
// discriminator's (mb, 64) it is one launch's latency.  The design is a
// plain grid-stride loop with one template instance per activation, so the
// activation's branch is resolved at compile time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int BA_THREADS = 256;

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish, kNumActs };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) { *p = __float2bfloat16(y); }

// The activations as jax.numpy / jax.nn define them; comparisons are written
// so that a NaN input stays NaN, as jnp.maximum and jnp.where keep it.
template <int ACT>
__device__ __forceinline__ float activate(float v, float alpha) {
  if constexpr (ACT == kRelu) return v < 0.f ? 0.f : v;
  if constexpr (ACT == kLrelu) return v >= 0.f ? v : v * alpha;
  if constexpr (ACT == kTanh) return tanhf(v);
  if constexpr (ACT == kSigmoid) return 1.f / (1.f + expf(-v));
  if constexpr (ACT == kElu) return v > 0.f ? v : expm1f(v);
  if constexpr (ACT == kSelu)
    return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
  if constexpr (ACT == kSoftplus) return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  if constexpr (ACT == kSwish) return v / (1.f + expf(-v));
  return v;  // linear
}

template <int ACT, typename T>
__global__ void __launch_bounds__(BA_THREADS)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y, long long n,
                int c, long long inner, float alpha, float gain, float clamp) {
  for (long long i = (long long)blockIdx.x * BA_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * BA_THREADS) {
    float v = to_f32(x[i]);
    if (b != nullptr) v += to_f32(b[(i / inner) % c]);
    v = activate<ACT>(v, alpha) * gain;
    if (clamp >= 0.f) v = v < -clamp ? -clamp : (v > clamp ? clamp : v);
    store(y + i, v);
  }
}

template <int ACT, typename T>
cudaError_t launch(const void* x, const void* b, void* y, long long n, int c, long long inner,
                   float alpha, float gain, float clamp, cudaStream_t st) {
  const int blocks = int(std::min((n + BA_THREADS - 1) / BA_THREADS, 132LL * 32));
  bias_act_kernel<ACT, T><<<blocks, BA_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), n, c, inner, alpha,
      gain, clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* b, void* y, long long n, int c, long long inner,
                     int act, float alpha, float gain, float clamp, cudaStream_t st) {
  switch (act) {
    case kLinear: return launch<kLinear, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kRelu: return launch<kRelu, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kLrelu: return launch<kLrelu, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kTanh: return launch<kTanh, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kSigmoid: return launch<kSigmoid, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kElu: return launch<kElu, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kSelu: return launch<kSelu, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kSoftplus: return launch<kSoftplus, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
    case kSwish: return launch<kSwish, T>(x, b, y, n, c, inner, alpha, gain, clamp, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: n contiguous elements, viewed as (n / (c * inner), c, inner); b: (c,)
// in x's dtype, or null.  act: index in the table above (linear, relu, lrelu,
// tanh, sigmoid, elu, selu, softplus, swish).  clamp < 0: no clamp.  dtype:
// 0 = f32, 1 = bf16.  Returns a cudaError_t.
int sidlsg_bias_act(const void* x, const void* b, void* y, long long n, int c, long long inner,
                    int act, float alpha, float gain, float clamp, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || inner <= 0 || n % (c * inner) != 0 || act < 0 || act >= kNumActs)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(x, b, y, n, c, inner, act, alpha, gain, clamp, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, b, y, n, c, inner, act, alpha, gain, clamp, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
