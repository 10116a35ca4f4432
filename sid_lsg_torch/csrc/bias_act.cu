// K7: fused bias + activation (+gain, +clamp) for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/bias_act.py:_bias_act_pallas_fwd
// (its pl.pallas_call): y = clamp(gain * act(x + b), -clamp, clamp) in one
// pass, for the nine activations of that module's table.  The TPU wrapper
// first transposes x so that the bias axis is last; here x stays in place,
// viewed as (outer, C, inner) around the bias axis.  It reads and writes f32
// or bf16 and computes in f32; b = nullptr means no bias.  The gradient is
// the plain formula's VJP (ops/bias_act.py), as the JAX custom VJP has no
// backward kernel either.
//
// What bounds it on the H100: one read and one write per element against a
// few f32 operations, so device-memory bytes bound it; at the SiDA
// discriminator's (mb, 64) it is one launch's latency.
//
// Design: x is a (rows, cols) matrix in one of two routes, chosen from the
// shape, so that no element divides to find its bias.
// - inner == 1 (bias on the last axis, the SiDA path): rows = outer, cols =
//   C, and the bias follows the column.
// - inner > 1 (NCHW with the bias on dim 1): rows = outer * C, cols = inner,
//   and a row has one bias value, read once.
// A row is split among a power-of-two group of threads (tpr, up to the
// block), so short rows fill the block with several rows; each thread moves
// 16-byte vectors (4 f32 or 8 bf16), up to four in flight, and the elements
// before the row's first 16-byte boundary and after its last vector go one
// by one.  The wrapper gives y the same offset from a 16-byte boundary as x,
// so one split serves both.  Offsets inside a row are 32-bit (cols < 2^31);
// a row's start is 64-bit.  The grid covers the row groups and the 16 KB
// chunks of long rows, up to eight blocks of 256 threads per SM (the SMs'
// full occupancy), with grid-stride loops beyond.  One template instance
// per activation and route resolves the activation's branch at compile time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BA_THREADS = 256;
constexpr int BA_UNROLL = 4;         // vectors in flight a thread
constexpr int BA_BLOCKS_PER_SM = 8;  // 2048 threads an SM

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish, kNumActs };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float y) { *p = y; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float y) { *p = __float2bfloat16(y); }

// 16 bytes of T as floats, and back.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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

template <int ACT>
__device__ __forceinline__ float finish(float v, float alpha, float gain, float clamp) {
  v = activate<ACT>(v, alpha) * gain;
  return clamp >= 0.f ? (v < -clamp ? -clamp : (v > clamp ? clamp : v)) : v;
}

// PER_ROW: the bias of row r is b[r % c] (inner > 1); else the bias of
// column e is b[e] (inner == 1).  Thread group of tpr = 1 << tpr_log2
// threads per row; chunk ch of a row covers its vectors
// [ch * tpr * BA_UNROLL, (ch + 1) * tpr * BA_UNROLL).
template <int ACT, typename T, bool PER_ROW>
__global__ void __launch_bounds__(BA_THREADS)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y, int rows,
                int cols, int c, int tpr_log2, int chunks, float alpha, float gain, float clamp) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int rpb = BA_THREADS >> tpr_log2;
  const int row_groups = (rows + rpb - 1) / rpb;
  for (int rg = blockIdx.x; rg < row_groups; rg += gridDim.x) {
    const int row = rg * rpb + (threadIdx.x >> tpr_log2);
    if (row >= rows) break;
    const size_t base = size_t(row) * cols;
    const T* xr = x + base;
    T* yr = y + base;
    const int head =
        min(cols, int(((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / sizeof(T)));
    const int nvec = (cols - head) / N;
    const int tail = head + nvec * N;
    const float brow = (PER_ROW && b != nullptr) ? to_f32(b[row % c]) : 0.f;
    // Column bias as 16-byte vectors where b + head is aligned as xr + head is.
    const bool bvec =
        !PER_ROW && b != nullptr && (reinterpret_cast<uintptr_t>(b + head) & 15u) == 0;
    auto bias_at = [&](int e) { return PER_ROW ? brow : (b != nullptr ? to_f32(b[e]) : 0.f); };
    for (int ch = blockIdx.y; ch < chunks; ch += gridDim.y) {
      if (ch == 0)
        for (int e = lane; e < head; e += tpr)
          store(yr + e, finish<ACT>(to_f32(xr[e]) + bias_at(e), alpha, gain, clamp));
      if (ch == chunks - 1)
        for (int e = tail + lane; e < cols; e += tpr)
          store(yr + e, finish<ACT>(to_f32(xr[e]) + bias_at(e), alpha, gain, clamp));
      const int j0 = ch * tpr * BA_UNROLL + lane;
      float v[BA_UNROLL][N];
#pragma unroll
      for (int u = 0; u < BA_UNROLL; ++u)
        if (j0 + u * tpr < nvec) V::load(xr + head + (j0 + u * tpr) * N, v[u]);
#pragma unroll
      for (int u = 0; u < BA_UNROLL; ++u) {
        const int j = j0 + u * tpr;
        if (j < nvec) {
          const int e0 = head + j * N;
          float bv[N];
          if (PER_ROW || b == nullptr) {
#pragma unroll
            for (int i = 0; i < N; ++i) bv[i] = brow;
          } else if (bvec) {
            V::load(b + e0, bv);
          } else {
#pragma unroll
            for (int i = 0; i < N; ++i) bv[i] = to_f32(b[e0 + i]);
          }
#pragma unroll
          for (int i = 0; i < N; ++i) v[u][i] = finish<ACT>(v[u][i] + bv[i], alpha, gain, clamp);
          V::store(yr + e0, v[u]);
        }
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

template <int ACT, typename T>
cudaError_t launch(const void* x, const void* b, void* y, long long rows, long long cols, int c,
                   bool per_row, float alpha, float gain, float clamp, cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const long long vecs = (cols + N - 1) / N;
  int tpr_log2 = 0;
  while ((1LL << tpr_log2) < vecs && (1 << tpr_log2) < BA_THREADS) ++tpr_log2;
  const long long rpb = BA_THREADS >> tpr_log2;
  const long long chunks = std::max(1LL, (vecs + (BA_UNROLL << tpr_log2) - 1) / (BA_UNROLL << tpr_log2));
  const long long target = (long long)sm_count() * BA_BLOCKS_PER_SM;
  const long long gy = std::min(chunks, 65535LL);
  const long long gx = std::min((rows + rpb - 1) / rpb, std::max(1LL, target / gy));
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (per_row)
    bias_act_kernel<ACT, T, true><<<grid, BA_THREADS, 0, st>>>(
        xp, bp, yp, int(rows), int(cols), c, tpr_log2, int(chunks), alpha, gain, clamp);
  else
    bias_act_kernel<ACT, T, false><<<grid, BA_THREADS, 0, st>>>(
        xp, bp, yp, int(rows), int(cols), c, tpr_log2, int(chunks), alpha, gain, clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* b, void* y, long long rows, long long cols, int c,
                     bool per_row, int act, float alpha, float gain, float clamp, cudaStream_t st) {
#define SIDLSG_BA_CASE(A) \
  case A: return launch<A, T>(x, b, y, rows, cols, c, per_row, alpha, gain, clamp, st);
  switch (act) {
    SIDLSG_BA_CASE(kLinear)
    SIDLSG_BA_CASE(kRelu)
    SIDLSG_BA_CASE(kLrelu)
    SIDLSG_BA_CASE(kTanh)
    SIDLSG_BA_CASE(kSigmoid)
    SIDLSG_BA_CASE(kElu)
    SIDLSG_BA_CASE(kSelu)
    SIDLSG_BA_CASE(kSoftplus)
    SIDLSG_BA_CASE(kSwish)
  }
#undef SIDLSG_BA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: n contiguous elements, viewed as (n / (c * inner), c, inner), with
// the same offset from a 16-byte boundary; b: (c,) in x's dtype, or null.
// act: index in the table above (linear, relu, lrelu, tanh, sigmoid, elu,
// selu, softplus, swish).  clamp < 0: no clamp.  dtype: 0 = f32, 1 = bf16.
// Returns a cudaError_t; cudaErrorInvalidValue for what it does not take,
// among them a row (C when inner == 1, else inner) or a row count of 2^31
// elements or more.
int sidlsg_bias_act(const void* x, const void* b, void* y, long long n, int c, long long inner,
                    int act, float alpha, float gain, float clamp, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || inner <= 0 || n % (c * inner) != 0 || act < 0 || act >= kNumActs ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if ((reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(y)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % es != 0)
    return cudaErrorInvalidValue;
  const bool per_row = inner > 1;
  const long long cols = per_row ? inner : c;
  const long long rows = n / cols;
  if (cols >= (1LL << 31) || rows >= (1LL << 31)) return cudaErrorInvalidValue;
  return dtype == 0 ? dispatch<float>(x, b, y, rows, cols, c, per_row, act, alpha, gain, clamp, st)
                    : dispatch<__nv_bfloat16>(x, b, y, rows, cols, c, per_row, act, alpha, gain,
                                              clamp, st);
}

}  // extern "C"
