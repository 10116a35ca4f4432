// K3: GroupNorm apply (+SiLU) for Hopper (sm_90a).
//
// Replaces the normalise half of the TPU kernels in
// sid_lsg_tpu/ops/groupnorm.py: the apply step of _gn_silu_pallas_fwd and the
// apply pass of _gn_tiled_pallas_fwd.  One fused pass per element:
// (x - mean) * rstd * gamma + beta, then SiLU when asked.  It is evaluated as
// the reference _group_norm_ref folds it, x * scale_c + bias_c with
// scale_c = rstd * gamma and bias_c = beta - (mean * rstd) * gamma, so that
// kernel and plain version round alike.  It reads and writes the activation
// dtype (bf16 or f32) and computes in f32.
//
// What bounds it on the H100: one read and one write per element against a
// handful of f32 operations, so device-memory bytes bound it.  The design
// gives each block one (sample, channel) row of H*W contiguous elements, so
// the per-channel scale and bias are computed once per block and the loop is
// a plain 16-bytes-per-thread stream.

#include <stdint.h>

#include <algorithm>

#include "gn_common.cuh"

namespace {

constexpr int GA_THREADS = 256;

// grid (n * c, blocks per row).  Row nc holds the hw elements of channel
// c = nc % C of sample n = nc / C.
template <typename T>
__global__ void __launch_bounds__(GA_THREADS)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ gamma,
                const float* __restrict__ beta, int C, int cg, long long hw, int silu, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int nc = blockIdx.x;
  const int c = nc % C;
  const int g = (nc / C) * (C / cg) + c / cg;
  const float r = rstd[g];
  const float sc = r * gamma[c];
  const float bi = beta[c] - (mean[g] * r) * gamma[c];
  const T* xr = x + size_t(nc) * hw;
  T* yr = y + size_t(nc) * hw;
  if (vec) {  // hw % VEC == 0 and both pointers 16-byte aligned
    for (long long i = ((long long)blockIdx.y * GA_THREADS + threadIdx.x) * VEC; i < hw;
         i += (long long)gridDim.y * GA_THREADS * VEC)
      *reinterpret_cast<uint4*>(yr + i) =
          gn::apply16(*reinterpret_cast<const uint4*>(xr + i), sc, bi, silu, xr);
  } else {
    for (long long i = (long long)blockIdx.y * GA_THREADS + threadIdx.x; i < hw;
         i += (long long)gridDim.y * GA_THREADS)
      gn::store(yr + i, gn::act(gn::to_f32(xr[i]) * sc + bi, silu));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* mean, const float* rstd, const float* gamma,
                   const float* beta, int n, int c, int groups, long long hw, int silu,
                   cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec = (hw % VEC == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  // Four vectors per thread per row, at most 1024 blocks per row.
  const long long per_block = (long long)GA_THREADS * VEC * 4;
  const int bx = int(std::min((hw + per_block - 1) / per_block, 1024LL));
  gn_apply_kernel<T><<<dim3(n * c, bx), GA_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, gamma, beta, c, c / groups, hw,
      silu, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (n, c, hw) contiguous in the activation dtype.  mean, rstd: f32
// (n * groups,) from sidlsg_gn_stats_clustered.  gamma, beta: f32 (c,).  dtype: 0 = f32,
// 1 = bf16.  Returns a cudaError_t.
int sidlsg_gn_apply(const void* x, void* y, const void* mean, const void* rstd, const void* gamma,
                    const void* beta, int n, int c, int groups, long long hw, int silu, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || hw <= 0)
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0) return launch<float>(x, y, m, r, ga, be, n, c, groups, hw, silu, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, m, r, ga, be, n, c, groups, hw, silu, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
