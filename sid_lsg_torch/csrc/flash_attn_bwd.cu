// K4: fused flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/attention.py:_flash_bwd_fused (its
// pl.pallas_call): from q, k, v, the forward's out and f32 row logsumexp,
// and dO, one sweep per (bh, k-tile) recomputes P and gives dK, dV and dQ.
// The delta = rowsum(dO * O) pre-pass, which the JAX package leaves to XLA,
// runs first in the same call.  The TPU kernel writes dQ as per-k-block f32
// partials summed outside; here each block adds its dS K into one zeroed
// f32 buffer with atomicAdd, cast to bf16 by a last small kernel.  The
// kernels, what bounds them and their design are in flash_attn_bwd.cuh.

#include "flash_attn_bwd.cuh"

namespace {

__global__ void cast_f32_bf16(const float* __restrict__ src, bf16* __restrict__ dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

}  // namespace

extern "C" {

// q, out, dout, dq: (bh, sq, d); k, v, dk, dv: (bh, sk, d), in the input
// dtype (0 = f32, 1 = bf16), contiguous.  lse: (bh, sq) f32 from the
// forward.  delta: (bh, sq) f32 scratch.  dq_acc: (bh, sq, d) f32 scratch,
// zeroed here; for f32 inputs it must be dq itself.  Returns a cudaError_t;
// cudaErrorInvalidValue for a shape or dtype the kernels do not take
// (d > 160 in bf16, d > 512 in f32).
int sidlsg_flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
                          void* dk, void* dv, int bh, int sq, int sk, int d, float scale,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(bh, sq, sk, d, dtype) || (dtype == 0 && dq_acc != dq)) return cudaErrorInvalidValue;
  const long long rows = (long long)bh * sq;
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * rows * d, st);
  if (err != cudaSuccess) return err;
  err = run_delta(out, dout, dl, rows, d, dtype, st);
  if (err != cudaSuccess) return err;
  err = run_kv<true>(q, k, v, dout, static_cast<const float*>(lse), dl, acc, dk, dv, bh, sq, sk,
                     d, scale, dtype, st);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return cudaSuccess;  // dq_acc is dq
  const long long n = rows * d;
  const unsigned blocks = unsigned((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  cast_f32_bf16<<<blocks, 256, 0, st>>>(acc, static_cast<bf16*>(dq), n);
  return cudaGetLastError();
}

}  // extern "C"
