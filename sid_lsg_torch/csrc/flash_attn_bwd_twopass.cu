// K5 and K6: two-pass flash-attention backward for Hopper (sm_90a).
//
// Replace the two kernels of the TPU's sid_lsg_tpu/ops/attention.py:_flash_bwd
// (the dQ pl.pallas_call, which loops k-blocks per q-block, and the dK/dV
// one, which loops q-blocks per k-block).  K5 keeps dQ in registers for one
// q-tile and writes it once; K6 is K4's kv sweep without dQ.  Neither uses
// atomics, so the pair is deterministic: it is the check on K4.  Each entry
// runs the delta = rowsum(dO * O) pre-pass first.  The kernels, what bounds
// them and their design are in flash_attn_bwd.cuh.

#include "flash_attn_bwd.cuh"

extern "C" {

// Shapes and dtypes as sidlsg_flash_attn_bwd; delta: (bh, sq) f32 scratch.
int sidlsg_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, void* delta, void* dq, int bh,
                             int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(bh, sq, sk, d, dtype)) return cudaErrorInvalidValue;
  float* dl = static_cast<float*>(delta);
  const float* lf = static_cast<const float*>(lse);
  cudaError_t err = run_delta(out, dout, dl, (long long)bh * sq, d, dtype, st);
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    const int vec = vec_ok(d, q, k, v, dout);
#define SIDLSG_DQ_CASE(DP) \
  if (d <= DP) return launch_dq_bf16<DP>(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, vec, st);
    SIDLSG_DQ_CASE(16)
    SIDLSG_DQ_CASE(32)
    SIDLSG_DQ_CASE(48)
    SIDLSG_DQ_CASE(64)
    SIDLSG_DQ_CASE(80)
    SIDLSG_DQ_CASE(160)
#undef SIDLSG_DQ_CASE
    return cudaErrorInvalidValue;
  }
  if (d <= 32) return launch_dq_f32<TileF32, 8>(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, st);
  if (d <= 64) return launch_dq_f32<TileF32, 16>(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, st);
  if (d <= 160) return launch_dq_f32<TileF32, 40>(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, st);
  return launch_dq_f32<TileF16, 32>(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, st);
}

int sidlsg_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* dk, void* dv,
                              int bh, int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(bh, sq, sk, d, dtype)) return cudaErrorInvalidValue;
  float* dl = static_cast<float*>(delta);
  cudaError_t err = run_delta(out, dout, dl, (long long)bh * sq, d, dtype, st);
  if (err != cudaSuccess) return err;
  return run_kv<false>(q, k, v, dout, static_cast<const float*>(lse), dl, nullptr, dk, dv, bh, sq,
                       sk, d, scale, dtype, st);
}

}  // extern "C"
