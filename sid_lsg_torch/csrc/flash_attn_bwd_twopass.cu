// K5: dQ of the two-pass flash-attention backward for Hopper (sm_90a).
//
// Replaces the dQ kernel of the TPU's sid_lsg_tpu/ops/attention.py:_flash_bwd
// (the pl.pallas_call that loops k-blocks per q-block).  K5 keeps dQ in
// registers for one q-tile and writes it once, with no atomics or
// reduce-adds, and shares only the delta pre-pass with K4 and K6.  Its
// partner K6, the dK/dV kernel of the two-pass backward, is K4's sweep
// without dQ (flash_attn_bwd.cu).  The entry runs the delta =
// rowsum(dO * O) pre-pass first.  The kernel, what bounds it and its design
// are in flash_attn_bwd.cuh.

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

}  // extern "C"
