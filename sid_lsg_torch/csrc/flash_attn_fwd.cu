// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/attention.py:_flash_fwd (the
// pl.pallas_call of its online-softmax loop).  Same function: non-causal
// softmax(q k^T * scale) v over (BH, S, D) tensors, plus the f32 row
// logsumexp, with the ragged tails of S_q and S_k masked in the kernel.
//
// What bounds it on the H100: at the UNet's self-attention (S = 4096/1024,
// D = 40/80) the two products are 4 S_q S_k D operations against
// (S_q + 2 S_k) D 2 bytes, far above the card's ~295 operations per byte, so
// the tensor cores bound it (989 TFLOP/s bf16); at D = 40 the exponentials
// of the softmax (S_q S_k of them against 4 S_q S_k D tensor-core
// operations) come close to it.  At cross-attention (S_k = 77) the bytes of
// q and out bound it.  The VAE's single head (D = 512) and the DINO ViT
// (D = 64) run in f32, which the tensor cores take only as TF32.
//
// What the design does about that:
// - bf16 (D <= 160, d % 8 == 0): one block per (bh, 64 NCW query rows)
//   of one producer warpgroup and NCW consumer warpgroups (NCW = 3 up to
//   D = 80, 2 at D = 160).  The producer gives up registers (setmaxnreg
//   24) and one of its threads issues TMA loads: the Q tile once, then K
//   and V tiles of 64 keys into a ring of three stages, each stage guarded
//   by a "full" mbarrier (TMA bytes) and an "empty" one (the consumer
//   warps).  Each consumer warpgroup (setmaxnreg 160 or 240) owns 64 query
//   rows: S = Q K^T is one wgmma chain (m64n64k16, Q and K from shared
//   memory), and the online softmax runs in registers on the accumulator,
//   on the raw logits (one FMA and one exp2 an element, the key mask only
//   on a ragged last tile); P, packed to bf16 in registers, is the A
//   operand of O += P V (m64nDk16), with V read from shared memory through
//   the descriptor's transpose bit.  Tiles use the 32-byte swizzled
//   column-block layout of hopper.cuh, so D = 40 and 80 pad only to 48 and
//   80 (TMA fills the columns past D and the rows past S with zeros; the
//   padded work counts in the time, never in the bound).  Why these tiles:
//   64 query rows is one wgmma M; each warpgroup's loop is a serial chain
//   of wgmma, exponentials (the multi-function unit, about as slow as the
//   tensor cores at D = 40) and wgmma, so a third warpgroup where the
//   registers allow it keeps more of that work in flight and reads K and V
//   once per 192 queries; 64 keys keep S at 32 registers a thread beside O
//   (up to 80 at D = 160) and P; three stages of K and V (at most 120 KB at
//   D = 160) plus Q fit the 227 KB of shared memory.
// - f32 (D <= 512, d % 4 == 0): tensor cores in 3xTF32 (each operand split
//   into hi = tf32(x) and lo = tf32(x - hi); hi*hi + hi*lo + lo*hi with f32
//   accumulation on mma.sync m16n8k8), which keeps f32 accuracy.  One block
//   of 8 warps per (bh, 32 query rows), looping over 32-key tiles: each warp
//   computes 16 rows x 32 keys of S over a quarter of D (each fragment it
//   loads and splits feeds several products), the quarters meet in shared
//   memory, the online softmax runs on 8 threads a row, P goes through
//   shared memory (32 x 32 f32), and each warp accumulates 32 rows x D/8
//   columns of O in registers (64 at D = 512).  Q, K and V tiles (194 KB of
//   the 217 KB at D = 512) arrive by 16-byte cp.async; the next K tile
//   streams in while P V runs.

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- bf16 path

constexpr int FB_BK = 64;  // keys a stage
constexpr int FB_STAGES = 3;

// NCW consumer warpgroups of 64 query rows each and one producer
// warpgroup.  Three consumers (192 rows) where their registers allow it
// (D <= 80: S 32, O up to 40 and P 16 registers a thread fit the 128 that
// ptxas allots each of 512 threads), two at D = 160 (O takes 80; 168 at 384
// threads): more warps in flight hide the latency of each warpgroup's chain
// of wgmma, exponentials and wgmma.
template <int DP>
struct FwdBf16 {
  static constexpr int NCW = DP <= 80 ? 3 : 2;
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NCW == 3 ? 160 : 240;
  static constexpr int BQ = 64 * NCW;                   // query rows a block
  static constexpr int NB = DP / 16;                    // column blocks
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = FB_BK * DP * 2;       // one of K, V
  static constexpr int TILES = Q_BYTES + FB_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + TILES + 8 * (1 + 2 * FB_STAGES);
};

template <int DP>
__global__ void __launch_bounds__(FwdBf16<DP>::THREADS, 1)
fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
               float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  using C = FwdBf16<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sQ = smem_u32(base);
  const uint32_t bars = sQ + C::TILES;
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return sQ + C::Q_BYTES + s * 2 * C::KV_BYTES; };
  auto sV = [&](int s) { return sK(s) + C::KV_BYTES; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + FB_STAGES + s); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const int nk = (sk + FB_BK - 1) / FB_BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * C::NCW);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NB; ++c) tma_load_3d(sQ + c * C::BQ * 32, &tq, q_full, c * 16, q0, bh);
      for (int it = 0; it < nk; ++it) {
        const int s = it % FB_STAGES;
        if (it >= FB_STAGES) mbar_wait(empty(s), ((it / FB_STAGES) - 1) & 1);
        mbar_arrive_tx(full(s), 2 * C::KV_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_3d(sK(s) + c * FB_BK * 32, &tk, full(s), c * 16, it * FB_BK, bh);
          tma_load_3d(sV(s) + c * FB_BK * 32, &tv, full(s), c * 16, it * FB_BK, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // rows g and g + 8 of this warp, raw logits
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int it = 0; it < nk; ++it) {
    const int s = it % FB_STAGES;
    mbar_wait(full(s), (it / FB_STAGES) & 1);
    float sc[FB_BK / 2];
#pragma unroll
    for (int i = 0; i < FB_BK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::NB; ++kk)
      WgmmaSS<FB_BK, 0, 0>::run(sc, desc_kmajor(sQ + kk * C::BQ * 32 + cw * 64 * 32),
                                desc_kmajor(sK(s) + kk * FB_BK * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // The softmax state is kept on the raw logits (m in units of q.k);
    // p = exp2(s * scale log2(e) - m * scale log2(e)) is one FMA and one
    // exp2.  Only the last tile of a ragged S_k needs the key mask.
    const int k0 = it * FB_BK;
    if (k0 + FB_BK > sk) {
#pragma unroll
      for (int j = 0; j < FB_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = k0 + j * 8 + 2 * t + e < sk;
          sc[4 * j + e] = ok ? sc[4 * j + e] : kNegInf;
          sc[4 * j + 2 + e] = ok ? sc[4 * j + 2 + e] : kNegInf;
        }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < FB_BK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * scale_log2), al_b = exp2f((m_b - mn_b) * scale_log2);
    m_a = mn_a;
    m_b = mn_b;
    const float ms_a = m_a * scale_log2, ms_b = m_b * scale_log2;
    uint32_t pa[FB_BK / 16][4];
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int j = 0; j < FB_BK / 8; ++j) {
      const float p0 = exp2f(fmaf(sc[4 * j], scale_log2, -ms_a));
      const float p1 = exp2f(fmaf(sc[4 * j + 1], scale_log2, -ms_a));
      const float p2 = exp2f(fmaf(sc[4 * j + 2], scale_log2, -ms_b));
      const float p3 = exp2f(fmaf(sc[4 * j + 3], scale_log2, -ms_b));
      ls_a += p0 + p1;
      ls_b += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * al_a + ls_a;
    l_b = l_b * al_b + ls_b;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FB_BK / 16; ++kk)
      WgmmaRS<DP, 1>::run(o, pa[kk], desc_mnmajor(sV(s) + kk * 16 * 32, FB_BK), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const int ra = q0 + cw * 64 + warp * 16 + g, rb = ra + 8;
  const float ia = 1.f / l_a, ib = 1.f / l_b;
  bf16* ob = out + size_t(bh) * sq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < d) {
      if (ra < sq)
        *reinterpret_cast<uint32_t*>(ob + size_t(ra) * d + col) = pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
      if (rb < sq)
        *reinterpret_cast<uint32_t*>(ob + size_t(rb) * d + col) =
            pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
    }
  }
  if (t == 0) {
    if (ra < sq) lse[size_t(bh) * sq + ra] = (m_a * scale_log2 + log2f(l_a)) * kLn2;
    if (rb < sq) lse[size_t(bh) * sq + rb] = (m_b * scale_log2 + log2f(l_b)) * kLn2;
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                        int sq, int sk, int d, float scale, cudaStream_t st) {
  using C = FwdBf16<DP>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map_bf16(&tq, q, bh, sq, d, C::BQ);
  if (err == cudaSuccess) err = tensor_map_bf16(&tk, k, bh, sk, d, FB_BK);
  if (err == cudaSuccess) err = tensor_map_bf16(&tv, v, bh, sk, d, FB_BK);
  // Once per instantiation: the register check and the shared-memory limit.
  static const cudaError_t prepared = [] {
    const cudaError_t e = check_ws_regs(reinterpret_cast<const void*>(fwd_bf16_wgmma<DP>), C::NCW,
                                        C::PRODUCER_REGS, C::CONSUMER_REGS);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(fwd_bf16_wgmma<DP>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::SMEM);
  }();
  if (err == cudaSuccess) err = prepared;
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  fwd_bf16_wgmma<DP><<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int FF_BQ = 32;
constexpr int FF_BK = 32;
constexpr int FF_THREADS = 256;

template <int DP>  // head dim padded to a multiple of 64
struct FwdF32 {
  static constexpr int LQ = DP + 4;  // Q, K row stride: (g, t) fragment loads hit distinct banks
  static constexpr int LV = DP + 8;  // V row stride: (t, g) fragment loads hit distinct banks
  static constexpr int LP = FF_BK + 4;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(FF_BQ) * LQ + size_t(FF_BK) * LQ + size_t(FF_BK) * LV +
                       size_t(5) * FF_BQ * LP + 2 * FF_BQ);
};

// S: warp w computes the 16 x 32 rows 16 (w & 1) of S over a quarter
// (w >> 1) of D, so that each A fragment it splits feeds four products; the
// quarters meet in shared memory.  The softmax then runs on 8 threads a row
// (4 keys each).  P V: warp w holds all 32 rows of O's columns w D / 8 ..
// in registers, so that each V fragment it splits feeds two products.
template <int DP>
__global__ void __launch_bounds__(FF_THREADS, 1)
fwd_f32_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
               int sq, int sk, int d, float scale_log2) {
  using C = FwdF32<DP>;
  constexpr int NTO = DP / 64;  // n8 tiles of O a warp, in each of its two 16-row halves
  constexpr int LP = C::LP;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + FF_BQ * C::LQ;
  float* Vs = Ks + FF_BK * C::LQ;
  float* Ps = Vs + FF_BK * C::LV;    // P, (queries, keys)
  float* RED = Ps + FF_BQ * LP;      // partial S over quarters of D, (4, queries, keys)
  float* ALPHA = RED + 4 * FF_BQ * LP;  // per row: the rescale of O for this tile
  float* LROW = ALPHA + FF_BQ;          // per row: the softmax denominator

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FF_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, kq = warp >> 1;
  const int r_a = mt * 16 + g, r_b = r_a + 8;
  const int oc0 = warp * (DP / 8);  // first O column of this warp (all 32 rows)
  const int srow = threadIdx.x >> 3, sc0 = (threadIdx.x & 7) * 4;  // softmax: row, first key
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;

  load_rows_f32<FF_BQ, DP>(Qs, C::LQ, q + size_t(bh) * sq * d, q0, sq, d);
  load_rows_f32<FF_BK, DP>(Ks, C::LQ, kb, 0, sk, d);
  cp_async_commit_group();
  load_rows_f32<FF_BK, DP>(Vs, C::LV, vb, 0, sk, d);
  cp_async_commit_group();

  float o[2][NTO][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTO; ++j) o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.f;
  float m_row = kNegInf, l_row = 0.f;  // softmax state of row srow (l: this thread's 4 keys)

  const int nk = (sk + FF_BK - 1) / FF_BK;
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * FF_BK;
    cp_async_wait_group<1>();  // K (and Q) landed; V may be in flight
    __syncthreads();
    {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < DP / 32; ++kk) {
        const int kc = kq * (DP / 4) + kk * 8 + t;
        const float* qa = Qs + r_a * C::LQ + kc;
        Tf32Frag a;
        load_frag(a, qa[0], qa[8 * C::LQ], qa[4], qa[8 * C::LQ + 4]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* kr = Ks + (n * 8 + g) * C::LQ + kc;
          mma_3xtf32(s[n], a, kr[0], kr[4]);
        }
      }
      float* part = RED + kq * FF_BQ * LP;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(part + r_a * LP + n * 8 + 2 * t) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(part + r_b * LP + n * 8 + 2 * t) = make_float2(s[n][2], s[n][3]);
      }
    }
    __syncthreads();  // K consumed, partial S posted
    if (it + 1 < nk) load_rows_f32<FF_BK, DP>(Ks, C::LQ, kb, k0 + FF_BK, sk, d);
    cp_async_commit_group();
    {
      float x[4];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) sum += RED[w * FF_BQ * LP + srow * LP + sc0 + e];
        x[e] = k0 + sc0 + e < sk ? sum * scale_log2 : kNegInf;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m_row, mx);
      const float al = exp2f(m_row - mn);
      m_row = mn;
      float4 p;
      p.x = exp2f(x[0] - mn);
      p.y = exp2f(x[1] - mn);
      p.z = exp2f(x[2] - mn);
      p.w = exp2f(x[3] - mn);
      l_row = l_row * al + (p.x + p.y) + (p.z + p.w);
      *reinterpret_cast<float4*>(Ps + srow * LP + sc0) = p;
      if ((threadIdx.x & 7) == 0) ALPHA[srow] = al;
    }
    cp_async_wait_group<1>();  // V landed; the next K may be in flight
    __syncthreads();     // P and the rescales complete
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float al_a = ALPHA[m * 16 + g], al_b = ALPHA[m * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        o[m][j][0] *= al_a;
        o[m][j][1] *= al_a;
        o[m][j][2] *= al_b;
        o[m][j][3] *= al_b;
      }
    }
#pragma unroll
    for (int kk = 0; kk < FF_BK / 8; ++kk) {
      Tf32Frag a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* pr = Ps + (m * 16 + g) * LP + kk * 8 + t;
        load_frag(a[m], pr[0], pr[8 * LP], pr[4], pr[8 * LP + 4]);
      }
      const float* vr = Vs + (kk * 8 + t) * C::LV + oc0 + g;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        uint32_t b[4];
        split_b(b, vr[j * 8], vr[4 * C::LV + j * 8]);
        mma_3xtf32(o[0][j], a[0], b);
        mma_3xtf32(o[1][j], a[1], b);
      }
    }
    __syncthreads();  // V, P and the rescales consumed
    if (it + 1 < nk) load_rows_f32<FF_BK, DP>(Vs, C::LV, vb, k0 + FF_BK, sk, d);
    cp_async_commit_group();
  }

  // Row sums over the row's 8 threads, to shared memory for the O warps.
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 4);
  if ((threadIdx.x & 7) == 0) LROW[srow] = l_row;
  __syncthreads();
  float* ob = out + size_t(bh) * sq * d;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int ra = q0 + m * 16 + g, rb = ra + 8;
    const float ia = 1.f / LROW[m * 16 + g], ib = 1.f / LROW[m * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      const int col = oc0 + j * 8 + 2 * t;
      if (col < d) {
        if (ra < sq)
          *reinterpret_cast<float2*>(ob + size_t(ra) * d + col) =
              make_float2(o[m][j][0] * ia, o[m][j][1] * ia);
        if (rb < sq)
          *reinterpret_cast<float2*>(ob + size_t(rb) * d + col) =
              make_float2(o[m][j][2] * ib, o[m][j][3] * ib);
      }
    }
  }
  if ((threadIdx.x & 7) == 0 && q0 + srow < sq)
    lse[size_t(bh) * sq + q0 + srow] = (m_row + log2f(l_row)) * kLn2;
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                       int sq, int sk, int d, float scale, cudaStream_t st) {
  const size_t smem = FwdF32<DP>::SMEM;
  static const cudaError_t prepared = cudaFuncSetAttribute(
      fwd_f32_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((sq + FF_BQ - 1) / FF_BQ, bh);
  fwd_f32_tf32x3<DP><<<grid, FF_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (bh, sq, d), k/v: (bh, sk, d), out: (bh, sq, d) in the input dtype, lse:
// (bh, sq) f32, all contiguous and 16-byte aligned.  dtype: 0 = f32, 1 =
// bf16.  Returns a cudaError_t; cudaErrorInvalidValue for what the kernels
// do not take: bf16 needs d % 8 == 0 and d <= 160, f32 d % 4 == 0 and
// d <= 512 (the wrapper pads other head dims with zero columns).  The bf16
// head dims are built for the presets' heads (16 and 32 tiny, 40/80/160
// SD1.5, 64 SD2.1-base); another d pads up to the next built one in shared
// memory, where TMA fills the columns past d with zeros.
int sidlsg_flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || bh > 65535) return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (addr % 16 != 0) return cudaErrorInvalidValue;
  float* lf = static_cast<float*>(lse);
  if (dtype == 1 && d % 8 == 0) {
#define SIDLSG_BF16_CASE(DP) \
  if (d <= DP) return launch_bf16<DP>(q, k, v, out, lf, bh, sq, sk, d, scale, st);
    SIDLSG_BF16_CASE(16)
    SIDLSG_BF16_CASE(32)
    SIDLSG_BF16_CASE(48)
    SIDLSG_BF16_CASE(64)
    SIDLSG_BF16_CASE(80)
    SIDLSG_BF16_CASE(160)
#undef SIDLSG_BF16_CASE
  }
  if (dtype == 0 && d % 4 == 0) {
    if (d <= 64) return launch_f32<64>(q, k, v, out, lf, bh, sq, sk, d, scale, st);
    if (d <= 192) return launch_f32<192>(q, k, v, out, lf, bh, sq, sk, d, scale, st);
    if (d <= 320) return launch_f32<320>(q, k, v, out, lf, bh, sq, sk, d, scale, st);
    if (d <= 512) return launch_f32<512>(q, k, v, out, lf, bh, sq, sk, d, scale, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a launch of sidlsg_flash_attn_fwd takes at this
// dtype and head dim (-1 where it does not launch).
int sidlsg_flash_attn_fwd_smem(int dtype, int d) {
  if (dtype == 1 && d % 8 == 0) {
    if (d <= 16) return FwdBf16<16>::SMEM;
    if (d <= 32) return FwdBf16<32>::SMEM;
    if (d <= 48) return FwdBf16<48>::SMEM;
    if (d <= 64) return FwdBf16<64>::SMEM;
    if (d <= 80) return FwdBf16<80>::SMEM;
    if (d <= 160) return FwdBf16<160>::SMEM;
  }
  if (dtype == 0 && d % 4 == 0) {
    if (d <= 64) return int(FwdF32<64>::SMEM);
    if (d <= 192) return int(FwdF32<192>::SMEM);
    if (d <= 320) return int(FwdF32<320>::SMEM);
    if (d <= 512) return int(FwdF32<512>::SMEM);
  }
  return -1;
}

}  // extern "C"
