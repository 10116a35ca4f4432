// K5: dQ of the two-pass flash-attention backward for Hopper (sm_90a), and
// the two-pass entry that runs the delta pre-pass once, then K5 and K6.
//
// Replaces the dQ kernel of the TPU's sid_lsg_tpu/ops/attention.py:_flash_bwd
// (the pl.pallas_call that loops key blocks per query block).  Same
// function: dQ = dS K of non-causal attention, with P recomputed from the
// forward's row logsumexp and dS = P (dP - delta) scale, dP = dO V^T; ragged
// S_q and S_k are masked in the kernel.  Each block keeps dQ for its query
// rows in registers over the whole key sweep and writes it once: no atomics
// and no reduce-adds, so K5 + K6 give the same bits on every run.  Its
// partner K6 (dK, dV) is K4's sweep without dQ (flash_attn_bwd.cu).
//
// What bounds it on the H100: S = Q K^T, dP = dO V^T and dQ += dS K are
// 6 S_q S_k D operations per (batch, head) against (4 S_q + 2 S_k) D bytes
// of the input dtype, far above the card's ~295 operations per byte at the
// UNet's self-attention, so the tensor cores bound it (989 TFLOP/s bf16);
// at cross-attention (S_k = 77: two key tiles, the second mostly masked)
// the bytes of Q, dO and dQ do.  The f32 heads (VAE D = 512, DINO D = 64)
// have only TF32 tensor cores.
//
// What the design does about that:
// - bf16 (D <= 160, d % 8 == 0): K1's structure (flash_attn_fwd.cu) with two
//   score products and dS K in place of P V.  One block per (bh, 64 NCW
//   query rows) of one producer warpgroup and NCW consumer warpgroups (NCW
//   = 3 up to D = 64, 2 at D = 80 and 160).  The producer gives up
//   registers (setmaxnreg 24) and one of its threads issues TMA loads: the
//   Q and dO tiles once, then K and V tiles of 64 keys into a ring of three
//   stages under "full" (TMA bytes) and "empty" (consumer warps) mbarriers.
//   Each consumer warpgroup owns 64 query rows, whose lse and delta it
//   holds in registers: S = Q K^T and dP = dO V^T are two wgmma chains
//   (m64n64k16, both operands in shared memory); P scale = exp2(S scale
//   log2(e) - lse log2(e) + log2(scale)) (one FMA and one ex2.approx an
//   element, the key mask only on a ragged last tile) and dS = P scale
//   (dP - delta) are formed on the accumulators and packed to bf16 in
//   registers as a high part and the remainder, the A operands of two
//   register-sourced wgmma (m64nDk16) into one dQ accumulator, with K read
//   from the same shared tile through the descriptor's transpose bit, as
//   K1 reads V.  dQ is written once per row as bf16.  The split matters: a row of few keys (77 at
//   cross-attention) carries the bf16 rounding of its largest dS elements
//   into dQ.  Tiles use the 32-byte swizzled column-block layout of
//   hopper.cuh, so D = 40 and 80 pad only to 48 and 80; TMA fills rows
//   past S and columns past D with zeros.  Why these tiles: S and dP are
//   live together (32 + 32 registers a thread at 64 keys) beside dQ (D / 2:
//   80 at D = 160), and ptxas allots 128 registers a thread at 512 threads,
//   168 at 384, whatever setmaxnreg asks; a third consumer warpgroup where
//   that fits keeps more wgmma, exponential and wgmma chains in flight and
//   reads K and V once per 192 queries (at D = 80 a third spills 252 bytes
//   and runs 1.7x slower).  Q and dO at 128 rows plus three K/V stages take
//   200 KB at D = 160.  The elementwise work between the two wgmma chains
//   competes with them in each warpgroup: the plain ex2.approx in place of
//   exp2f and the scale folded into P took 11-13% off the UNet's
//   self-attention shapes (H100, chip_smoke's inputs).
// - f32 (D <= 512, d % 4 == 0): tensor cores in 3xTF32 (each operand split
//   into hi = tf32(x) and lo = tf32(x - hi); hi*hi + hi*lo + lo*hi with f32
//   accumulation on mma.sync m16n8k8, hopper.cuh), which keeps f32
//   accuracy.  One block of 8 warps per (bh, 16 queries), looping over
//   32-key tiles: each warp computes dP = dO V^T and then S = Q K^T for all
//   16 x 32 of the tile over an eighth of D (each fragment it splits feeds
//   four products), the eighths meet in shared memory, P and dS are formed
//   on 256 threads, and each warp accumulates dQ for all 16 rows over D / 8
//   columns in registers (32 floats at D = 512).  V's product comes first,
//   so the next V tile streams in by cp.async while S, dS and dQ run, and
//   the next K tile while the next dP runs.  D = 512 is the hard case: Q,
//   dO, K and V at 32 rows would take 264 KB of the 227 KB; at 16 queries
//   against 32 keys they take 194 KB (214 KB with the partial sums), and
//   no product is recomputed: the narrower query tile costs only more
//   passes over K and V (from L2), not more operations.

#include "flash_attn_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// 2^x by the multi-function unit alone (ex2.approx.ftz: relative error
// about 2^-22; exp2f adds range handling around the same instruction).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- bf16 path

constexpr int DB_BK = 64;  // keys a stage
constexpr int DB_STAGES = 3;

template <int DP>
struct DqBf16 {
  static constexpr int NCW = DP <= 64 ? 3 : 2;
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NCW == 3 ? 160 : 240;
  static constexpr int BQ = 64 * NCW;              // query rows a block
  static constexpr int NB = DP / 16;               // column blocks
  static constexpr int Q_BYTES = BQ * DP * 2;      // one of Q, dO
  static constexpr int KV_BYTES = DB_BK * DP * 2;  // one of K, V
  static constexpr int TILES = 2 * Q_BYTES + DB_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + TILES + 8 * (1 + 2 * DB_STAGES);
};

template <int DP>
__global__ void __launch_bounds__(DqBf16<DP>::THREADS, 1)
bwd_dq_bf16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int sq, int sk, int d, float scale) {
  using C = DqBf16<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t sQ = smem_u32(base);
  const uint32_t sG = sQ + C::Q_BYTES;
  const uint32_t bars = sQ + C::TILES;
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return sQ + 2 * C::Q_BYTES + s * 2 * C::KV_BYTES; };
  auto sV = [&](int s) { return sK(s) + C::KV_BYTES; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + DB_STAGES + s); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const int nk = (sk + DB_BK - 1) / DB_BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DB_STAGES; ++s) {
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
      mbar_arrive_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        tma_load_3d(sQ + c * C::BQ * 32, &tq, q_full, c * 16, q0, bh);
        tma_load_3d(sG + c * C::BQ * 32, &tg, q_full, c * 16, q0, bh);
      }
      for (int it = 0; it < nk; ++it) {
        const int s = it % DB_STAGES;
        if (it >= DB_STAGES) mbar_wait(empty(s), ((it / DB_STAGES) - 1) & 1);
        mbar_arrive_tx(full(s), 2 * C::KV_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_3d(sK(s) + c * DB_BK * 32, &tk, full(s), c * 16, it * DB_BK, bh);
          tma_load_3d(sV(s) + c * DB_BK * 32, &tv, full(s), c * 16, it * DB_BK, bh);
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
  const float scale_log2 = scale * kLog2e;
  // Rows g and g + 8 of this warp, and the exponent offset of their P scale
  // = exp2(S scale log2(e) - (lse log2(e) - log2(scale))).  Rows past S_q
  // have zero Q and dO, so with lse = delta = 0 their dS is 0 (they are not
  // written).
  const int ra = q0 + cw * 64 + warp * 16 + g, rb = ra + 8;
  const float* lb = lse + size_t(bh) * sq;
  const float* eb = delta + size_t(bh) * sq;
  const float l2s = log2f(scale);
  const float ls_a = (ra < sq ? lb[ra] * kLog2e : 0.f) - l2s;
  const float ls_b = (rb < sq ? lb[rb] * kLog2e : 0.f) - l2s;
  const float de_a = ra < sq ? eb[ra] : 0.f, de_b = rb < sq ? eb[rb] : 0.f;
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < nk; ++it) {
    const int s = it % DB_STAGES;
    mbar_wait(full(s), (it / DB_STAGES) & 1);
    float sc[DB_BK / 2], dp[DB_BK / 2];
#pragma unroll
    for (int i = 0; i < DB_BK / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::NB; ++kk)
      WgmmaSS<DB_BK, 0, 0>::run(sc, desc_kmajor(sQ + kk * C::BQ * 32 + cw * 64 * 32),
                                desc_kmajor(sK(s) + kk * DB_BK * 32), 1);
#pragma unroll
    for (int kk = 0; kk < C::NB; ++kk)
      WgmmaSS<DB_BK, 0, 0>::run(dp, desc_kmajor(sG + kk * C::BQ * 32 + cw * 64 * 32),
                                desc_kmajor(sV(s) + kk * DB_BK * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // Element 4 j + e of the accumulators is row g (e < 2) or g + 8, key
    // k0 + 8 j + 2 t + (e & 1); packed in pairs it is the m16n8k16 A
    // fragment of k16 step j / 2.  Only the last tile of a ragged S_k needs
    // the key mask.
    const int k0 = it * DB_BK;
    const bool ragged = k0 + DB_BK > sk;
    uint32_t sa[DB_BK / 16][4], sr[DB_BK / 16][4];
#pragma unroll
    for (int j = 0; j < DB_BK / 8; ++j) {
      float p0 = ex2(fmaf(sc[4 * j], scale_log2, -ls_a));
      float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -ls_a));
      float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -ls_b));
      float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -ls_b));
      if (ragged) {
        const int key = k0 + j * 8 + 2 * t;
        if (key >= sk) p0 = p2 = 0.f;
        if (key + 1 >= sk) p1 = p3 = 0.f;
      }
      const float d0 = p0 * (dp[4 * j] - de_a);
      const float d1 = p1 * (dp[4 * j + 1] - de_a);
      const float d2 = p2 * (dp[4 * j + 2] - de_b);
      const float d3 = p3 * (dp[4 * j + 3] - de_b);
      const uint32_t s01 = pack_bf16(d0, d1), s23 = pack_bf16(d2, d3);
      sa[j / 2][(j % 2) * 2] = s01;
      sa[j / 2][(j % 2) * 2 + 1] = s23;
      sr[j / 2][(j % 2) * 2] = pack_bf16_rest(d0, d1, s01);
      sr[j / 2][(j % 2) * 2 + 1] = pack_bf16_rest(d2, d3, s23);
    }
    // dQ += dS K: the remainder, then the high part, of each k16 step; K
    // (keys x D) is the MN-major B operand.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DB_BK / 16; ++kk) {
      const uint64_t kd = desc_mnmajor(sK(s) + kk * 16 * 32, DB_BK);
      WgmmaRS<DP, 1>::run(dqa, sr[kk], kd, 1);
      WgmmaRS<DP, 1>::run(dqa, sa[kk], kd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // K and V of this stage consumed
  }

  bf16* qb = dq + size_t(bh) * sq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < d) {
      if (ra < sq)
        *reinterpret_cast<uint32_t*>(qb + size_t(ra) * d + col) = pack_bf16(dqa[4 * j], dqa[4 * j + 1]);
      if (rb < sq)
        *reinterpret_cast<uint32_t*>(qb + size_t(rb) * d + col) =
            pack_bf16(dqa[4 * j + 2], dqa[4 * j + 3]);
    }
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                           int d, float scale, cudaStream_t st) {
  using C = DqBf16<DP>;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = tensor_map_bf16(&tq, q, bh, sq, d, C::BQ);
  if (err == cudaSuccess) err = tensor_map_bf16(&tg, dout, bh, sq, d, C::BQ);
  if (err == cudaSuccess) err = tensor_map_bf16(&tk, k, bh, sk, d, DB_BK);
  if (err == cudaSuccess) err = tensor_map_bf16(&tv, v, bh, sk, d, DB_BK);
  // Once per instantiation: the register check and the shared-memory limit.
  static const cudaError_t prepared = [] {
    const cudaError_t e = check_ws_regs(reinterpret_cast<const void*>(bwd_dq_bf16_wgmma<DP>),
                                        C::NCW, C::PRODUCER_REGS, C::CONSUMER_REGS);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(bwd_dq_bf16_wgmma<DP>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::SMEM);
  }();
  if (err == cudaSuccess) err = prepared;
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
  bwd_dq_bf16_wgmma<DP><<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dq), sq, sk, d, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int DF_BQ = 16;  // queries a block
constexpr int DF_BK = 32;  // keys a tile
constexpr int DF_THREADS = 256;

template <int DP>  // head dim padded to a multiple of 64
struct DqF32 {
  static constexpr int LD = DP + 4;    // Q, dO, K, V row stride: (g, t) fragment loads hit distinct banks
  static constexpr int LT = DF_BK + 4;  // row stride of the partial sums and of dS
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(2) * DF_BQ * LD + size_t(2) * DF_BK * LD + size_t(9) * DF_BQ * LT +
                       2 * DF_BQ);
};

// RED[warp] = A B^T (16 x 32) over this warp's eighth of D, A (16 rows) and
// B (32 rows) from shared memory with row stride LD.
template <int DP>
__device__ __forceinline__ void partial_scores(float* red, const float* A, const float* B, int warp,
                                               int g, int t) {
  constexpr int LD = DqF32<DP>::LD, LT = DqF32<DP>::LT;
  float acc[DF_BK / 8][4];
#pragma unroll
  for (int n = 0; n < DF_BK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 64; ++kk) {
    const int kc = warp * (DP / 8) + kk * 8 + t;
    const float* ar = A + g * LD + kc;
    Tf32Frag a;
    load_frag(a, ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]);
#pragma unroll
    for (int n = 0; n < DF_BK / 8; ++n) {
      const float* br = B + (n * 8 + g) * LD + kc;
      mma_3xtf32(acc[n], a, br[0], br[4]);
    }
  }
  float* out = red + warp * DF_BQ * LT;
#pragma unroll
  for (int n = 0; n < DF_BK / 8; ++n) {
    *reinterpret_cast<float2*>(out + g * LT + n * 8 + 2 * t) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (g + 8) * LT + n * 8 + 2 * t) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(DF_THREADS, 1)
bwd_dq_f32_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int sq, int sk, int d, float scale) {
  using C = DqF32<DP>;
  constexpr int LD = C::LD, LT = C::LT;
  constexpr int NT = DP / 64;                // n8 tiles of dQ a warp
  constexpr int PER = DF_BQ * DF_BK / DF_THREADS;  // (query, key) elements a thread
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Gs = Qs + DF_BQ * LD;
  float* Ks = Gs + DF_BQ * LD;
  float* Vs = Ks + DF_BK * LD;
  float* RED = Vs + DF_BK * LD;    // partial dP or S over eighths of D, (8, queries, keys)
  float* DS = RED + 8 * DF_BQ * LT;  // dS, (queries, keys)
  float* Ls = DS + DF_BQ * LT;     // per row: lse log2(e)
  float* Es = Ls + DF_BQ;          // per row: delta

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DF_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;

  load_rows_f32<DF_BQ, DP>(Qs, LD, q + size_t(bh) * sq * d, q0, sq, d);
  load_rows_f32<DF_BQ, DP>(Gs, LD, dout + size_t(bh) * sq * d, q0, sq, d);
  load_rows_f32<DF_BK, DP>(Vs, LD, vb, 0, sk, d);
  cp_async_commit_group();
  load_rows_f32<DF_BK, DP>(Ks, LD, kb, 0, sk, d);
  cp_async_commit_group();
  // Rows past S_q have zero Q and dO, so with lse = delta = 0 their dS is 0.
  if (threadIdx.x < DF_BQ) {
    const int row = q0 + threadIdx.x;
    Ls[threadIdx.x] = row < sq ? lse[size_t(bh) * sq + row] * kLog2e : 0.f;
    Es[threadIdx.x] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
  }

  // dQ: warp w holds all 16 rows at columns w DP / 8 ..
  const int c0 = warp * (DP / 8);
  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  const int nk = (sk + DF_BK - 1) / DF_BK;
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * DF_BK;
    cp_async_wait_group<1>();  // V (and Q, dO) landed; K may be in flight
    __syncthreads();
    partial_scores<DP>(RED, Gs, Vs, warp, g, t);
    __syncthreads();  // V consumed, partial dP posted
    if (it + 1 < nk) load_rows_f32<DF_BK, DP>(Vs, LD, vb, k0 + DF_BK, sk, d);
    cp_async_commit_group();
    float dpv[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * DF_THREADS, r = i / DF_BK, c = i % DF_BK;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += RED[w * DF_BQ * LT + r * LT + c];
      dpv[e] = sum;
    }
    cp_async_wait_group<1>();  // K landed; the next V may be in flight
    __syncthreads();           // and every thread's dP sums are read
    partial_scores<DP>(RED, Qs, Ks, warp, g, t);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * DF_THREADS, r = i / DF_BK, c = i % DF_BK;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += RED[w * DF_BQ * LT + r * LT + c];
      const float p = k0 + c < sk ? exp2f(sum * scale_log2 - Ls[r]) : 0.f;
      DS[r * LT + c] = p * (dpv[e] - Es[r]) * scale;
    }
    __syncthreads();
    // dQ += dS K over the tile's 32 keys (four k8 steps).
#pragma unroll
    for (int kk = 0; kk < DF_BK / 8; ++kk) {
      const float* sr = DS + g * LT + kk * 8 + t;
      Tf32Frag a;
      load_frag(a, sr[0], sr[8 * LT], sr[4], sr[8 * LT + 4]);
      const float* kr = Ks + (kk * 8 + t) * LD + c0 + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_3xtf32(dqa[j], a, kr[j * 8], kr[4 * LD + j * 8]);
    }
    __syncthreads();  // K and dS consumed
    if (it + 1 < nk) load_rows_f32<DF_BK, DP>(Ks, LD, kb, k0 + DF_BK, sk, d);
    cp_async_commit_group();
  }

  float* qb = dq + size_t(bh) * sq * d;
  const int ra = q0 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col < d) {
      if (ra < sq)
        *reinterpret_cast<float2*>(qb + size_t(ra) * d + col) = make_float2(dqa[j][0], dqa[j][1]);
      if (rb < sq)
        *reinterpret_cast<float2*>(qb + size_t(rb) * d + col) = make_float2(dqa[j][2], dqa[j][3]);
    }
  }
}

template <int DP>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                          int d, float scale, cudaStream_t st) {
  const size_t smem = DqF32<DP>::SMEM;
  static const cudaError_t prepared = cudaFuncSetAttribute(
      bwd_dq_f32_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((sq + DF_BQ - 1) / DF_BQ, bh);
  bwd_dq_f32_tf32x3<DP><<<grid, DF_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), sq, sk, d, scale);
  return cudaGetLastError();
}

// K5 on a delta already computed; inputs as inputs_ok takes them.
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int bh, int sq, int sk, int d,
                   float scale, int dtype, cudaStream_t st) {
  if (dtype == 1) {
#define SIDLSG_DQ_BF16(DP) \
  if (d <= DP) return launch_dq_bf16<DP>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, st);
    SIDLSG_DQ_BF16(16)
    SIDLSG_DQ_BF16(32)
    SIDLSG_DQ_BF16(48)
    SIDLSG_DQ_BF16(64)
    SIDLSG_DQ_BF16(80)
    SIDLSG_DQ_BF16(160)
#undef SIDLSG_DQ_BF16
    return cudaErrorInvalidValue;
  }
#define SIDLSG_DQ_F32(DP) \
  if (d <= DP) return launch_dq_f32<DP>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, st);
  SIDLSG_DQ_F32(64)
  SIDLSG_DQ_F32(192)
  SIDLSG_DQ_F32(320)
  SIDLSG_DQ_F32(512)
#undef SIDLSG_DQ_F32
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K5 alone: dq (bh, sq, d) in the input dtype; the other shapes, dtypes and
// alignment as sidlsg_flash_attn_bwd (flash_attn_bwd.cu); delta: (bh, sq)
// f32 scratch.  Runs the delta pre-pass, then K5.
int sidlsg_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, void* delta, void* dq, int bh,
                             int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!inputs_ok(q, k, v, dout, dq, dq, bh, sq, sk, d, dtype)) return cudaErrorInvalidValue;
  float* dl = static_cast<float*>(delta);
  cudaError_t err = run_delta(out, dout, dl, (long long)bh * sq, d, dtype, st);
  if (err != cudaSuccess) return err;
  return bwd_dq(q, k, v, dout, static_cast<const float*>(lse), dl, dq, bh, sq, sk, d, scale, dtype,
                st);
}

// The two-pass backward: the delta pre-pass once, then K5 (dq) and K6 (dk,
// dv) on that delta; three launches, no atomics or reduce-adds.  Shapes,
// dtypes and alignment as sidlsg_flash_attn_bwd; delta: (bh, sq) f32
// scratch.
int sidlsg_flash_attn_bwd_twopass(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int sq, int sk, int d, float scale,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!inputs_ok(q, k, v, dout, dk, dv, bh, sq, sk, d, dtype) ||
      reinterpret_cast<uintptr_t>(dq) % 16 != 0)
    return cudaErrorInvalidValue;
  float* dl = static_cast<float*>(delta);
  const float* lf = static_cast<const float*>(lse);
  cudaError_t err = run_delta(out, dout, dl, (long long)bh * sq, d, dtype, st);
  if (err == cudaSuccess) err = bwd_dq(q, k, v, dout, lf, dl, dq, bh, sq, sk, d, scale, dtype, st);
  if (err == cudaSuccess)
    err = sidlsg::bwd_dkv(q, k, v, dout, lf, dl, dk, dv, bh, sq, sk, d, scale, dtype, st);
  return err;
}

// Dynamic shared memory a launch of K5 takes at this dtype and head dim (-1
// where it does not launch).
int sidlsg_flash_attn_bwd_dq_smem(int dtype, int d) {
  if (dtype == 1 && d % 8 == 0) {
    if (d <= 16) return DqBf16<16>::SMEM;
    if (d <= 32) return DqBf16<32>::SMEM;
    if (d <= 48) return DqBf16<48>::SMEM;
    if (d <= 64) return DqBf16<64>::SMEM;
    if (d <= 80) return DqBf16<80>::SMEM;
    if (d <= 160) return DqBf16<160>::SMEM;
  }
  if (dtype == 0 && d % 4 == 0) {
    if (d <= 64) return int(DqF32<64>::SMEM);
    if (d <= 192) return int(DqF32<192>::SMEM);
    if (d <= 320) return int(DqF32<320>::SMEM);
    if (d <= 512) return int(DqF32<512>::SMEM);
  }
  return -1;
}

}  // extern "C"
