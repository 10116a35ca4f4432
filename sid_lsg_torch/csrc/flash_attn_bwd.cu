// K4: fused flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/attention.py:_flash_bwd_fused (its
// pl.pallas_call): from q, k, v, the forward's out and f32 row logsumexp,
// and dO, one sweep per (bh, key tile) recomputes P = exp(S scale - lse)
// and gives dV = P^T dO, dK = dS^T Q and dQ = dS K, with
// dS = P (dP - delta) scale, dP = dO V^T.  The delta = rowsum(dO * O)
// pre-pass, which the JAX package leaves to XLA, runs first in the same
// call (flash_attn_bwd.cuh).  The TPU kernel writes dQ as per-key-block f32
// partials summed outside (64 x the size of dQ at 4096 tokens); here each
// block adds its dS K into one zeroed f32 buffer by bulk reduce-add, cast to
// the input dtype by a last small kernel.
//
// K6, the dK/dV kernel of the two-pass backward, replaces the dK/dV
// pl.pallas_call of sid_lsg_tpu/ops/attention.py:_flash_bwd: it is this
// sweep compiled without its dQ section (template flag DQ = false, kernels
// bwd_dkv_bf16_wgmma and bwd_dkv_f32_tf32x3), so it has
// no dS^T buffers, staging chunks or reduce-adds, and each block writes its
// key tile's dK and dV once: with K5 (flash_attn_bwd_twopass.cu) it gives
// the same gradients bit for bit on every run.  Its four products are
// 8 S_q S_k D operations per (batch, head), against K4's 10 (both run dK's
// split dS twice, K4 dQ's too).
//
// What bounds it on the H100: the five products are 10 S_q S_k D operations
// per (batch, head) against (4 S_q + 4 S_k) D 2 bytes, far above the card's
// ~295 operations per byte at the UNet's self-attention, so the tensor
// cores bound it; at cross-attention (S_k = 77) the bytes of Q, dO and dQ
// do, and a grid of one key tile per head leaves most SMs idle.  The f32
// heads (VAE D = 512, DINO D = 64) have only TF32 tensor cores.
//
// Design:
// - bf16 (D <= 160, d % 8 == 0): one block of three warpgroups per (bh,
//   128 keys), K and V resident in shared memory.  Warpgroup 0 is the
//   producer (setmaxnreg 24): one thread TMA-loads K and V once, then Q and
//   dO tiles of 64 queries into a two-stage ring (one stage at D = 160),
//   while the warpgroup's 128 threads copy the tile's lse and delta beside
//   them; each stage has a "full" mbarrier (128 arrivals plus the TMA
//   bytes) and an "empty" one (the eight consumer warps).  Warpgroups 1
//   and 2 (setmaxnreg 240) each own 64 keys: S^T = K Q^T and dP^T = V dO^T
//   are wgmma chains (m64n64k16) from shared memory; P^T and dS^T are
//   formed in registers and, packed to bf16, are the register A operands
//   of dV += P^T dO and dK += dS^T Q
//   (m64nDk16, dO and Q read through the transpose bit), so dK and dV stay
//   in registers for the whole sweep.  dS^T also goes to shared memory
//   (32-byte swizzle, two 16 KB buffers), from which dQ_tile = dS K over the
//   block's 128 keys runs on wgmma with both operands transposed, by one
//   warpgroup on alternate query tiles: the other goes on to the next tile,
//   so the two warpgroups meet once a tile (dS^T complete) and their
//   softmax and tensor-core phases interleave.  The dQ tile leaves through
//   an f32 staging chunk and one TMA bulk reduce-add
//   (cp.reduce.async.bulk.tensor .add) per (key tile, query tile) and
//   column chunk into the f32 dQ buffer: no per-element atomics.
//   dQ sums only 128 keys a block (77 in all at cross-attention), so a
//   large dS element rounded to bf16 shows in it.  dS^T is therefore
//   stored as a bf16 high part and a bf16 remainder (dS - high), two more
//   16 KB buffers, and dQ_tile takes both products, as if dS had 16 bits
//   of mantissa.  dK, a sum over up to 4096 queries with cancellation,
//   shows the same rounding: it takes both parts too, from registers.
//   (The TPU kernel rounds ds to the input dtype before its dQ and dK
//   dots; K5 does the same split for dQ, in registers.)
//   Why these tiles: 64 queries a stage keep S^T and dP^T at 32 registers
//   each, beside dK and dV (80 + 80 at D = 160, where dQ then runs in five
//   chunks of 32 columns so that it fits too); 128 keys a block halve the
//   passes over Q and dO, and the dQ reduce-adds, against 64; at D = 160 K,
//   V, the Q and dO tiles, four dS^T buffers and two staging chunks take
//   202 KB of the 227 KB, with one stage of Q and dO where smaller head
//   dims have two (K6, without dS^T and staging, has two at every D).  ptxas allots 168 registers a thread at 384
//   threads whatever setmaxnreg asks, so at D = 64 and 160 the consumers
//   spill a few hundred bytes.  The tiles use the column-block layout of
//   hopper.cuh; TMA zero-fills rows past S and columns past D, so rows past
//   S_q carry P = 0 (their lse is read as +inf) and keys past S_k have zero
//   K and V, which add nothing to dQ.
// - f32 (D <= 512, d % 4 == 0): tensor cores in 3xTF32 on mma.sync m16n8k8
//   (hopper.cuh), which keeps f32 accuracy.  One block of 8 warps per (bh,
//   32 keys), looping over 16-query tiles: four warps compute S^T and four
//   dP^T, each warp all of its product's 32 x 16 tile over a quarter of D
//   (so every fragment it loads and splits feeds two products), and the
//   quarters meet in shared memory with P^T and dS^T; each warp then
//   accumulates 32 keys x D/8 columns of dK and dV in registers (128
//   floats at D = 512) and a share of dQ_tile = dS K, which is staged in
//   shared memory in column chunks of at most 256 and added into dQ by one
//   TMA bulk reduce-add per (key tile, query tile, chunk), while the next Q
//   and dO tiles stream in.  D = 512 is the hard case: four 32-row f32
//   tiles of Q, dO, K and V would take 264 KB; with 16-query tiles Q and dO
//   take 66 KB and K and V 132 KB (219 KB in all with the partial sums),
//   and no product is recomputed: the narrower query tile costs only more
//   passes of the loop (and more reduce-adds of dQ), not more operations.

#include "flash_attn_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFarLse = 1e30f;  // lse of rows past S_q: their P is exp(-inf) = 0

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) less their bf16 pair `packed`, packed to bf16: what rounding left.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(lo - h.x, hi - h.y);
}

__global__ void cast_f32_bf16(const float* __restrict__ src, bf16* __restrict__ dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

// ---------------------------------------------------------------- bf16 path

constexpr int BB_KV = 128;  // keys a block: two consumer warpgroups of 64
constexpr int BB_Q = 64;    // queries a stage

template <int DP, bool DQ>
struct BwdBf16 {
  static constexpr int THREADS = 384;  // one producer and two consumer warpgroups
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int NB = DP / 16;
  static constexpr int DQ_N = DP > 80 ? 32 : DP;  // dQ column chunk: fits the registers
  static constexpr int DQ_CH = DP / DQ_N;
  static constexpr int KV_BYTES = BB_KV * DP * 2;  // one of K, V
  static constexpr int Q_BYTES = BB_Q * DP * 2;    // one of Q, dO
  static constexpr int DS_BYTES = BB_KV * BB_Q * 2;
  static constexpr int STG_BYTES = BB_Q * DQ_N * 4;  // one warpgroup's dQ staging chunk
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_RING = 2 * KV_BYTES;  // stage s: Q, dO, lse (64 f32), delta (64 f32)
  static constexpr int STAGE = 2 * Q_BYTES + 1024;
  // At D = 160 K4's dS^T remainders take the room of the second stage.
  static constexpr int STAGES = DQ && DP > 80 ? 1 : 2;
  static constexpr int OFF_DS = OFF_RING + STAGES * STAGE;  // two dS^T buffers, then two remainders
  static constexpr int OFF_STG = OFF_DS + (DQ ? 4 * DS_BYTES : 0);  // two staging chunks
  static constexpr int OFF_BAR = OFF_STG + (DQ ? 2 * STG_BYTES : 0);
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
  static_assert(DQ_N % 16 == 0, "dQ chunks start at a column block");
};

// The sweep of one block; the tensor maps are the kernel's __grid_constant__
// parameters, which the TMA instructions address in place.
template <int DP, bool DQ>
__device__ __forceinline__ void bwd_bf16_sweep(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tg,
    const CUtensorMap& tdq, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int d, float scale) {
  using C = BwdBf16<DP, DQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t s0 = smem_u32(base);
  const uint32_t sK = s0, sV = s0 + C::OFF_V;
  auto sQ = [&](int s) { return s0 + C::OFF_RING + s * C::STAGE; };
  auto sG = [&](int s) { return sQ(s) + C::Q_BYTES; };
  auto Ls = [&](int s) { return reinterpret_cast<float*>(base + C::OFF_RING + s * C::STAGE + 2 * C::Q_BYTES); };
  const uint32_t bars = s0 + C::OFF_BAR;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + C::STAGES + s); };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BB_KV;
  const int nq = (sq + BB_Q - 1) / BB_Q;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_arrive_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::NB; ++c) {
        tma_load_3d(sK + c * BB_KV * 32, &tk, kv_full, c * 16, k0, bh);
        tma_load_3d(sV + c * BB_KV * 32, &tv, kv_full, c * 16, k0, bh);
      }
    }
    const float* lb = lse + size_t(bh) * sq;
    const float* eb = delta + size_t(bh) * sq;
    for (int it = 0; it < nq; ++it) {
      const int s = it % C::STAGES;
      if (it >= C::STAGES) mbar_wait(empty(s), ((it / C::STAGES) - 1) & 1);
      const int row = it * BB_Q + (tid % BB_Q);
      float* L = Ls(s);
      if (tid < BB_Q)
        L[tid] = row < sq ? lb[row] * kLog2e : kFarLse;
      else
        L[tid] = row < sq ? eb[row] : 0.f;  // delta follows lse
      if (tid == 0) {
        mbar_arrive_tx(full(s), 2 * C::Q_BYTES);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_3d(sQ(s) + c * BB_Q * 32, &tq, full(s), c * 16, it * BB_Q, bh);
          tma_load_3d(sG(s) + c * BB_Q * 32, &tg, full(s), c * 16, it * BB_Q, bh);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumers: warpgroup cw owns keys k0 + 64 cw .. + 63
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < nq; ++it) {
    const int s = it % C::STAGES;
    const int q0 = it * BB_Q;
    mbar_wait(full(s), (it / C::STAGES) & 1);
    float st[BB_Q / 2], dpt[BB_Q / 2];
#pragma unroll
    for (int i = 0; i < BB_Q / 2; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::NB; ++kk)
      WgmmaSS<BB_Q, 0, 0>::run(st, desc_kmajor(sK + kk * BB_KV * 32 + cw * 64 * 32),
                               desc_kmajor(sQ(s) + kk * BB_Q * 32), 1);
#pragma unroll
    for (int kk = 0; kk < C::NB; ++kk)
      WgmmaSS<BB_Q, 0, 0>::run(dpt, desc_kmajor(sV + kk * BB_KV * 32 + cw * 64 * 32),
                               desc_kmajor(sG(s) + kk * BB_Q * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T: element 4j + e of the accumulators is key row g (e < 2)
    // or g + 8, query column 8 j + 2 t + (e & 1).
    const float* L = Ls(s);
    const float* E = L + BB_Q;
    uint32_t pa[BB_Q / 16][4], sa[BB_Q / 16][4], sr[BB_Q / 16][4];
    [[maybe_unused]] const int kr = cw * 64 + warp * 16 + g;  // key row in the block's dS^T tile
    [[maybe_unused]] unsigned char* ds_tile = base + C::OFF_DS + (it & 1) * C::DS_BYTES;
#pragma unroll
    for (int j = 0; j < BB_Q / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = L[col], l1 = L[col + 1], e0 = E[col], e1 = E[col + 1];
      const float p0 = exp2f(st[4 * j] * scale_log2 - l0);
      const float p1 = exp2f(st[4 * j + 1] * scale_log2 - l1);
      const float p2 = exp2f(st[4 * j + 2] * scale_log2 - l0);
      const float p3 = exp2f(st[4 * j + 3] * scale_log2 - l1);
      const float d0 = p0 * (dpt[4 * j] - e0) * scale;
      const float d1 = p1 * (dpt[4 * j + 1] - e1) * scale;
      const float d2 = p2 * (dpt[4 * j + 2] - e0) * scale;
      const float d3 = p3 * (dpt[4 * j + 3] - e1) * scale;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      const uint32_t s01 = pack_bf16(d0, d1), s23 = pack_bf16(d2, d3);
      const uint32_t r01 = pack_bf16_rest(d0, d1, s01), r23 = pack_bf16_rest(d2, d3, s23);
      sa[j / 2][(j % 2) * 2] = s01;
      sa[j / 2][(j % 2) * 2 + 1] = s23;
      sr[j / 2][(j % 2) * 2] = r01;
      sr[j / 2][(j % 2) * 2 + 1] = r23;
      if constexpr (DQ) {
        // dS^T (keys x queries) into its column-block tile of 128 rows
        *reinterpret_cast<uint32_t*>(ds_tile + cb_offset(kr, col, BB_KV)) = s01;
        *reinterpret_cast<uint32_t*>(ds_tile + cb_offset(kr + 8, col, BB_KV)) = s23;
        unsigned char* rest = ds_tile + 2 * C::DS_BYTES;  // what the bf16 rounding left
        *reinterpret_cast<uint32_t*>(rest + cb_offset(kr, col, BB_KV)) = r01;
        *reinterpret_cast<uint32_t*>(rest + cb_offset(kr + 8, col, BB_KV)) = r23;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BB_Q / 16; ++kq)
      WgmmaRS<DP, 1>::run(dva, pa[kq], desc_mnmajor(sG(s) + kq * 16 * 32, BB_Q), 1);
    // dK takes dS^T as its bf16 remainder, then its bf16 high part.
#pragma unroll
    for (int kq = 0; kq < BB_Q / 16; ++kq)
      WgmmaRS<DP, 1>::run(dka, sr[kq], desc_mnmajor(sQ(s) + kq * 16 * 32, BB_Q), 1);
#pragma unroll
    for (int kq = 0; kq < BB_Q / 16; ++kq)
      WgmmaRS<DP, 1>::run(dka, sa[kq], desc_mnmajor(sQ(s) + kq * 16 * 32, BB_Q), 1);
    wgmma_commit();
    if constexpr (!DQ) {
      wgmma_wait<0>();  // dV and dK of this tile have read Q and dO
    } else {
      fence_proxy_async();         // dS^T stores visible to wgmma
      named_bar_sync(1, 256);      // both warpgroups' dS^T in place

      if (cw == (it & 1)) {
        // dQ_tile (64 queries x DP) = dS K over the block's 128 keys, by one
        // warpgroup on alternate tiles (the other goes on to the next tile),
        // in column chunks, each added into dQ by one bulk reduce-add.
        const uint32_t sDS = smem_u32(ds_tile);
        const uint32_t sStg = s0 + C::OFF_STG + cw * C::STG_BYTES;
        float* stg = reinterpret_cast<float*>(base + C::OFF_STG + cw * C::STG_BYTES);
        const bool leader = threadIdx.x == 128 * wg;
#pragma unroll
        for (int ch = 0; ch < C::DQ_CH; ++ch) {
          float dqa[C::DQ_N / 2];
#pragma unroll
          for (int i = 0; i < C::DQ_N / 2; ++i) dqa[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BB_KV / 16; ++kk) {
            const uint64_t kd =
                desc_mnmajor(sK + (ch * C::DQ_N / 16) * BB_KV * 32 + kk * 16 * 32, BB_KV);
            WgmmaSS<C::DQ_N, 1, 1>::run(dqa, desc_mnmajor(sDS + kk * 16 * 32, BB_KV), kd, 1);
            WgmmaSS<C::DQ_N, 1, 1>::run(
                dqa, desc_mnmajor(sDS + 2 * C::DS_BYTES + kk * 16 * 32, BB_KV), kd, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();  // also completes dV and dK of this tile
          fence_regs(dqa);
          if (leader) bulk_wait_read();  // the last reduce-add has read the staging chunk
          named_bar_sync(2 + cw, 128);
          const int ra = warp * 16 + g;
#pragma unroll
          for (int j = 0; j < C::DQ_N / 8; ++j) {
            *reinterpret_cast<float2*>(stg + ra * C::DQ_N + j * 8 + 2 * t) =
                make_float2(dqa[4 * j], dqa[4 * j + 1]);
            *reinterpret_cast<float2*>(stg + (ra + 8) * C::DQ_N + j * 8 + 2 * t) =
                make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
          }
          fence_proxy_async();
          named_bar_sync(2 + cw, 128);
          if (leader) {
            tma_reduce_add_3d(&tdq, sStg, ch * C::DQ_N, q0, bh);
            bulk_commit();
          }
        }
      } else {
        wgmma_wait<0>();  // dV and dK of this tile have read Q and dO
      }
    }
    fence_regs(dka);
    fence_regs(dva);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // Q, dO, lse and delta of this stage consumed
  }
  if (DQ && threadIdx.x == 128 * wg) bulk_wait();

  const int ra = k0 + cw * 64 + warp * 16 + g, rb = ra + 8;
  bf16* dkb = dk + size_t(bh) * sk * d;
  bf16* dvb = dv + size_t(bh) * sk * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < d) {
      if (ra < sk) {
        *reinterpret_cast<uint32_t*>(dkb + size_t(ra) * d + col) = pack_bf16(dka[4 * j], dka[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dvb + size_t(ra) * d + col) = pack_bf16(dva[4 * j], dva[4 * j + 1]);
      }
      if (rb < sk) {
        *reinterpret_cast<uint32_t*>(dkb + size_t(rb) * d + col) =
            pack_bf16(dka[4 * j + 2], dka[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dvb + size_t(rb) * d + col) =
            pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// K4's kernel and K6's (the sweep without dQ), under names of their own so
// that build logs and traces tell them apart.
#define SIDLSG_BWD_BF16_KERNEL(NAME, DQ)                                                          \
  template <int DP>                                                                               \
  __global__ void __launch_bounds__(BwdBf16<DP, DQ>::THREADS, 1)                                 \
  NAME(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,            \
       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,            \
       const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,                    \
       const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,     \
       int sk, int d, float scale) {                                                              \
    bwd_bf16_sweep<DP, DQ>(tq, tk, tv, tg, tdq, lse, delta, dk, dv, sq, sk, d, scale);            \
  }
SIDLSG_BWD_BF16_KERNEL(bwd_bf16_wgmma, true)
SIDLSG_BWD_BF16_KERNEL(bwd_dkv_bf16_wgmma, false)
#undef SIDLSG_BWD_BF16_KERNEL

// DQ false (K6): dq_acc is unused and may be null.
template <int DP, bool DQ>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                            int bh, int sq, int sk, int d, float scale, cudaStream_t st) {
  using C = BwdBf16<DP, DQ>;
  CUtensorMap tq, tk, tv, tg, tdq{};
  cudaError_t err = tensor_map_bf16(&tq, q, bh, sq, d, BB_Q);
  if (DQ && err == cudaSuccess) err = tensor_map_f32(&tdq, dq_acc, bh, sq, d, C::DQ_N, BB_Q);
  if (err == cudaSuccess) err = tensor_map_bf16(&tg, dout, bh, sq, d, BB_Q);
  if (err == cudaSuccess) err = tensor_map_bf16(&tk, k, bh, sk, d, BB_KV);
  if (err == cudaSuccess) err = tensor_map_bf16(&tv, v, bh, sk, d, BB_KV);
  const auto kernel = DQ ? bwd_bf16_wgmma<DP> : bwd_dkv_bf16_wgmma<DP>;
  // Once per instantiation: the register check and the shared-memory limit.
  static const cudaError_t prepared = [kernel] {
    const cudaError_t e = check_ws_regs(reinterpret_cast<const void*>(kernel), 2,
                                        C::PRODUCER_REGS, C::CONSUMER_REGS);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::SMEM);
  }();
  if (err == cudaSuccess) err = prepared;
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BB_KV - 1) / BB_KV, bh);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, tg, tdq, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, d,
      scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int BF_KV = 32;  // keys a block
constexpr int BF_Q = 16;   // queries a tile
constexpr int BF_THREADS = 256;

template <int DP>  // head dim padded to a multiple of 64
struct BwdF32 {
  static constexpr int LD = DP + 4;       // row stride of the K, V, Q and dO tiles
  static constexpr int LT = BF_Q + 4;     // row stride of the P^T and dS^T tiles
  static constexpr int DQC = DP <= 256 ? DP : DP / 2;  // dQ chunk: a TMA box is <= 256 wide
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(2) * BF_KV * LD + size_t(2) * BF_Q * LD + size_t(10) * BF_KV * LT +
                       2 * BF_Q);
};

template <int DP, bool DQ>
__device__ __forceinline__ void bwd_f32_sweep(
    const CUtensorMap& tdq, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    int d, float scale) {
  using C = BwdF32<DP>;
  constexpr int LD = C::LD, LT = C::LT, DQC = C::DQC;
  constexpr int NTW = DP / 64;  // n8 tiles of dK / dV a warp, in each of its two 16-key halves
  constexpr int NTQ = DP / 8;   // n8 tiles of dQ_tile, dealt round the warps
  extern __shared__ __align__(1024) float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + BF_KV * LD;
  float* Qs = Vs + BF_KV * LD;
  float* Gs = Qs + BF_Q * LD;
  float* PT = Gs + BF_Q * LD;   // P^T, (keys, queries)
  float* DT = PT + BF_KV * LT;  // dS^T
  float* RED = DT + BF_KV * LT;  // S^T and dP^T partials over quarters of D; then a dQ chunk
  float* Ls = RED + 8 * BF_KV * LT;
  float* Es = Ls + BF_Q;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BF_KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const float* qb = q + size_t(bh) * sq * d;
  const float* gb = dout + size_t(bh) * sq * d;

  load_rows_f32<BF_KV, DP>(Ks, LD, k + size_t(bh) * sk * d, k0, sk, d);
  load_rows_f32<BF_KV, DP>(Vs, LD, v + size_t(bh) * sk * d, k0, sk, d);
  load_rows_f32<BF_Q, DP>(Qs, LD, qb, 0, sq, d);
  load_rows_f32<BF_Q, DP>(Gs, LD, gb, 0, sq, d);
  cp_async_commit_group();

  // dK and dV: warp w owns all 32 keys at columns w DP / 8 .. (so that each
  // dO and Q fragment it splits feeds two products).
  const int c0 = warp * (DP / 8);
  float dka[2][NTW][4], dva[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][j][e] = dva[m][j][e] = 0.f;

  const int nq = (sq + BF_Q - 1) / BF_Q;
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * BF_Q;
    if (threadIdx.x < BF_Q) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < sq ? lse[size_t(bh) * sq + row] * kLog2e : kFarLse;
      Es[threadIdx.x] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
    }
    if (DQ && threadIdx.x == 0) bulk_wait_read();  // RED is free of the last dQ chunk
    cp_async_wait_group<0>();
    __syncthreads();

    // S^T (warps 0-3) and dP^T (warps 4-7): each warp takes all four
    // 16 x 8 tiles of its product over a quarter of D, so that each A and B
    // fragment it loads and splits feeds two products; the quarters meet in
    // shared memory.
    {
      const int pr = warp >> 2, kq = warp & 3;
      const float* A = pr ? Vs : Ks;
      const float* B = pr ? Gs : Qs;
      float acc[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < DP / 32; ++kk) {
        const int kc = kq * (DP / 4) + kk * 8 + t;
        Tf32Frag a[2];
        uint32_t b[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* ar = A + (m * 16 + g) * LD + kc;
          load_frag(a[m], ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* br = B + (n * 8 + g) * LD + kc;
          split_b(b[n], br[0], br[4]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_3xtf32(acc[m][n], a[m], b[n]);
      }
      float* out = RED + (pr * 4 + kq) * BF_KV * LT;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int r = m * 16 + g, c = n * 8 + 2 * t;
          *reinterpret_cast<float2*>(out + r * LT + c) = make_float2(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<float2*>(out + (r + 8) * LT + c) = make_float2(acc[m][n][2], acc[m][n][3]);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BF_KV * BF_Q; i += BF_THREADS) {
      const int r = i / BF_Q, c = i % BF_Q;
      float sv = 0.f, dp = 0.f;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        sv += RED[kq * BF_KV * LT + r * LT + c];
        dp += RED[(4 + kq) * BF_KV * LT + r * LT + c];
      }
      const float p = exp2f(sv * scale_log2 - Ls[c]);
      PT[r * LT + c] = p;
      DT[r * LT + c] = p * (dp - Es[c]) * scale;
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the 16 queries (two k8 steps).
#pragma unroll
    for (int kk = 0; kk < BF_Q / 8; ++kk) {
      Tf32Frag ap[2], as[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* pr = PT + (m * 16 + g) * LT + kk * 8 + t;
        const float* sr = DT + (m * 16 + g) * LT + kk * 8 + t;
        load_frag(ap[m], pr[0], pr[8 * LT], pr[4], pr[8 * LT + 4]);
        load_frag(as[m], sr[0], sr[8 * LT], sr[4], sr[8 * LT + 4]);
      }
      const float* gr = Gs + (kk * 8 + t) * LD + c0 + g;
      const float* qr = Qs + (kk * 8 + t) * LD + c0 + g;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        uint32_t bg[4], bq[4];
        split_b(bg, gr[j * 8], gr[4 * LD + j * 8]);
        split_b(bq, qr[j * 8], qr[4 * LD + j * 8]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_3xtf32(dva[m][j], ap[m], bg);
          mma_3xtf32(dka[m][j], as[m], bq);
        }
      }
    }
    __syncthreads();  // Q and dO consumed: the next tiles stream in during dQ
    if (it + 1 < nq) {
      load_rows_f32<BF_Q, DP>(Qs, LD, qb, q0 + BF_Q, sq, d);
      load_rows_f32<BF_Q, DP>(Gs, LD, gb, q0 + BF_Q, sq, d);
    }
    cp_async_commit_group();

    // dQ_tile = dS K (16 queries x DP, over the 32 keys) in column chunks
    // of DQC, each staged in RED as (16, DQC) and added into dQ by one TMA
    // bulk reduce-add.
    if constexpr (DQ) {
      Tf32Frag a[BF_KV / 8];
#pragma unroll
      for (int kk = 0; kk < BF_KV / 8; ++kk) {
        const float* sr = DT + (kk * 8 + t) * LT + g;  // dS[q][key] = dS^T[key][q]
        load_frag(a[kk], sr[0], sr[8], sr[4 * LT], sr[4 * LT + 8]);
      }
#pragma unroll 1
      for (int ch = 0; ch < DP / DQC; ++ch) {
        if (ch > 0) {
          if (threadIdx.x == 0) bulk_wait_read();
          __syncthreads();
        }
        for (int j = warp; j < DQC / 8; j += 8) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < BF_KV / 8; ++kk) {
            const float* kr = Ks + (kk * 8 + t) * LD + ch * DQC + j * 8 + g;
            mma_3xtf32(acc, a[kk], kr[0], kr[4 * LD]);
          }
          *reinterpret_cast<float2*>(RED + g * DQC + j * 8 + 2 * t) = make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(RED + (g + 8) * DQC + j * 8 + 2 * t) =
              make_float2(acc[2], acc[3]);
        }
        fence_proxy_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          tma_reduce_add_3d(&tdq, smem_u32(RED), ch * DQC, q0, bh);
          bulk_commit();
        }
      }
    }
  }
  if (DQ && threadIdx.x == 0) bulk_wait();

  float* dkb = dk + size_t(bh) * sk * d;
  float* dvb = dv + size_t(bh) * sk * d;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int ra = k0 + m * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < d) {
        if (ra < sk) {
          *reinterpret_cast<float2*>(dkb + size_t(ra) * d + col) =
              make_float2(dka[m][j][0], dka[m][j][1]);
          *reinterpret_cast<float2*>(dvb + size_t(ra) * d + col) =
              make_float2(dva[m][j][0], dva[m][j][1]);
        }
        if (rb < sk) {
          *reinterpret_cast<float2*>(dkb + size_t(rb) * d + col) =
              make_float2(dka[m][j][2], dka[m][j][3]);
          *reinterpret_cast<float2*>(dvb + size_t(rb) * d + col) =
              make_float2(dva[m][j][2], dva[m][j][3]);
        }
      }
    }
  }
}

// K4's kernel and K6's, as in the bf16 path.
#define SIDLSG_BWD_F32_KERNEL(NAME, DQ)                                                           \
  template <int DP>                                                                               \
  __global__ void __launch_bounds__(BF_THREADS, 1)                                               \
  NAME(const __grid_constant__ CUtensorMap tdq, const float* __restrict__ q,                      \
       const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ dout,  \
       const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,    \
       float* __restrict__ dv, int sq, int sk, int d, float scale) {                              \
    bwd_f32_sweep<DP, DQ>(tdq, q, k, v, dout, lse, delta, dk, dv, sq, sk, d, scale);              \
  }
SIDLSG_BWD_F32_KERNEL(bwd_f32_tf32x3, true)
SIDLSG_BWD_F32_KERNEL(bwd_dkv_f32_tf32x3, false)
#undef SIDLSG_BWD_F32_KERNEL

// DQ false (K6): dq_acc is unused and may be null.
template <int DP, bool DQ>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                           int bh, int sq, int sk, int d, float scale, cudaStream_t st) {
  const size_t smem = BwdF32<DP>::SMEM;
  CUtensorMap tdq{};
  cudaError_t err = DQ ? tensor_map_f32(&tdq, dq_acc, bh, sq, d, BwdF32<DP>::DQC, BF_Q) : cudaSuccess;
  const auto kernel = DQ ? bwd_f32_tf32x3<DP> : bwd_dkv_f32_tf32x3<DP>;
  static const cudaError_t prepared =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) err = prepared;
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BF_KV - 1) / BF_KV, bh);
  kernel<<<grid, BF_THREADS, smem, st>>>(
      tdq, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale);
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                          int bh, int sq, int sk, int d, float scale, cudaStream_t st) {
#define SIDLSG_BWD_BF16(DP) \
  if (d <= DP)              \
    return launch_bwd_bf16<DP, DQ>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq, sk, d, scale, st);
  SIDLSG_BWD_BF16(16)
  SIDLSG_BWD_BF16(32)
  SIDLSG_BWD_BF16(48)
  SIDLSG_BWD_BF16(64)
  SIDLSG_BWD_BF16(80)
  SIDLSG_BWD_BF16(160)
#undef SIDLSG_BWD_BF16
  return cudaErrorInvalidValue;
}

template <bool DQ>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                         int bh, int sq, int sk, int d, float scale, cudaStream_t st) {
#define SIDLSG_BWD_F32(DP) \
  if (d <= DP)             \
    return launch_bwd_f32<DP, DQ>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq, sk, d, scale, st);
  SIDLSG_BWD_F32(64)
  SIDLSG_BWD_F32(192)
  SIDLSG_BWD_F32(320)
  SIDLSG_BWD_F32(512)
#undef SIDLSG_BWD_F32
  return cudaErrorInvalidValue;
}

// What both entries require: shapes the kernels take, d a whole 16-byte
// row (the wrapper pads other head dims with zero columns), bh within the
// grid's y limit, and 16-byte aligned tensors.
bool inputs_ok(const void* q, const void* k, const void* v, const void* dout, const void* dk,
               const void* dv, int bh, int sq, int sk, int d, int dtype) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  return shape_ok(bh, sq, sk, d, dtype) && bh <= 65535 && d % (dtype == 1 ? 8 : 4) == 0 &&
         addr % 16 == 0;
}

template <bool DQ>
int bwd_smem(int dtype, int d) {
  if (dtype == 1 && d % 8 == 0) {
#define SIDLSG_SMEM_BF16(DP) \
  if (d <= DP) return BwdBf16<DP, DQ>::SMEM;
    SIDLSG_SMEM_BF16(16)
    SIDLSG_SMEM_BF16(32)
    SIDLSG_SMEM_BF16(48)
    SIDLSG_SMEM_BF16(64)
    SIDLSG_SMEM_BF16(80)
    SIDLSG_SMEM_BF16(160)
#undef SIDLSG_SMEM_BF16
  }
  if (dtype == 0 && d % 4 == 0) {
    if (d <= 64) return int(BwdF32<64>::SMEM);
    if (d <= 192) return int(BwdF32<192>::SMEM);
    if (d <= 320) return int(BwdF32<320>::SMEM);
    if (d <= 512) return int(BwdF32<512>::SMEM);
  }
  return -1;
}

}  // namespace

extern "C" {

// q, out, dout, dq: (bh, sq, d); k, v, dk, dv: (bh, sk, d), in the input
// dtype (0 = f32, 1 = bf16), contiguous and 16-byte aligned.  lse: (bh, sq)
// f32 from the forward.  delta: (bh, sq) f32 scratch.  dq_acc: (bh, sq, d)
// f32 scratch, zeroed here; for f32 inputs it must be dq itself.  Returns a
// cudaError_t; cudaErrorInvalidValue for what the kernels do not take: bf16
// needs d % 8 == 0 and d <= 160, f32 d % 4 == 0 and d <= 512 (the wrapper
// pads other head dims with zero columns).
int sidlsg_flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
                          void* dk, void* dv, int bh, int sq, int sk, int d, float scale,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!inputs_ok(q, k, v, dout, dk, dv, bh, sq, sk, d, dtype) || (dtype == 0 && dq_acc != dq) ||
      reinterpret_cast<uintptr_t>(dq_acc) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long rows = (long long)bh * sq;
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  const float* lf = static_cast<const float*>(lse);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * rows * d, st);
  if (err != cudaSuccess) return err;
  err = run_delta(out, dout, dl, rows, d, dtype, st);
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    err = dispatch_bf16<true>(q, k, v, dout, lf, dl, acc, dk, dv, bh, sq, sk, d, scale, st);
    if (err != cudaSuccess) return err;
    const long long n = rows * d;
    const unsigned blocks = unsigned((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    cast_f32_bf16<<<blocks, 256, 0, st>>>(acc, static_cast<bf16*>(dq), n);
    return cudaGetLastError();
  }
  return dispatch_f32<true>(q, k, v, dout, lf, dl, acc, dk, dv, bh, sq, sk, d, scale, st);
}

// K6: dK and dV by the sweep above without its dQ section.  Shapes, dtypes
// and alignment as sidlsg_flash_attn_bwd; delta: (bh, sq) f32 scratch.
int sidlsg_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* dk, void* dv,
                              int bh, int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!inputs_ok(q, k, v, dout, dk, dv, bh, sq, sk, d, dtype)) return cudaErrorInvalidValue;
  float* dl = static_cast<float*>(delta);
  cudaError_t err = run_delta(out, dout, dl, (long long)bh * sq, d, dtype, st);
  if (err != cudaSuccess) return err;
  const float* lf = static_cast<const float*>(lse);
  return dtype == 1
             ? dispatch_bf16<false>(q, k, v, dout, lf, dl, nullptr, dk, dv, bh, sq, sk, d, scale, st)
             : dispatch_f32<false>(q, k, v, dout, lf, dl, nullptr, dk, dv, bh, sq, sk, d, scale, st);
}

// Dynamic shared memory a launch of the main kernel of
// sidlsg_flash_attn_bwd (K4) takes at this dtype and head dim (-1 where it
// does not launch).
int sidlsg_flash_attn_bwd_smem(int dtype, int d) { return bwd_smem<true>(dtype, d); }

// The same for sidlsg_flash_attn_bwd_dkv (K6).
int sidlsg_flash_attn_bwd_dkv_smem(int dtype, int d) { return bwd_smem<false>(dtype, d); }

}  // extern "C"
