// Flash-attention backward kernels for Hopper (sm_90a), shared by K4
// (flash_attn_bwd.cu) and K5/K6 (flash_attn_bwd_twopass.cu).
//
// Every kernel here recomputes the probabilities from the forward's row
// logsumexp, P = exp(S * scale - lse), with S = Q K^T, and uses
// delta = rowsum(dO * O) (the pre-pass below):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
// Nothing of size S_q x S_k reaches device memory.  Ragged tails (S_k = 77,
// S_q not a multiple of the tile) are masked in the kernels: rows past the
// end load as zeros and their probabilities are set to 0.
//
// What bounds them on the H100: the five products are 10 * S_q * S_k * D
// operations per (batch, head) against (4 S_q + 4 S_k) * D * 2 bytes, far
// above the card's ~295 operations per byte at the UNet's self-attention
// (S = 4096/1024), so the tensor cores bound them; at cross-attention
// (S_k = 77) the bytes of Q, dO and dQ do.
//
// Design (bf16, mma.sync m16n8k16, f32 accumulate, as K1):
// - kv kernel (K4 with dQ, K6 without): one block of 4 warps per (bh,
//   64-key tile); each warp owns 16 keys.  The block walks the q-tiles in a
//   loop, Q/dO tiles double-buffered by 16-byte cp.async.  S^T and dP^T are
//   computed key-major, so P^T and dS^T sit in registers in the C-fragment
//   layout that is also the A operand of dV += P^T dO and dK += dS^T Q; dV
//   and dK accumulate in registers for the whole sweep.  For dQ the block
//   writes dS (bf16) to shared memory as [q][key], multiplies it by its K
//   tile and adds the (q-tile x D) result into one f32 buffer with
//   atomicAdd: the TPU kernel's per-k-block dQ partials would be num_k
//   times the size of dQ (64x at S = 4096).
// - dq kernel (K5): one block of 4 warps per (bh, 64-query tile), looping
//   over the k-tiles as K1 does; dQ stays in registers, written once, no
//   atomics, so K5 + K6 are deterministic.
// f32 (the VAE's and the DINO ViT's attention, the tiny check and --bf16 0;
// D <= 512): CUDA cores, 32-key x 32-query tiles and 128 threads per block
// up to D = 160, 16 x 16 tiles and 256 threads above, so that the four
// (tile x D) f32 tiles fit the 227 KB of shared memory at D = 512 (133 KB
// there); P and dS of a tile pair go through shared memory, dK and dV stay
// in registers (at D = 512, 64 floats per thread).  At D = 512 the five
// products are 10 S_q S_k D operations on f32 CUDA cores, which bound it.
// TMA, wgmma and warp specialisation are not used yet.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kTile = 64;    // bf16: keys per kv block, queries per dq block
constexpr int kTileF = 32;   // f32: keys and queries per tile
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// --------------------------------------------------------------- bf16 path

// Rows [row0, row0 + ROWS) of a (rows_total, d) bf16 matrix into shared
// memory with row stride DP + 8; rows past the end and columns in [d, DP)
// are 0.  With vec (d % 8 == 0, 16-byte aligned source) rows move as
// 16-byte cp.async copies that land at the next cp_async_wait.
template <int DP, int ROWS>
__device__ void load_rows(bf16* dst, const bf16* src, int row0, int rows_total, int d, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      bf16* to = dst + r * LD + c;
      if (row0 + r < rows_total && c < d)
        cp_async16(to, src + size_t(row0 + r) * d + c);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < rows_total && c < d) val = src[size_t(row0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

// ROWS per-row f32 values (lse or delta) starting at row0, 0 past the end.
template <int ROWS>
__device__ void load_vec(float* dst, const float* src, int row0, int rows_total) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x)
    dst[i] = row0 + i < rows_total ? src[row0 + i] : 0.f;
}

// q-tile height of the kv kernel: smaller for the widest head so that the
// dK/dV accumulators and the score fragments fit the registers.
template <int DP>
struct KvTile {
  static constexpr int BQ = DP > 80 ? 32 : 64;
};

template <int DP>
size_t kv_smem_bytes(bool with_dq) {
  constexpr int LD = DP + 8;
  constexpr int BQ = KvTile<DP>::BQ;
  size_t bytes = (size_t(2) * kTile + 4 * BQ) * LD * sizeof(bf16) + 4 * BQ * sizeof(float);
  if (with_dq) bytes += size_t(BQ) * (kTile + 8) * sizeof(bf16);
  return bytes;
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A registers
// hold rows g and g+8 at columns 2t, 2t+1 (+8); B registers hold k rows 2t,
// 2t+1 (+8) of column g; C holds rows g (c0, c1) and g+8 (c2, c3) at
// columns 2t, 2t+1.  A C tile pair (n8 tiles 2j, 2j+1) is therefore the A
// operand of a k16 step once packed to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_f(c0[0], c0[1]);
  a[1] = pack_f(c0[2], c0[3]);
  a[2] = pack_f(c1[0], c1[1]);
  a[3] = pack_f(c1[2], c1[3]);
}

// K4 (DQ = true) and K6 (DQ = false).
template <int DP, bool DQ>
__global__ void __launch_bounds__(kThreads)
bwd_kv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dq_acc, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int sq, int sk, int d, float scale, int vec) {
  constexpr int LD = DP + 8;
  constexpr int NT = DP / 8;   // n8 tiles over the head dim
  constexpr int KS = DP / 16;  // k16 steps over the head dim
  constexpr int BQ = KvTile<DP>::BQ;
  constexpr int QT = BQ / 8;   // n8 tiles over the q-tile
  constexpr int LDS = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;   // two buffers
  bf16* Gs = Qs + 2 * BQ * LD;  // dO, two buffers
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // lse, two buffers
  float* Es = Ls + 2 * BQ;                                  // delta, two buffers
  bf16* Ss = reinterpret_cast<bf16*>(Es + 2 * BQ);          // dS as [q][key]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp * 16;
  const bf16* qb = q + size_t(bh) * sq * d;
  const bf16* gb = dout + size_t(bh) * sq * d;
  const float* lb = lse + size_t(bh) * sq;
  const float* eb = delta + size_t(bh) * sq;

  load_rows<DP, kTile>(Ks, k + size_t(bh) * sk * d, k0, sk, d, vec);
  load_rows<DP, kTile>(Vs, v + size_t(bh) * sk * d, k0, sk, d, vec);
  load_rows<DP, BQ>(Qs, qb, 0, sq, d, vec);
  load_rows<DP, BQ>(Gs, gb, 0, sq, d, vec);
  load_vec<BQ>(Ls, lb, 0, sq);
  load_vec<BQ>(Es, eb, 0, sq);
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const bool key_a = k0 + kw + g < sk, key_b = k0 + kw + g + 8 < sk;

  const int ntiles = (sq + BQ - 1) / BQ;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * BQ;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the other buffer was released by the barrier ending it - 1
      const int nb = buf ^ 1;
      load_rows<DP, BQ>(Qs + nb * BQ * LD, qb, q0 + BQ, sq, d, vec);
      load_rows<DP, BQ>(Gs + nb * BQ * LD, gb, q0 + BQ, sq, d, vec);
      load_vec<BQ>(Ls + nb * BQ, lb, q0 + BQ, sq);
      load_vec<BQ>(Es + nb * BQ, eb, q0 + BQ, sq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just started has landed
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Gt = Gs + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Et = Es + buf * BQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T, 16 keys x BQ queries per warp.
    float st[QT][4], dp[QT][4];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bf16* ka = Ks + (kw + g) * LD + kk * 16 + 2 * t;
      const bf16* va = Vs + (kw + g) * LD + kk * 16 + 2 * t;
      const uint32_t ak[4] = {ld32(ka), ld32(ka + 8 * LD), ld32(ka + 8), ld32(ka + 8 * LD + 8)};
      const uint32_t av[4] = {ld32(va), ld32(va + 8 * LD), ld32(va + 8), ld32(va + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const bf16* qr = Qt + (j * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* gr = Gt + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(st[j], ak, ld32(qr), ld32(qr + 8));
        mma16816(dp[j], av, ld32(gr), ld32(gr + 8));
      }
    }

    // P^T (masked) and dS^T = P^T * (dP^T - delta) * scale, in place in st;
    // P^T goes to the A fragments of dV first.
    uint32_t pa[QT / 2][4];
#pragma unroll
    for (int j = 0; j < QT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool qok = q0 + col < sq;
        const float l = Lt[col], de = Et[col];
        const float pa_ = (key_a && qok) ? expf(st[j][e] * scale - l) : 0.f;
        const float pb_ = (key_b && qok) ? expf(st[j][2 + e] * scale - l) : 0.f;
        st[j][e] = pa_;
        st[j][2 + e] = pb_;
        dp[j][e] = pa_ * (dp[j][e] - de) * scale;
        dp[j][2 + e] = pb_ * (dp[j][2 + e] - de) * scale;
      }
    }
#pragma unroll
    for (int kq = 0; kq < QT / 2; ++kq) c_to_a(pa[kq], st[2 * kq], st[2 * kq + 1]);

    // dV += P^T dO and dK += dS^T Q: k16 steps over the q-tile; dO and Q
    // rows are the k index, read two rows apart for each B register.
#pragma unroll
    for (int kq = 0; kq < QT / 2; ++kq) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* gr = Gt + (kq * 16 + 2 * t) * LD + n * 8 + g;
        const bf16* qr = Qt + (kq * 16 + 2 * t) * LD + n * 8 + g;
        mma16816(dva[n], pa[kq], pack_h(gr[0], gr[LD]), pack_h(gr[8 * LD], gr[9 * LD]));
        mma16816(dka[n], sa, pack_h(qr[0], qr[LD]), pack_h(qr[8 * LD], qr[9 * LD]));
      }
    }

    if constexpr (DQ) {
      // dS (bf16) to shared memory as [q][key], then dQ_tile = dS K_tile.
#pragma unroll
      for (int j = 0; j < QT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          Ss[col * LDS + kw + g] = __float2bfloat16(dp[j][e]);
          Ss[col * LDS + kw + g + 8] = __float2bfloat16(dp[j][2 + e]);
        }
      }
      __syncthreads();
      constexpr int RG = BQ / 16;  // 16-row groups of the q-tile
      constexpr int CS = 4 / RG;   // warps sharing one row group, split over n8 tiles
      const int rg = warp % RG, cs = warp / RG;
      const int qa = q0 + rg * 16 + g, qb2 = qa + 8;
      float* dqa = dq_acc + (size_t(bh) * sq + qa) * d;
      float* dqb = dqa + size_t(8) * d;
      for (int n = cs; n < NT; n += CS) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const bf16* ar = Ss + (rg * 16 + g) * LDS + kk * 16 + 2 * t;
          const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LDS), ld32(ar + 8), ld32(ar + 8 * LDS + 8)};
          const bf16* kr = Ks + (kk * 16 + 2 * t) * LD + n * 8 + g;
          mma16816(acc, a, pack_h(kr[0], kr[LD]), pack_h(kr[8 * LD], kr[9 * LD]));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;
          if (col < d) {
            if (qa < sq) atomicAdd(dqa + col, acc[e]);
            if (qb2 < sq) atomicAdd(dqb + col, acc[2 + e]);
          }
        }
      }
    }
    __syncthreads();  // this buffer (and Ss) is refilled next
  }

  const int ra = k0 + kw + g, rb = ra + 8;
  bf16* dkb = dk + size_t(bh) * sk * d;
  bf16* dvb = dv + size_t(bh) * sk * d;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t + e;
      if (col < d) {
        if (ra < sk) {
          dkb[size_t(ra) * d + col] = __float2bfloat16(dka[n][e]);
          dvb[size_t(ra) * d + col] = __float2bfloat16(dva[n][e]);
        }
        if (rb < sk) {
          dkb[size_t(rb) * d + col] = __float2bfloat16(dka[n][2 + e]);
          dvb[size_t(rb) * d + col] = __float2bfloat16(dva[n][2 + e]);
        }
      }
    }
  }
}

template <int DP, bool DQ>
cudaError_t launch_kv_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                           int bh, int sq, int sk, int d, float scale, int vec, cudaStream_t st) {
  const size_t smem = kv_smem_bytes<DP>(DQ);
  cudaError_t err = cudaFuncSetAttribute(bwd_kv_bf16<DP, DQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kTile - 1) / kTile, bh);
  bwd_kv_bf16<DP, DQ><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, dq_acc, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, d, scale, vec);
  return cudaGetLastError();
}

// K5: dQ for one 64-query tile per block, looping over the k-tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dq, int sq, int sk, int d,
            float scale, int vec) {
  constexpr int LD = DP + 8;
  constexpr int NT = DP / 8;
  constexpr int KS = DP / 16;
  constexpr int KT = kTile / 8;  // n8 tiles over the k-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kTile * LD;
  bf16* Ks = Gs + kTile * LD;     // two buffers
  bf16* Vs = Ks + 2 * kTile * LD;  // two buffers

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* kb = k + size_t(bh) * sk * d;
  const bf16* vb = v + size_t(bh) * sk * d;
  const int ra = q0 + wr + g, rb = ra + 8;
  const bool ok_a = ra < sq, ok_b = rb < sq;
  const float la = ok_a ? lse[size_t(bh) * sq + ra] : 0.f;
  const float lb2 = ok_b ? lse[size_t(bh) * sq + rb] : 0.f;
  const float ea = ok_a ? delta[size_t(bh) * sq + ra] : 0.f;
  const float eb = ok_b ? delta[size_t(bh) * sq + rb] : 0.f;

  load_rows<DP, kTile>(Qs, q + size_t(bh) * sq * d, q0, sq, d, vec);
  load_rows<DP, kTile>(Gs, dout + size_t(bh) * sq * d, q0, sq, d, vec);
  load_rows<DP, kTile>(Ks, kb, 0, sk, d, vec);
  load_rows<DP, kTile>(Vs, vb, 0, sk, d, vec);
  cp_async_commit();

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int ntiles = (sk + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kTile;
    const bf16* Kt = Ks + (it & 1) * kTile * LD;
    const bf16* Vt = Vs + (it & 1) * kTile * LD;
    if (it + 1 < ntiles) {
      load_rows<DP, kTile>(Ks + ((it + 1) & 1) * kTile * LD, kb, k0 + kTile, sk, d, vec);
      load_rows<DP, kTile>(Vs + ((it + 1) & 1) * kTile * LD, vb, k0 + kTile, sk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[KT][4], dp[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bf16* qa = Qs + (wr + g) * LD + kk * 16 + 2 * t;
      const bf16* ga = Gs + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t aq[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
      const uint32_t ag[4] = {ld32(ga), ld32(ga + 8 * LD), ld32(ga + 8), ld32(ga + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const bf16* kr = Kt + (j * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* vr = Vt + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(s[j], aq, ld32(kr), ld32(kr + 8));
        mma16816(dp[j], ag, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool kok = k0 + j * 8 + 2 * t + e < sk;
        const float pa_ = (kok && ok_a) ? expf(s[j][e] * scale - la) : 0.f;
        const float pb_ = (kok && ok_b) ? expf(s[j][2 + e] * scale - lb2) : 0.f;
        dp[j][e] = pa_ * (dp[j][e] - ea) * scale;
        dp[j][2 + e] = pb_ * (dp[j][2 + e] - eb) * scale;
      }
    }
    // dQ += dS K: k16 steps over the k-tile; K rows are the k index.
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = Kt + (kk * 16 + 2 * t) * LD + n * 8 + g;
        mma16816(dqa[n], a, pack_h(kr[0], kr[LD]), pack_h(kr[8 * LD], kr[9 * LD]));
      }
    }
    __syncthreads();  // this buffer is refilled at it + 2
  }

  bf16* dqb = dq + size_t(bh) * sq * d;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t + e;
      if (col < d) {
        if (ok_a) dqb[size_t(ra) * d + col] = __float2bfloat16(dqa[n][e]);
        if (ok_b) dqb[size_t(rb) * d + col] = __float2bfloat16(dqa[n][2 + e]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                           int d, float scale, int vec, cudaStream_t st) {
  const size_t smem = size_t(6) * kTile * (DP + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  bwd_dq_bf16<DP><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), sq, sk, d, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32 path

// f32 tiles: TF rows of queries and of keys per tile pair, NTH threads per
// block.  TF = 32 with 128 threads for D <= 160; TF = 16 with 256 threads
// for D <= 512 (the VAE's one 512-wide head), where four 32-row tiles would
// need 271 KB of shared memory against the 227 KB a block may have.
template <int TF_, int NTH_>
struct TileF {
  static constexpr int TF = TF_;
  static constexpr int NTH = NTH_;
  static constexpr int TPR = NTH_ / TF_;  // threads per row of the dK/dV/dQ accumulators
};
using TileF32 = TileF<kTileF, kThreads>;  // D <= 160
using TileF16 = TileF<16, 256>;            // D <= 512

// Shared-memory layout of the f32 kernels: four (TF x D) tiles (Q, dO, K,
// V; rows padded by one float so that lanes reading different rows hit
// different banks), the P and dS tiles as [q][key], and the tile's lse and
// delta.
struct SmemF {
  float *Q, *G, *K, *V, *P, *S, *L, *E;
  int ld;  // row stride of the four (TF x D) tiles
};

template <int TF>
__device__ __forceinline__ SmemF smem_f(float* base, int d) {
  SmemF s;
  s.ld = d + 1;
  s.Q = base;
  s.G = s.Q + TF * s.ld;
  s.K = s.G + TF * s.ld;
  s.V = s.K + TF * s.ld;
  s.P = s.V + TF * s.ld;
  s.S = s.P + TF * (TF + 1);
  s.L = s.S + TF * (TF + 1);
  s.E = s.L + TF;
  return s;
}

template <int TF>
size_t smem_f_bytes(int d) {
  return sizeof(float) * (size_t(4) * TF * (d + 1) + size_t(2) * TF * (TF + 1) + 2 * TF);
}

template <int TF>
__device__ void load_rows_f(float* dst, int ld, const float* src, int row0, int rows_total, int d) {
  for (int i = threadIdx.x; i < TF * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = row0 + r < rows_total ? src[size_t(row0 + r) * d + c] : 0.f;
  }
}

// For the tile pair (q0.., k0..) whose Q, dO, K, V, lse and delta are in
// shared memory: P[q][key] and dS[q][key], 0 outside [sq) x [sk).
template <class TL>
__device__ void scores_f(const SmemF& s, int q0, int k0, int sq, int sk, int d, float scale) {
  constexpr int TF = TL::TF;
  for (int pair = threadIdx.x; pair < TF * TF; pair += TL::NTH) {
    const int qi = pair / TF, key = pair % TF;
    const float* qr = s.Q + qi * s.ld;
    const float* gr = s.G + qi * s.ld;
    const float* kr = s.K + key * s.ld;
    const float* vr = s.V + key * s.ld;
    float sv = 0.f, pv = 0.f;
    for (int c = 0; c < d; ++c) {
      sv = fmaf(qr[c], kr[c], sv);
      pv = fmaf(gr[c], vr[c], pv);
    }
    const bool ok = q0 + qi < sq && k0 + key < sk;
    const float p = ok ? expf(sv * scale - s.L[qi]) : 0.f;
    s.P[qi * (TF + 1) + key] = p;
    s.S[qi * (TF + 1) + key] = p * (pv - s.E[qi]) * scale;
  }
}

template <int TF>
__device__ void load_lse_delta(const SmemF& s, const float* lse, const float* delta, size_t base,
                               int q0, int sq) {
  for (int i = threadIdx.x; i < TF; i += blockDim.x) {
    s.L[i] = q0 + i < sq ? lse[base + q0 + i] : 0.f;
    s.E[i] = q0 + i < sq ? delta[base + q0 + i] : 0.f;
  }
}

// kv kernel in f32: one block per (bh, TF-key tile), looping over q-tiles;
// thread (key = tid / TPR, c = tid % TPR + TPR j) accumulates dK and dV in
// registers.  With DQ the block also adds dS K of each tile pair into
// dq_acc with atomicAdd.
template <class TL, int NJ, bool DQ>  // head dim d <= TPR * NJ
__global__ void __launch_bounds__(TL::NTH)
bwd_kv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq_acc, float* __restrict__ dk,
           float* __restrict__ dv, int sq, int sk, int d, float scale) {
  constexpr int TF = TL::TF, TPR = TL::TPR;
  extern __shared__ __align__(16) float fsm[];
  const SmemF s = smem_f<TF>(fsm, d);
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TF;
  const int row = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
  load_rows_f<TF>(s.K, s.ld, k + size_t(bh) * sk * d, k0, sk, d);
  load_rows_f<TF>(s.V, s.ld, v + size_t(bh) * sk * d, k0, sk, d);
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += TF) {
    __syncthreads();  // the previous tile is consumed
    load_rows_f<TF>(s.Q, s.ld, q + size_t(bh) * sq * d, q0, sq, d);
    load_rows_f<TF>(s.G, s.ld, dout + size_t(bh) * sq * d, q0, sq, d);
    load_lse_delta<TF>(s, lse, delta, size_t(bh) * sq, q0, sq);
    __syncthreads();
    scores_f<TL>(s, q0, k0, sq, sk, d, scale);
    __syncthreads();
    for (int qi = 0; qi < TF; ++qi) {
      const float p = s.P[qi * (TF + 1) + row];
      const float ds = s.S[qi * (TF + 1) + row];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + TPR * j;
        if (c < d) {
          dva[j] = fmaf(p, s.G[qi * s.ld + c], dva[j]);
          dka[j] = fmaf(ds, s.Q[qi * s.ld + c], dka[j]);
        }
      }
    }
    if constexpr (DQ) {
      const int qrow = q0 + row;
      if (qrow < sq) {
        float* dst = dq_acc + (size_t(bh) * sq + qrow) * d;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = c0 + TPR * j;
          if (c < d) {
            float acc = 0.f;
#pragma unroll
            for (int kk = 0; kk < TF; ++kk)
              acc = fmaf(s.S[row * (TF + 1) + kk], s.K[kk * s.ld + c], acc);
            atomicAdd(dst + c, acc);
          }
        }
      }
    }
  }
  const int key = k0 + row;
  if (key < sk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + TPR * j;
      if (c < d) {
        dk[(size_t(bh) * sk + key) * d + c] = dka[j];
        dv[(size_t(bh) * sk + key) * d + c] = dva[j];
      }
    }
  }
}

template <class TL, int NJ, bool DQ>
cudaError_t launch_kv_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
                          int bh, int sq, int sk, int d, float scale, cudaStream_t st) {
  const size_t smem = smem_f_bytes<TL::TF>(d);
  cudaError_t err = cudaFuncSetAttribute(bwd_kv_f32<TL, NJ, DQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + TL::TF - 1) / TL::TF, bh);
  bwd_kv_f32<TL, NJ, DQ><<<grid, TL::NTH, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, dq_acc, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, d, scale);
  return cudaGetLastError();
}

// dq kernel in f32 (K5): one block per (bh, TF-query tile), looping over
// k-tiles; thread (q = tid / TPR, c = tid % TPR + TPR j) accumulates dQ.
template <class TL, int NJ>
__global__ void __launch_bounds__(TL::NTH)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq, int sq, int sk, int d,
           float scale) {
  constexpr int TF = TL::TF, TPR = TL::TPR;
  extern __shared__ __align__(16) float fsm[];
  const SmemF s = smem_f<TF>(fsm, d);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TF;
  const int row = threadIdx.x / TPR, c0 = threadIdx.x % TPR;
  load_rows_f<TF>(s.Q, s.ld, q + size_t(bh) * sq * d, q0, sq, d);
  load_rows_f<TF>(s.G, s.ld, dout + size_t(bh) * sq * d, q0, sq, d);
  load_lse_delta<TF>(s, lse, delta, size_t(bh) * sq, q0, sq);
  float dqa[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dqa[j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += TF) {
    __syncthreads();
    load_rows_f<TF>(s.K, s.ld, k + size_t(bh) * sk * d, k0, sk, d);
    load_rows_f<TF>(s.V, s.ld, v + size_t(bh) * sk * d, k0, sk, d);
    __syncthreads();
    scores_f<TL>(s, q0, k0, sq, sk, d, scale);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + TPR * j;
      if (c < d) {
        float acc = dqa[j];
#pragma unroll
        for (int kk = 0; kk < TF; ++kk)
          acc = fmaf(s.S[row * (TF + 1) + kk], s.K[kk * s.ld + c], acc);
        dqa[j] = acc;
      }
    }
  }
  const int qrow = q0 + row;
  if (qrow < sq) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + TPR * j;
      if (c < d) dq[(size_t(bh) * sq + qrow) * d + c] = dqa[j];
    }
  }
}

template <class TL, int NJ>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int bh, int sq, int sk,
                          int d, float scale, cudaStream_t st) {
  const size_t smem = smem_f_bytes<TL::TF>(d);
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_f32<TL, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TL::TF - 1) / TL::TF, bh);
  bwd_dq_f32<TL, NJ><<<grid, TL::NTH, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), sq, sk, d, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- dispatch

// Whether the inputs take the 16-byte copies of the bf16 loaders.
inline int vec_ok(int d, const void* a, const void* b, const void* c, const void* e) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e);
  return (d % 8 == 0) && (addr % 16 == 0);
}

constexpr int kMaxHeadDimBf16 = 160;
constexpr int kMaxHeadDimF32 = 512;

// dK, dV (and with DQ, dQ added into the zeroed f32 dq_acc) for every dtype
// and head dim the kernels take; cudaErrorInvalidValue otherwise.
template <bool DQ>
cudaError_t run_kv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, float* dq_acc, void* dk, void* dv, int bh, int sq, int sk,
                   int d, float scale, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int vec = vec_ok(d, q, k, v, dout);
#define SIDLSG_KV_CASE(DP) \
  if (d <= DP)             \
    return launch_kv_bf16<DP, DQ>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq, sk, d, scale, vec, st);
    SIDLSG_KV_CASE(16)
    SIDLSG_KV_CASE(32)
    SIDLSG_KV_CASE(48)
    SIDLSG_KV_CASE(64)
    SIDLSG_KV_CASE(80)
    SIDLSG_KV_CASE(160)
#undef SIDLSG_KV_CASE
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
#define SIDLSG_KV_F32(TL, NJ) \
  launch_kv_f32<TL, NJ, DQ>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq, sk, d, scale, st)
    if (d <= 32) return SIDLSG_KV_F32(TileF32, 8);
    if (d <= 64) return SIDLSG_KV_F32(TileF32, 16);
    if (d <= 160) return SIDLSG_KV_F32(TileF32, 40);
    if (d <= kMaxHeadDimF32) return SIDLSG_KV_F32(TileF16, 32);
#undef SIDLSG_KV_F32
  }
  return cudaErrorInvalidValue;
}

inline bool shape_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh > 0 && sq > 0 && sk > 0 && d > 0 &&
         ((dtype == 0 && d <= kMaxHeadDimF32) || (dtype == 1 && d <= kMaxHeadDimBf16));
}

}  // namespace
