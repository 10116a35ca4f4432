// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sid_lsg_tpu/ops/attention.py:_flash_fwd (the
// pl.pallas_call of its online-softmax loop).  Same function: non-causal
// softmax(q k^T * scale) v over (BH, S, D) tensors, plus the f32 row
// logsumexp, with the ragged tails of S_q and S_k masked in the kernel.
//
// What bounds it on the H100: at the UNet's self-attention (S = 4096/1024,
// D = 40/80) the two products are 4*S_q*S_k*D operations against
// (S_q + 2*S_k)*D*2 bytes, far above the card's ~295 operations per byte, so
// the tensor cores bound it.  At cross-attention (S_k = 77) the products are
// small and the bytes of q and out bound it.  The VAE's single head (D = 512)
// runs in f32, where the tensor cores offer only TF32, so it is bounded by
// the f32 rate of the CUDA cores.
//
// What the design does about that:
// - bf16: one block of 4 warps per (bh, 64-row q-tile); each warp owns 16 q
//   rows.  The block walks the k-tiles (64 keys) in a loop that takes the
//   place of the TPU's sequential grid axis.  Q K^T and P V run on the tensor
//   cores as mma.sync m16n8k16 (bf16 in, f32 accumulate).  Scores, the
//   online-softmax state and the output accumulator stay in registers in the
//   mma fragment layout: a row's max and sum need two shuffles, and the
//   score fragments become the A operand of P V without passing through
//   shared memory.  K/V tiles arrive by 16-byte cp.async into two buffers,
//   so the next tile streams in while the current one computes.  Nothing of
//   size S_q x S_k reaches device memory.
// - f32: one block of 8 warps per (bh, 32-row q-tile); each warp owns four q
//   rows and each lane one key of the 32-key tile.  Q and K are read from
//   shared memory 16 bytes at a time (K rows padded so a quarter-warp hits
//   distinct banks), P is broadcast by shuffles, and the accumulator
//   (D <= 512) sits in registers.  The tiles take up to 194 KB of dynamic
//   shared memory, set with cudaFuncSetAttribute, which leaves room for one
//   buffer: tiles arrive by 16-byte cp.async, all in flight at once.
// TMA, wgmma and warp specialisation are not used yet; that is work for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------- bf16 path

constexpr int MB_BQ = 64;
constexpr int MB_BK = 64;
constexpr int MB_THREADS = 128;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Q tile, then two K and two V tiles: the next k-tile streams in while the
// current one computes.
inline size_t mb_smem_bytes(int dp) { return size_t(5) * MB_BQ * (dp + 8) * sizeof(bf16); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + 64) of a (rows_total, d) bf16 matrix into
// shared memory with row stride DP + 8; rows past the end and columns in
// [d, DP) are 0.  With vec (d % 8 == 0, 16-byte aligned source) the rows move
// as 16-byte cp.async copies that complete at the next cp_async_wait;
// otherwise element by element.
template <int DP>
__device__ void load_tile_bf16(bf16* dst, const bf16* src, int row0, int rows_total, int d,
                               bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < MB_BK * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      bf16* to = dst + r * LD + c;
      if (row0 + r < rows_total && c < d)
        cp_async16(to, src + size_t(row0 + r) * d + c);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < MB_BK * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < rows_total && c < d) val = src[size_t(row0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

// DP: head dim rounded up to a multiple of 16 (zero columns beyond d).
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A registers
// hold rows g and g+8 at columns 2t, 2t+1 (+8); B registers hold k rows 2t,
// 2t+1 (+8) of column g; C holds rows g (c0, c1) and g+8 (c2, c3) at columns
// 2t, 2t+1.
template <int DP>
__global__ void __launch_bounds__(MB_THREADS)
flash_fwd_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                   int sq, int sk, int d, float scale, int vec) {
  constexpr int LD = DP + 8;  // padded row stride: the fragment loads hit distinct banks
  constexpr int NT = DP / 8;  // n8 tiles of the output
  constexpr int KS = DP / 16; // k16 steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + MB_BQ * LD;      // two buffers
  bf16* Vs = Ks + 2 * MB_BK * LD;  // two buffers

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * MB_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* kb = k + size_t(bh) * sk * d;
  const bf16* vb = v + size_t(bh) * sk * d;

  load_tile_bf16<DP>(Qs, q + size_t(bh) * sq * d, q0, sq, d, vec);
  load_tile_bf16<DP>(Ks, kb, 0, sk, d, vec);
  load_tile_bf16<DP>(Vs, vb, 0, sk, d, vec);
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // rows g and g+8 of this warp
  float l_a = 0.f, l_b = 0.f;          // this lane's share of the row sums

  const int ntiles = (sk + MB_BK - 1) / MB_BK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * MB_BK;
    const bf16* Kt = Ks + (it & 1) * MB_BK * LD;
    const bf16* Vt = Vs + (it & 1) * MB_BK * LD;
    if (it + 1 < ntiles) {  // the other buffer was released by the barrier ending it - 1
      load_tile_bf16<DP>(Ks + ((it + 1) & 1) * MB_BK * LD, kb, k0 + MB_BK, sk, d, vec);
      load_tile_bf16<DP>(Vs + ((it + 1) & 1) * MB_BK * LD, vb, k0 + MB_BK, sk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just started has landed
    __syncthreads();

    float s[MB_BK / 8][4];
#pragma unroll
    for (int j = 0; j < MB_BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bf16* qa = Qs + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < MB_BK / 8; ++j) {
        const bf16* kr = Kt + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < MB_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + e < sk;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        s[j][2 + e] = ok ? s[j][2 + e] * scale : kNegInf;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    uint32_t p[MB_BK / 16][4];  // P as the A operand of P V
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int j = 0; j < MB_BK / 8; ++j) {
      const float p0 = expf(s[j][0] - m_a), p1 = expf(s[j][1] - m_a);
      const float p2 = expf(s[j][2] - m_b), p3 = expf(s[j][3] - m_b);
      ls_a += p0 + p1;
      ls_b += p2 + p3;
      p[j / 2][(j % 2) * 2] = pack2(p0, p1);
      p[j / 2][(j % 2) * 2 + 1] = pack2(p2, p3);
    }
    l_a = l_a * al_a + ls_a;
    l_b = l_b * al_b + ls_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }
#pragma unroll
    for (int kk = 0; kk < MB_BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* vr = Vt + (kk * 16 + 2 * t) * LD + n * 8 + g;
        mma_bf16_16816(o[n], p[kk], pack2(vr[0], vr[LD]), pack2(vr[8 * LD], vr[9 * LD]));
      }
    }
    __syncthreads();  // this buffer is refilled at it + 2
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const int ra = q0 + wr + g, rb = ra + 8;
  bf16* ob = out + size_t(bh) * sq * d;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t + e;
      if (col < d) {
        if (ra < sq) ob[size_t(ra) * d + col] = __float2bfloat16(o[n][e] / l_a);
        if (rb < sq) ob[size_t(rb) * d + col] = __float2bfloat16(o[n][2 + e] / l_b);
      }
    }
  }
  if (t == 0) {
    if (ra < sq) lse[size_t(bh) * sq + ra] = m_a + logf(l_a);
    if (rb < sq) lse[size_t(bh) * sq + rb] = m_b + logf(l_b);
  }
}

template <int DP>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int bh,
                        int sq, int sk, int d, float scale, int vec, cudaStream_t stream) {
  const size_t smem = mb_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_mma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + MB_BQ - 1) / MB_BQ, bh);
  flash_fwd_bf16_mma<DP><<<grid, MB_THREADS, smem, stream>>>(q, k, v, out, lse, sq, sk, d, scale,
                                                             vec);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int SF_BQ = 32;
constexpr int SF_BK = 32;
constexpr int SF_THREADS = 256;
constexpr int SF_ROWS = SF_BQ / (SF_THREADS / 32);  // q rows per warp

inline int round4(int x) { return (x + 3) / 4 * 4; }

inline size_t sf_smem_bytes(int d) {
  const int d4 = round4(d);
  return sizeof(float) * (size_t(SF_BQ) * d4 + size_t(SF_BK) * (d4 + 4) + size_t(SF_BK) * d4);
}

// Rows [row0, row0 + nrows) of a (rows_total, d) f32 matrix into shared
// memory with row stride ld, zero past the end and in columns [d, round4(d)).
// With vec (d % 4 == 0, 16-byte aligned source) each warp moves whole rows as
// 16-byte cp.async copies, which complete at the next cp_async_wait.
__device__ void load_tile_f32(float* dst, int ld, const float* src, int row0, int rows_total,
                              int nrows, int d, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  if (vec) {
    for (int r = warp; r < nrows; r += nwarps) {
      const bool ok = row0 + r < rows_total;
      for (int c = lane * 4; c < d; c += 128) {
        if (ok)
          cp_async16(dst + r * ld + c, src + size_t(row0 + r) * d + c);
        else
          *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const int d4 = (d + 3) / 4 * 4;
    for (int r = warp; r < nrows; r += nwarps)
      for (int c = lane; c < d4; c += 32)
        dst[r * ld + c] = (row0 + r < rows_total && c < d) ? src[size_t(row0 + r) * d + c] : 0.f;
  }
}

template <int NJ>  // head dim d <= 32 * NJ
__global__ void __launch_bounds__(SF_THREADS)
flash_fwd_f32_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                   int sq, int sk, int d, float scale, int vec) {
  extern __shared__ __align__(16) float fsm[];
  const int d4 = (d + 3) / 4 * 4;  // Q/V row stride, zero columns beyond d
  const int ldk = d4 + 4;          // K row stride: a quarter-warp's float4 loads hit distinct banks
  float* Qs = fsm;
  float* Ks = Qs + SF_BQ * d4;
  float* Vs = Ks + SF_BK * ldk;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * SF_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * SF_ROWS;  // this warp's first q row in the tile
  const float* qb = q + size_t(bh) * sq * d;
  const float* kb = k + size_t(bh) * sk * d;
  const float* vb = v + size_t(bh) * sk * d;

  load_tile_f32(Qs, d4, qb, q0, sq, SF_BQ, d, vec);
  float acc[SF_ROWS][NJ];
  float m[SF_ROWS], l[SF_ROWS];
#pragma unroll
  for (int i = 0; i < SF_ROWS; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += SF_BK) {
    __syncthreads();  // previous tile consumed
    load_tile_f32(Ks, ldk, kb, k0, sk, SF_BK, d, vec);
    load_tile_f32(Vs, d4, vb, k0, sk, SF_BK, d, vec);
    cp_async_commit();
    cp_async_wait<0>();  // this tile (and Q on the first pass) has landed
    __syncthreads();

    float s[SF_ROWS];
#pragma unroll
    for (int i = 0; i < SF_ROWS; ++i) s[i] = 0.f;
    const float* kr = Ks + lane * ldk;
    for (int c = 0; c < d4; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int i = 0; i < SF_ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + i) * d4 + c);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const bool valid = k0 + lane < sk;
    float p[SF_ROWS];
#pragma unroll
    for (int i = 0; i < SF_ROWS; ++i) {
      const float si = valid ? s[i] * scale : kNegInf;
      const float mn = fmaxf(m[i], warp_max(si));
      const float al = expf(m[i] - mn);
      p[i] = expf(si - mn);
      float ps = p[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * al + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < SF_BK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        vv[j] = col < d4 ? Vs[c * d4 + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SF_ROWS; ++i) {
        const float pc = __shfl_sync(0xffffffffu, p[i], c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

  float* ob = out + size_t(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < SF_ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col < d) ob[size_t(row) * d + col] = acc[i][j] / l[i];
    }
    if (lane == 0) lse[size_t(bh) * sq + row] = m[i] + logf(l[i]);
  }
}

template <int NJ>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* out, float* lse,
                       int bh, int sq, int sk, int d, float scale, int vec, cudaStream_t stream) {
  const size_t smem = sf_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_simt<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + SF_BQ - 1) / SF_BQ, bh);
  flash_fwd_f32_simt<NJ><<<grid, SF_THREADS, smem, stream>>>(q, k, v, out, lse, sq, sk, d, scale,
                                                             vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (bh, sq, d), k/v: (bh, sk, d), out: (bh, sq, d) in the input dtype, lse:
// (bh, sq) f32, all contiguous.  dtype: 0 = f32, 1 = bf16.  Returns a
// cudaError_t; cudaErrorInvalidValue for a shape or dtype the kernel does not
// take (bf16 with d > 160, f32 with d > 512).  The bf16 head dims are built
// for the presets' heads (16 and 32 tiny, 40/80/160 SD1.5, 64 SD2.1-base);
// another d pads up to the next built one.
int sidlsg_flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int sq, int sk, int d, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0) return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (dtype == 1) {
    const bf16* qh = static_cast<const bf16*>(q);
    const bf16* kh = static_cast<const bf16*>(k);
    const bf16* vh = static_cast<const bf16*>(v);
    bf16* oh = static_cast<bf16*>(out);
    float* lf = static_cast<float*>(lse);
    const int vec = (d % 8 == 0) && (addr % 16 == 0);
#define SIDLSG_BF16_CASE(DP) \
  if (d <= DP) return launch_bf16<DP>(qh, kh, vh, oh, lf, bh, sq, sk, d, scale, vec, st);
    SIDLSG_BF16_CASE(16)
    SIDLSG_BF16_CASE(32)
    SIDLSG_BF16_CASE(48)
    SIDLSG_BF16_CASE(64)
    SIDLSG_BF16_CASE(80)
    SIDLSG_BF16_CASE(160)
#undef SIDLSG_BF16_CASE
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    if (sf_smem_bytes(d) > size_t(kMaxSmem)) return cudaErrorInvalidValue;
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    float* lf = static_cast<float*>(lse);
    const int vec = (d % 4 == 0) && (addr % 16 == 0);
    if (d <= 64) return launch_f32<2>(qf, kf, vf, of, lf, bh, sq, sk, d, scale, vec, st);
    if (d <= 128) return launch_f32<4>(qf, kf, vf, of, lf, bh, sq, sk, d, scale, vec, st);
    if (d <= 256) return launch_f32<8>(qf, kf, vf, of, lf, bh, sq, sk, d, scale, vec, st);
    if (d <= 512) return launch_f32<16>(qf, kf, vf, of, lf, bh, sq, sk, d, scale, vec, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
