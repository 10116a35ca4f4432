// K8: one-launch GroupNorm(+SiLU) for Hopper (sm_90a).
//
// Replaces _gn_silu_pallas_fwd in sid_lsg_tpu/ops/groupnorm.py, the
// single-block TPU kernel: group statistics and the normalise(+SiLU) pass
// over one VMEM-resident sample.  Same function as the plain reference
// group_norm_ref (_group_norm_ref in the JAX package): per (sample, group)
// f32 mean and rstd = 1/sqrt(max(E[x^2] - E[x]^2, 0) + eps), then
// x * scale_c + bias_c (+SiLU) folded as K3 folds it (gn_common.cuh).
//
// What bounds it on the H100: one read and one write of every activation
// against a handful of f32 operations per element, so device-memory bytes.
// K2 + K3 read x twice and launch three kernels (the parent's K2 had two);
// this kernel reads it once and launches once.
//
// Design.  In NCHW each (sample, group) is one contiguous span of cg*H*W
// elements.  One thread-block cluster takes one span, split in `cluster`
// slices of `chunk` elements (a multiple of 16 bytes, so every slice starts
// on a 16-byte boundary relative to its span):
// 1. each block copies its slice into shared memory once, as 16 KB bulk
//    copies (cp.async.bulk) each completing on its own mbarrier, so the sums
//    of the first pieces overlap the arrival of the later ones; where the
//    slice's address is not 16-byte aligned (a view with a storage offset),
//    or for the last bytes that are no whole 16, plain loads fill it;
// 2. each block sums x and x^2 in f32 (threads, then warps, then the block)
//    and stores its pair into slot [its rank] of every block of the
//    cluster (distributed shared memory), between two cluster barriers;
//    every block then adds the slots in rank order, so all blocks hold the
//    same mean and rstd;
// 3. each block folds them with gamma and beta into scale and bias of the
//    channels its slice touches, and writes act(x * scale + bias) from
//    shared memory with 16-byte stores (plain stores where the output slice
//    is not aligned or H*W is no multiple of the vector).
// A group's statistics need the whole group read before any of it is
// written, so a map read in one wave is read, then written: the time is
// about the reads, then the writes, plus some 5 us of launch, load latency
// and cluster barriers, which is all there is at the 8x8-16x16 maps.
//
// The cluster size is the wrapper's choice (ops/groupnorm.py:gn_plan), a
// power of two 1..16, tuned with scripts/torch_gn_sweep.py (one H100 80GB
// HBM3 at 700 W; device time of one call, inputs warm in L2; bf16 at batch
// 4 unless named):
//   span   map                 K8 by cluster 1/2/4/8/16 (us)       K2 + K3
//   5 KB   1280x8x8            5.67/5.25/5.90/8.86/13.98            13.53
//   40 KB  2560x16x16          11.84/9.34/9.81/11.56/15.65          20.64
//   80 KB  320x64x64           18.92/13.67/14.52/15.01/19.16        14.54
//   160 KB 640x64x64           36.94/26.72/28.44/27.24/29.79        24.63
//   240 KB 960x64x64           -/59.51/48.21/39.80/39.37            35.08
//   256 KB 512x64x64 f32       -/47.27/39.19/34.26/35.00            37.30
//   512 KB 512x128x128         -/-/138.58/79.55/73.92               79.60
//   1 MB   256x256x256         -/-/-/250.16/151.96                  149.64
// Two blocks a span are best while the whole map fits the card's shared
// memory in one wave (up to about 24 MB; gn_plan takes more blocks only
// where a slice would pass 96 KB, at batch 1-2); beyond it, slices of at
// most 32 KB (8 or 16 blocks), so that several blocks share an SM and one's
// writes overlap another's reads.  With L2 flushed before each call K8
// beats K2 + K3 at every span up to 512 KB (at 640x64x64: 31.97 against
// 39.06 us), since K3 reads x again from device memory; warm, K3's second
// read hits L2 and K2 + K3 win at the 160-240 KB spans of batch 4 by
// 8-12%.  K8 keeps those too: one launch instead of two halves the host's
// work for them, and every path is paced by the host.  Spans above 512 KB
// go to K2 + K3.

#include <limits.h>

#include <algorithm>

#include "gn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GF_THREADS = 256;
constexpr int GF_PIECE = 16384;       // bytes per bulk copy
constexpr int GF_MAX_PIECES = 15;     // 15 pieces cover the largest slice
constexpr int GF_MAX_CLUSTER = 16;
constexpr int GF_MAX_SMEM = 227 * 1024 - 1024;  // dynamic shared memory (static takes < 1 KB)

__host__ __device__ constexpr long long round16(long long b) { return (b + 15) / 16 * 16; }

// grid: groups_total * cluster blocks, in clusters of `cluster` along x.
// Dynamic shared memory: the slice (chunk elements, padded to 16 bytes), then
// (scale, bias) of each channel the slice touches.
template <typename T>
__global__ void __launch_bounds__(GF_THREADS)
gn_fused_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                const float* __restrict__ beta, int groups, int cg, int hw, int span, int chunk,
                float eps, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[GF_MAX_PIECES];
  __shared__ float2 parts[GF_MAX_CLUSTER];
  __shared__ float2 red[GF_THREADS / 32];
  __shared__ float2 stats;

  hopper::cluster_arrive_relaxed();  // waited on before the first store into another block
  const int tid = threadIdx.x;
  const int rank = hopper::cluster_rank(), cl = hopper::cluster_size();
  const long long g = blockIdx.x / cl;
  const int beg = rank * chunk;
  const int n = max(0, min(span, beg + chunk) - beg);
  const T* xs = x + g * span + beg;
  T* ys = y + g * span + beg;
  T* buf = reinterpret_cast<T*>(smem);
  float2* tab = reinterpret_cast<float2*>(smem + round16((long long)chunk * sizeof(T)));

  // 1. The slice into shared memory.
  const bool aligned = (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  const int body = aligned ? (n * int(sizeof(T))) & ~15 : 0;  // bytes by bulk copy
  const int pieces = (body + GF_PIECE - 1) / GF_PIECE;
  if (tid == 0 && pieces) {
    for (int p = 0; p < pieces; ++p) hopper::mbar_init(hopper::smem_u32(&bars[p]), 1);
    hopper::mbar_fence_init();
    for (int p = 0; p < pieces; ++p) {
      const int off = p * GF_PIECE, bytes = min(GF_PIECE, body - off);
      const uint32_t bar = hopper::smem_u32(&bars[p]);
      hopper::mbar_arrive_tx(bar, bytes);
      hopper::bulk_load(hopper::smem_u32(smem + off), reinterpret_cast<const unsigned char*>(xs) + off,
                        bytes, bar);
    }
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits on them

  // 2. Sums: the plain-loaded part as it is loaded, the bulk pieces as they land.
  float s = 0.f, ss = 0.f;
  for (int i = body / int(sizeof(T)) + tid; i < n; i += GF_THREADS) {
    const T v = xs[i];
    buf[i] = v;
    const float f = gn::to_f32(v);
    s += f;
    ss += f * f;
  }
  const uint4* vbuf = reinterpret_cast<const uint4*>(smem);
  for (int p = 0; p < pieces; ++p) {
    hopper::mbar_wait(hopper::smem_u32(&bars[p]), 0);
    const int v1 = min(body, (p + 1) * GF_PIECE) / 16;
    for (int v = p * (GF_PIECE / 16) + tid; v < v1; v += GF_THREADS) gn::add16(vbuf[v], s, ss, buf);
  }
  const float2 mine = gn::block_sum2<GF_THREADS>(s, ss, red);
  hopper::cluster_wait();  // every block of the cluster has started
  if (tid < 32) {
    const float a = __shfl_sync(0xffffffffu, mine.x, 0), b = __shfl_sync(0xffffffffu, mine.y, 0);
    if (tid < cl) hopper::st_cluster_f32x2(hopper::smem_u32(&parts[rank]), tid, a, b);
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();  // every block's pair is in `parts`; no block reads another's memory after this
  if (tid == 0) {
    float S = 0.f, SS = 0.f;
    for (int r = 0; r < cl; ++r) {
      S += parts[r].x;
      SS += parts[r].y;
    }
    stats = gn::moments(S, SS, float(span), eps);
  }
  __syncthreads();

  // 3. Scale and bias of the channels [c_lo, c_lo + nch) of the group that
  // the slice touches, then the output.
  if (n == 0) return;
  const int c_lo = beg / hw, nch = (beg + n - 1) / hw - c_lo + 1;
  const int c_abs = int(g % groups) * cg + c_lo;
  for (int j = tid; j < nch; j += GF_THREADS) {
    const float ga = gamma[c_abs + j];
    const float sc = stats.y * ga;
    tab[j] = make_float2(sc, beta[c_abs + j] - (stats.x * stats.y) * ga);
  }
  __syncthreads();
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(ys) & 15) == 0 && hw % VEC == 0) {
    const int nv = n / VEC;
    uint4* vy = reinterpret_cast<uint4*>(ys);
    for (int v = tid; v < nv; v += GF_THREADS) {
      const float2 sb = tab[(beg + v * VEC) / hw - c_lo];
      vy[v] = gn::apply16(vbuf[v], sb.x, sb.y, silu, buf);
    }
    done = nv * VEC;
  }
  for (int i = done + tid; i < n; i += GF_THREADS) {
    const float2 sb = tab[(beg + i) / hw - c_lo];
    gn::store(ys + i, gn::act(gn::to_f32(buf[i]) * sb.x + sb.y, silu));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* gamma, const float* beta, int n, int c,
                   int groups, long long hw, int cluster, float eps, int silu, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int cg = c / groups;
  const long long span = cg * hw;
  long long chunk = (span + cluster - 1) / cluster;
  chunk = (chunk + VEC - 1) / VEC * VEC;
  const long long nch = std::min<long long>(cg, chunk / hw + 2);
  const long long smem = round16(chunk * sizeof(T)) + nch * 8;
  if (span > INT_MAX || smem > GF_MAX_SMEM || (long long)n * groups * cluster > INT_MAX)
    return cudaErrorInvalidValue;
  static const cudaError_t prepared = gn::prepare_cluster_kernel(
      reinterpret_cast<const void*>(gn_fused_kernel<T>), GF_MAX_SMEM);
  if (prepared != cudaSuccess) return prepared;
  return gn::launch_clusters(gn_fused_kernel<T>, n * groups * cluster, GF_THREADS, cluster,
                             size_t(smem), st, static_cast<const T*>(x), static_cast<T*>(y), gamma,
                             beta, groups, cg, int(hw), int(span), int(chunk), eps, silu);
}

}  // namespace

extern "C" {

// x, y: (n, c, hw) contiguous in the activation dtype; gamma, beta: f32 (c,).
// One cluster of `cluster` blocks (a power of two, 1..16) per (sample,
// group).  dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t
// (cudaErrorInvalidValue where a block's slice does not fit its shared
// memory).
int sidlsg_gn_fused(const void* x, void* y, const void* gamma, const void* beta, int n, int c,
                    int groups, long long hw, int cluster, float eps, int silu, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || hw <= 0 || hw > INT_MAX ||
      cluster < 1 || cluster > GF_MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0) return launch<float>(x, y, ga, be, n, c, groups, hw, cluster, eps, silu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, ga, be, n, c, groups, hw, cluster, eps, silu, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
