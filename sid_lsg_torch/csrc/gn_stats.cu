// K2: GroupNorm statistics for Hopper (sm_90a), one launch.
//
// Replaces the reduce pass of _gn_tiled_pallas_fwd in
// sid_lsg_tpu/ops/groupnorm.py, for the maps that K8 (gn_fused.cu) leaves
// to K2 + K3: the VAE decoder's 256x256 and 512x512 maps, whose group spans
// (1-4 MB in bf16) outgrow a cluster's shared memory.  Same function as the
// plain reference _group_norm_ref: per (sample, group) f32 mean and
// rstd = 1/sqrt(max(E[x^2] - E[x]^2, 0) + eps).  The clamp at 0 follows the
// reference; the Pallas kernels leave it out.
//
// In NCHW each (sample, group) is one contiguous span of cg*H*W elements,
// so any channel count that the group count divides is taken (the TPU
// kernels' C % 128 lane rule does not apply here).
//
// What bounds it on the H100: it reads every activation once and does three
// f32 operations per element, far below the card's ~295 operations per
// byte, so device-memory bytes.  The design keeps bytes in flight and
// launches once:
// - one thread-block cluster per span, of `cluster` blocks (a power of two,
//   1..16, the wrapper's choice: about 128 KB of the span per block); each
//   block loops over its share with four independent 16-byte loads a thread
//   in flight (plain loads where the share is not 16-byte aligned);
// - the blocks' (sum, sum of squares) pairs meet in block 0's shared memory
//   (distributed shared memory, between two cluster barriers), which adds
//   them in rank order and writes mean and rstd: no scratch buffer, no
//   second kernel.
// At the VAE's 512x512 maps (batch 4: 128 spans of 1M elements) that is 128
// clusters of 16 blocks of 256 threads: 2048 blocks, of which 8 fit an SM
// by threads, so the whole card streams in two waves with 64 KB in flight
// per SM.

#include <limits.h>

#include "gn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GS_THREADS = 256;
constexpr int GS_UNROLL = 4;
constexpr int GS_MAX_CLUSTER = 16;

// grid: groups_total * cluster blocks, in clusters of `cluster` along x.
// Block `rank` of the cluster of span g reduces elements
// [rank * chunk, min(span, (rank + 1) * chunk)) of it.
template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ rstd,
                long long span, long long chunk, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float2 parts[GS_MAX_CLUSTER];
  __shared__ float2 red[GS_THREADS / 32];

  hopper::cluster_arrive_relaxed();  // waited on before the store into block 0
  const int tid = threadIdx.x;
  const int rank = hopper::cluster_rank(), cl = hopper::cluster_size();
  const long long g = blockIdx.x / cl;
  const long long beg = rank * chunk, end = beg + chunk < span ? beg + chunk : span;
  const T* p = x + g * span;
  float s[GS_UNROLL] = {}, ss[GS_UNROLL] = {};
  long long tail = beg;
  if (beg < end && (reinterpret_cast<uintptr_t>(p + beg) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p + beg);
    const long long nv = (end - beg) / VEC;
    long long k = tid;
    for (; k + (GS_UNROLL - 1) * GS_THREADS < nv; k += GS_UNROLL * GS_THREADS) {
      uint4 r[GS_UNROLL];
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u) r[u] = v[k + u * GS_THREADS];
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u) gn::add16(r[u], s[u], ss[u], p);
    }
    for (; k < nv; k += GS_THREADS) gn::add16(v[k], s[0], ss[0], p);
    tail = beg + nv * VEC;
  }
  for (long long i = tail + tid; i < end; i += GS_THREADS) {
    const float f = gn::to_f32(p[i]);
    s[0] += f;
    ss[0] += f * f;
  }
  const float2 mine = gn::block_sum2<GS_THREADS>((s[0] + s[1]) + (s[2] + s[3]),
                                                 (ss[0] + ss[1]) + (ss[2] + ss[3]), red);
  hopper::cluster_wait();  // every block of the cluster has started
  if (tid == 0) hopper::st_cluster_f32x2(hopper::smem_u32(&parts[rank]), 0, mine.x, mine.y);
  hopper::cluster_arrive();
  hopper::cluster_wait();  // block 0 holds every pair
  if (rank == 0 && tid == 0) {
    float S = 0.f, SS = 0.f;
    for (int r = 0; r < cl; ++r) {
      S += parts[r].x;
      SS += parts[r].y;
    }
    const float2 m = gn::moments(S, SS, float(span), eps);
    mean[g] = m.x;
    rstd[g] = m.y;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* mean, float* rstd, int groups_total, long long span,
                   int cluster, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  long long chunk = (span + cluster - 1) / cluster;
  chunk = (chunk + VEC - 1) / VEC * VEC;  // every block's share starts on a 16-byte boundary
  if ((long long)groups_total * cluster > INT_MAX) return cudaErrorInvalidValue;
  static const cudaError_t prepared =
      gn::prepare_cluster_kernel(reinterpret_cast<const void*>(gn_stats_kernel<T>), 0);
  if (prepared != cudaSuccess) return prepared;
  return gn::launch_clusters(gn_stats_kernel<T>, groups_total * cluster, GS_THREADS, cluster, 0, st,
                             static_cast<const T*>(x), mean, rstd, span, chunk, eps);
}

}  // namespace

extern "C" {

// x: groups_total contiguous spans of `span` elements (NCHW viewed as
// (N*G, cg*H*W)).  mean, rstd: f32 (groups_total,).  One cluster of
// `cluster` blocks (a power of two, 1..16) per span.  dtype: 0 = f32,
// 1 = bf16.  Returns a cudaError_t.
int sidlsg_gn_stats_clustered(const void* x, void* mean, void* rstd, int groups_total,
                              long long span, int cluster, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups_total <= 0 || span <= 0 || cluster < 1 || cluster > GS_MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return launch<float>(x, m, r, groups_total, span, cluster, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, m, r, groups_total, span, cluster, eps, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
