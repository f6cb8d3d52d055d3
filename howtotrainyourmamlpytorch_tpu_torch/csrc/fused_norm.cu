// Fused batch norm (batch statistics) + LeakyReLU for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py, all nine:
//
//   bn_stats_act       <- _fwd_kernel (:93), _stats_block_kernel (:183) +
//                         _apply_block_kernel (:194)
//   bn_stats           <- _fwd_pool_kernel (:147, statistics half),
//                         _stats_pool_block_kernel (:248)
//   bn_act_bwd_reduce  <- _bwd_kernel (:113, reduce half),    _bwd_stats_block_kernel (:206)
//   bn_act_bwd_apply   <- _bwd_kernel (:113, apply half),     _bwd_apply_block_kernel (:226)
//   bn_act_pool_apply  <- _fwd_pool_kernel (:147, apply half), _apply_pool_block_kernel (:267)
//
// bn_stats and bn_stats_act are the two instances of one forward template,
// bn_fwd_kernel<kApply>: per-channel (mean, biased var), and with kApply the
// normalized, affine, LeakyReLU activation as well, in one launch. The
// pooled TPU kernels take the four strided views of the 2x2 windows;
// together those views are the whole pre-pool activation, so their
// statistics are bn_stats of x itself, and bn_act_pool_apply reads each
// window from NCHW and writes only the pooled (N, C, H/2, W/2) activation.
//
// The TPU kernels see the activation as a padded (R, C) matrix, R = N*H*W,
// after an NCHW -> NHWC transpose. These kernels read the NCHW tensor in
// place: channel c is N contiguous runs of H*W floats. No transpose and no
// padding, so any N, H, W (odd stages such as 3x3 included) is taken as is.
//
// Bound. Every kernel is a streaming pass at a few flops per element, far
// below the card's ratio of flops to bytes, so memory bounds each: in
// float32, bn_stats reads 4*R*C bytes, bn_stats_act moves 8*R*C (x in, y
// out), bn_act_bwd_reduce 8*R*C (x and the cotangent in), bn_act_bwd_apply
// 12*R*C, bn_act_pool_apply 5*R*C (x in, the pooled quarter out). There is
// no product anywhere, so tensor cores play no part. At the flagship shapes
// (a few MB per tensor) the launch itself costs more than the traffic.
//
// The forward's design. On the TPU, _fwd_kernel keeps x resident in VMEM
// and computes statistics and activation in one body. Hopper's counterpart
// is a thread-block cluster: the grid runs over channels, and each channel
// is reduced by one cluster of k blocks (k in 1, 2, 4, 8, 16; 16 is
// non-portable and opted into at load time). Each block stages its slice
// of the channel (the channel's N runs of H*W floats, cut in k) in shared
// memory: every thread starts a cp.async for each element it owns, 16
// bytes at a time where a run is 16-byte aligned (H*W % 4 == 0), 4 bytes
// at the 7x7, 3x3 and 21x21 stages, so the whole slice is in flight at
// once. Threads own elements across run boundaries, so no lane idles at
// the end of a short run. (One thread starting a TMA bulk copy per run,
// the block summing each run as it landed, was slower on an H100 at the
// 28x28 and 42x42 stages and no faster for bn_stats_act at 84x84; PERF.md
// has the numbers.)
//
// With the slice on chip each block computes its variance in two passes,
// its slice's mean first and then sum (x - m)^2 from shared memory, and
// bn_stats_act writes y from the same staged data: x is read from device
// memory once, so the traffic is the byte bound above. The blocks of a
// cluster then push their (sum, sum of squares about m) pairs into every
// peer's shared memory (distributed shared memory, map_shared_rank), and
// each block combines the k pairs in rank order by the pairwise form of
// two-pass (Chan, Golub and LeVeque: M2 = sum of M2_q + n_q (m_q - mean)^2),
// so each holds bitwise the same mean and variance; with k 1 it is plain
// two-pass, as the plain version and jnp.var. That is one cluster barrier
// per launch. Each barrier holds every block of the cluster, shared memory
// and all, until the slowest arrives; a cluster-wide second pass (a second
// exchange) and a barrier before exit (for peers that read remotely) made
// an earlier form of this kernel slower at the north-star shapes.
// One launch per call: no scratch in device memory, no second kernel, no
// float atomics, which is what the earlier split (partials, finalize,
// apply: three launches reading x twice) paid for at the launch floor.
//
// Where a channel is small (N*H*W <= 2048 rows, the 14x14, 7x7 and 3x3
// stages) one warp takes a channel and a block several channels, so threads
// do not sit idle. Where a channel does not fit the cluster's shared memory
// the same launch streams: a shifted single pass over its slice (every
// thread sums (x - K) and (x - K)^2 with K the channel's first element;
// var = E[(x-K)^2] - E[x-K]^2 clamped at 0), then the slice is read again
// to apply. The plan (cluster size, channels per block, staged or streamed,
// shared memory) is chosen in Python (ops/fused_norm.py, _fwd_plan) from
// the shape and the device, and passed in. A thread steps from run to run
// without dividing, so no element pays a division.
//
// Determinism. The reductions use no float atomics. Warp shuffles, the
// shared-memory tree and the cluster's rank-order combination add in a
// fixed order;
// bn_act_bwd_reduce splits each channel's rows over `splits` blocks, each
// block writes its partial sums, and a second kernel adds the partials of a
// channel in a fixed order. The same input gives the same bits run to run,
// and bn_stats and bn_stats_act the same statistics.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns the launch's cudaError_t (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sums a and b over the block; thread 0 holds the totals. Fixed order.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// Rows [begin, end) of channel c that split s of `splits` covers; a row is
// one of the channel's N*HW elements, numbered n*HW + i.
__device__ __forceinline__ void split_range(long long rows, int splits, int s,
                                            long long* begin, long long* end) {
  const long long per = (rows + splits - 1) / splits;
  *begin = per * s;
  *end = min(rows, *begin + per);
}

__device__ __forceinline__ long long nchw_offset(long long row, int c, int C,
                                                 int HW) {
  const long long n = row / HW;
  return (n * C + c) * HW + (row - n * HW);
}

// ---------------------------------------------------------------------------
// The forward: bn_stats and bn_stats_act
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* x;
  const float* gamma;
  const float* beta;
  float* y;
  float* mean;
  float* var;
  int N, C, HW;
  int cpb;     // channels per block: blockDim.x / cpb threads reduce one
  int staged;  // 1: slice staged in shared memory; 0: streamed
  float eps, slope;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Calls f(s, g) for the elements of the block's slice, rows [begin, end),
// that thread t of a `lanes`-thread group owns: float4 (vec) or float
// number begin + w*t, begin + w*(t + lanes), ... with w = 4 or 1, at offset
// s in the staged slice and g in x and y. Rows run on
// across the channel's runs: the run n and the place i in it are stepped
// without a division, and a float4 never straddles two runs (H*W % 4 == 0).
template <typename F>
__device__ __forceinline__ void for_own(const FwdArgs& a, int c, int begin,
                                        int end, bool vec, int t, int lanes,
                                        F f) {
  const int w = vec ? 4 : 1;
  int e = begin + w * t;
  if (e >= end) return;
  const int step = w * lanes;
  int n = e / a.HW;
  int i = e - n * a.HW;
  const int dn = step / a.HW;
  const int di = step - dn * a.HW;
  for (; e < end; e += step) {
    f(e - begin, ((long long)n * a.C + c) * a.HW + i);
    i += di;
    n += dn;
    if (i >= a.HW) {
      i -= a.HW;
      ++n;
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p) : make_float4(*p, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float sum4(float4 v, float m, bool vec) {
  return vec ? ((v.x - m) + (v.y - m)) + ((v.z - m) + (v.w - m)) : v.x - m;
}

__device__ __forceinline__ float sq4(float4 v, float m, bool vec) {
  const float a = v.x - m;
  if (!vec) return a * a;
  const float b = v.y - m, c = v.z - m, d = v.w - m;
  return fmaf(a, a, b * b) + fmaf(c, c, d * d);
}

__device__ __forceinline__ float warp_allsum(float v) {
  // Butterfly: lane l adds v and its partner's v, which the partner adds in
  // the other order; float addition commutes, so every lane ends bitwise
  // equal.
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v summed over the thread's group of `lanes` threads (a warp, or the
// block) in a fixed order; every thread of the group gets the same bits.
// `slot` keeps the scratch of successive calls apart, so no barrier is
// needed after a read.
__device__ __forceinline__ float group_sum(float v, int slot, int lanes,
                                           float (*red)[kWarps]) {
  v = warp_allsum(v);
  if (lanes > 32) {
    if ((threadIdx.x & 31) == 0) red[slot][threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[slot][0];
    for (int w = 1; w < (lanes >> 5); ++w) v += red[slot][w];
  }
  return v;
}

// Writes this block's pair into slot `rank` of every block of the cluster
// (distributed shared memory), then waits until every block has written:
// after it each block reads only its own `peers`, so none has to wait for
// the others before it exits. The kernel's first instruction arrived on the
// cluster barrier; waiting on it here makes sure every peer has started
// before its shared memory is written.
__device__ __forceinline__ void push_to_cluster(cg::cluster_group& cluster,
                                                float2 mine, float2* peers,
                                                int rank, int k) {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if ((int)threadIdx.x < k) {
    *cluster.map_shared_rank(peers + rank, (int)threadIdx.x) = mine;
  }
  cluster.sync();
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// grid: C*k blocks in clusters of k (cpb == 1), or ceil(C/cpb) blocks of
// cpb warps, a warp a channel (k == 1). Dynamic shared memory: cpb slices
// of `per` floats when staged, none when streamed.
template <bool kApply>
__global__ void __launch_bounds__(kThreads) bn_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kWarps];
  __shared__ float2 peers[16];  // each rank's partial pair, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  if (k > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int lanes = blockDim.x / a.cpb;
  const int group = threadIdx.x / lanes;
  const int t = threadIdx.x - group * lanes;
  const int c = k > 1 ? blockIdx.x / k : blockIdx.x * a.cpb + group;
  const bool active = c < a.C;
  const int rows = a.N * a.HW;
  const int per = (((rows + k - 1) / k) + 3) & ~3;
  const int begin = active ? min(rows, rank * per) : 0;
  const int end = active ? min(rows, begin + per) : 0;
  const bool vec = (a.HW & 3) == 0 && aligned16(a.x) && (!kApply || aligned16(a.y));
  float* buf = reinterpret_cast<float*>(smem4) + group * per;

  float mean, var;
  if (a.staged) {
    // Pass 1: stage the slice and sum it. Each thread copies the elements
    // it owns with cp.async, waits for its own copies and sums them.
    float s1 = 0.0f;
    for_own(a, c, begin, end, vec, t, lanes, [&](int s, long long g) {
      if (vec) {
        cp_async16(buf + s, a.x + g);
      } else {
        cp_async4(buf + s, a.x + g);
      }
    });
    cp_async_wait_all();
    for_own(a, c, begin, end, vec, t, lanes,
            [&](int s, long long) { s1 += sum4(load4(buf + s, vec), 0.0f, vec); });
    // Pass 2, from shared memory: sum (x - m)^2 about the slice's own mean
    // m. Each thread reads back only the elements it copied.
    const int cnt = end - begin;
    const float sum = group_sum(s1, 0, lanes, red);
    const float m = cnt > 0 ? sum / (float)cnt : 0.0f;
    float s2 = 0.0f;
    for_own(a, c, begin, end, vec, t, lanes,
            [&](int s, long long) { s2 += sq4(load4(buf + s, vec), m, vec); });
    const float m2 = group_sum(s2, 1, lanes, red);
    // The cluster's slices, in rank order: mean = sum / rows and var =
    // (sum over slices of m2 + cnt * (m - mean)^2) / rows, the pairwise
    // form of two-pass (Chan, Golub and LeVeque), exactly two-pass for k 1.
    if (k > 1) {
      push_to_cluster(cluster, make_float2(sum, m2), peers, rank, k);
      float total = peers[0].x;
      for (int q = 1; q < k; ++q) total += peers[q].x;
      mean = total / (float)rows;
      float acc = 0.0f;
      for (int q = 0; q < k; ++q) {
        const int qb = min(rows, q * per);
        const int qn = min(rows, qb + per) - qb;
        const float qm = qn > 0 ? peers[q].x / (float)qn : 0.0f;
        const float d = qm - mean;
        acc += fmaf((float)qn * d, d, peers[q].y);
      }
      var = acc / (float)rows;
    } else {  // the slice is the channel: m is its mean
      mean = m;
      var = m2 / (float)rows;
    }
  } else {
    // Streamed: shifted single pass over the slice in device memory.
    const float shift = active ? a.x[(long long)c * a.HW] : 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
    for_own(a, c, begin, end, vec, t, lanes, [&](int, long long g) {
      const float4 v = load4(a.x + g, vec);
      s1 += sum4(v, shift, vec);
      s2 += sq4(v, shift, vec);
    });
    const float2 mine = make_float2(group_sum(s1, 0, lanes, red),
                                    group_sum(s2, 1, lanes, red));
    float2 tot = mine;
    if (k > 1) {
      push_to_cluster(cluster, mine, peers, rank, k);
      tot = peers[0];
      for (int q = 1; q < k; ++q) tot = make_float2(tot.x + peers[q].x, tot.y + peers[q].y);
    }
    const float inv_rows = 1.0f / (float)rows;
    const float m = tot.x * inv_rows;
    mean = shift + m;
    var = fmaxf(tot.y * inv_rows - m * m, 0.0f);
  }
  if (active && rank == 0 && t == 0) {
    a.mean[c] = mean;
    a.var[c] = var;
  }
  if (kApply && active) {
    const float scale = rsqrtf(var + a.eps) * a.gamma[c];
    const float shift = a.beta[c];
    const float slope = a.slope;
    auto act = [&](float v) {
      const float pre = fmaf(v - mean, scale, shift);
      return pre >= 0.0f ? pre : slope * pre;
    };
    for_own(a, c, begin, end, vec, t, lanes, [&](int s, long long g) {
      const float4 v = load4(a.staged ? buf + s : a.x + g, vec);
      if (vec) {
        *reinterpret_cast<float4*>(a.y + g) =
            make_float4(act(v.x), act(v.y), act(v.z), act(v.w));
      } else {
        a.y[g] = act(v.x);
      }
    });
  }
}

cudaLaunchConfig_t fwd_config(int cluster, int threads, int blocks, int smem,
                              cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  // A 1-block cluster is launched as a plain grid: each block is then its
  // own cluster, without the cluster scheduling a cluster launch pays for.
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

template <bool kApply>
int launch_fwd(const FwdArgs& a, int cluster, int threads, int blocks,
               int smem, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_config(
      cluster, threads, blocks, smem, static_cast<cudaStream_t>(stream), &attr);
  // The launch's own error: a refused configuration is reported here, and
  // no earlier call's error is taken for this launch's.
  return (int)cudaLaunchKernelEx(&cfg, bn_fwd_kernel<kApply>, a);
}

// ---------------------------------------------------------------------------
// Backward and pooled apply
// ---------------------------------------------------------------------------

// grid (C, splits): partial sums of dpre and dpre * xhat.
__global__ void bn_act_bwd_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ partials, int N, int C, int HW, int splits, float eps,
    float slope) {
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const long long rows = (long long)N * HW;
  long long begin, end;
  split_range(rows, splits, s, &begin, &end);
  const float m = mean[c];
  const float inv = rsqrtf(var[c] + eps);
  const float ga = gamma[c];
  const float be = beta[c];
  float s1 = 0.0f, s2 = 0.0f;
  for (long long r = begin + threadIdx.x; r < end; r += kThreads) {
    const long long e = nchw_offset(r, c, C, HW);
    const float xhat = (x[e] - m) * inv;
    const float pre = xhat * ga + be;
    const float d = pre >= 0.0f ? g[e] : slope * g[e];
    s1 += d;
    s2 = fmaf(d, xhat, s2);
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    partials[2 * ((long long)c * splits + s)] = s1;
    partials[2 * ((long long)c * splits + s) + 1] = s2;
  }
}

// One thread per channel: dbeta = sum dpre, dgamma = sum dpre * xhat.
__global__ void bn_act_bwd_finalize_kernel(const float* __restrict__ partials,
                                           float* __restrict__ dgamma,
                                           float* __restrict__ dbeta, int C,
                                           int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int s = 0; s < splits; ++s) {
    s1 += partials[2 * ((long long)c * splits + s)];
    s2 += partials[2 * ((long long)c * splits + s) + 1];
  }
  dbeta[c] = s1;
  dgamma[c] = s2;
}

// Elementwise: dx = inv * (gamma*dpre - gamma*s1/n - xhat*gamma*s2/n).
__global__ void bn_act_bwd_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ dgamma, const float* __restrict__ dbeta,
    float* __restrict__ dx, long long total, int N, int C, int HW, float eps,
    float slope) {
  const float inv_n = 1.0f / (float)((long long)N * HW);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int c = (int)((e / HW) % C);
    const float inv = rsqrtf(var[c] + eps);
    const float ga = gamma[c];
    const float xhat = (x[e] - mean[c]) * inv;
    const float pre = xhat * ga + beta[c];
    const float d = pre >= 0.0f ? g[e] : slope * g[e];
    dx[e] = inv * (d * ga - inv_n * ga * dbeta[c] - xhat * inv_n * ga * dgamma[c]);
  }
}

// Elementwise over the pooled (N, C, H/2, W/2) output (grid-stride): each
// thread reads its 2x2 window straight from the NCHW input as two float2
// rows, normalizes, applies the affine and LeakyReLU per element with
// plain_apply's arithmetic, and writes the window's max. The full-size activation is
// never written. H and W are even, so every window's first element sits at
// an even offset and both float2 loads are 8-byte aligned.
__global__ void bn_act_pool_apply_kernel(const float* __restrict__ x,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float* __restrict__ y, long long total,
                                         int C, int H, int W, float eps,
                                         float slope) {
  const int OH = H >> 1;
  const int OW = W >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int ow = (int)(e % OW);
    const long long t = e / OW;
    const int oh = (int)(t % OH);
    const long long nc = t / OH;
    const int c = (int)(nc % C);
    const long long base = nc * H * W + (long long)(2 * oh) * W + 2 * ow;
    const float2 top = *reinterpret_cast<const float2*>(x + base);
    const float2 bot = *reinterpret_cast<const float2*>(x + base + W);
    const float m = mean[c];
    const float inv = rsqrtf(var[c] + eps);
    const float ga = gamma[c];
    const float be = beta[c];
    const float v[4] = {top.x, top.y, bot.x, bot.y};
    float best = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pre = (v[k] - m) * inv * ga + be;
      const float act = pre >= 0.0f ? pre : slope * pre;
      best = k == 0 ? act : fmaxf(best, act);
    }
    y[e] = best;
  }
}

int finalize_blocks(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Once, after loading: the SM count and the largest dynamic shared memory a
// forward block may take (the opt-in limit less the kernel's static
// shared memory), which both forward instances are set to accept, with
// non-portable cluster sizes (16) allowed. The plan is made from these.
int bn_fwd_setup(int* sm_count, int* max_dynamic_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  int optin = 0;
  if (!err) err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa[2];
  if (!err) err = cudaFuncGetAttributes(&fa[0], bn_fwd_kernel<false>);
  if (!err) err = cudaFuncGetAttributes(&fa[1], bn_fwd_kernel<true>);
  if (err) return (int)err;
  *max_dynamic_smem = optin - (int)max(fa[0].sharedSizeBytes, fa[1].sharedSizeBytes);
  const void* kernels[2] = {(const void*)bn_fwd_kernel<false>,
                            (const void*)bn_fwd_kernel<true>};
  for (const void* k : kernels) {
    if (!err) err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         *max_dynamic_smem);
    if (!err) err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return (int)err;
}

// How many clusters of a plan the card can hold at once (0: it cannot run).
int bn_fwd_active_clusters(int apply, int cluster, int threads, int smem,
                           int* active) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fwd_config(cluster, threads, cluster, smem,
                                            nullptr, &attr);
  cfg.numAttrs = 1;  // the query needs the cluster size, 1 included
  const void* k = apply ? (const void*)bn_fwd_kernel<true>
                        : (const void*)bn_fwd_kernel<false>;
  return (int)cudaOccupancyMaxActiveClusters(active, k, &cfg);
}

// mean, var: (C,). The plan (cluster, cpb, staged, threads, blocks, smem)
// comes from _fwd_plan in ops/fused_norm.py.
int bn_stats(const float* x, float* mean, float* var, int N, int C, int HW,
             int cluster, int cpb, int staged, int threads, int blocks,
             int smem, void* stream) {
  const FwdArgs a{x, nullptr, nullptr, nullptr, mean, var, N, C, HW, cpb, staged,
                  0.0f, 0.0f};
  return launch_fwd<false>(a, cluster, threads, blocks, smem, stream);
}

// y: like x; mean, var: (C,). The same plan and statistics as bn_stats.
int bn_stats_act(const float* x, const float* gamma, const float* beta,
                 float* y, float* mean, float* var, int N, int C, int HW,
                 float eps, float slope, int cluster, int cpb, int staged,
                 int threads, int blocks, int smem, void* stream) {
  const FwdArgs a{x, gamma, beta, y, mean, var, N, C, HW, cpb, staged, eps, slope};
  return launch_fwd<true>(a, cluster, threads, blocks, smem, stream);
}

// dgamma, dbeta: (C,). partials: (C, splits, 2) scratch.
int bn_act_bwd_reduce(const float* x, const float* g, const float* mean,
                      const float* var, const float* gamma, const float* beta,
                      float* dgamma, float* dbeta, float* partials, int N, int C,
                      int HW, int splits, float eps, float slope,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_act_bwd_partial_kernel<<<dim3(C, splits), kThreads, 0, st>>>(
      x, g, mean, var, gamma, beta, partials, N, C, HW, splits, eps, slope);
  bn_act_bwd_finalize_kernel<<<finalize_blocks(C), kThreads, 0, st>>>(
      partials, dgamma, dbeta, C, splits);
  return (int)cudaGetLastError();
}

int bn_act_bwd_apply(const float* x, const float* g, const float* mean,
                     const float* var, const float* gamma, const float* beta,
                     const float* dgamma, const float* dbeta, float* dx, int N,
                     int C, int HW, float eps, float slope, int blocks,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * C * HW;
  bn_act_bwd_apply_kernel<<<blocks, kThreads, 0, st>>>(
      x, g, mean, var, gamma, beta, dgamma, dbeta, dx, total, N, C, HW, eps,
      slope);
  return (int)cudaGetLastError();
}

// y: (N, C, H/2, W/2); H and W even, x 8-byte aligned (checked by the caller).
int bn_act_pool_apply(const float* x, const float* mean, const float* var,
                      const float* gamma, const float* beta, float* y, int N,
                      int C, int H, int W, float eps, float slope, int blocks,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * C * (H / 2) * (W / 2);
  bn_act_pool_apply_kernel<<<blocks, kThreads, 0, st>>>(
      x, mean, var, gamma, beta, y, total, C, H, W, eps, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
