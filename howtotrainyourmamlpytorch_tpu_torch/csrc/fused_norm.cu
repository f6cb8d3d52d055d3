// Fused batch norm (batch statistics) + LeakyReLU for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py, all nine:
//
//   bn_stats_act       <- _fwd_kernel (:93), _stats_block_kernel (:183) +
//                         _apply_block_kernel (:194)
//   bn_stats           <- _fwd_pool_kernel (:147, statistics half),
//                         _stats_pool_block_kernel (:248)
//   bn_act_bwd         <- _bwd_kernel (:113), _bwd_stats_block_kernel (:206) +
//                         _bwd_apply_block_kernel (:226)
//   bn_act_pool_apply  <- _fwd_pool_kernel (:147, apply half), _apply_pool_block_kernel (:267)
//
// bn_stats and bn_stats_act are the two instances of one forward template,
// bn_fwd_kernel<kApply>: per-channel (mean, biased var), and with kApply the
// normalized, affine, LeakyReLU activation as well, in one launch. The
// pooled TPU kernels take the four strided views of the 2x2 windows;
// together those views are the whole pre-pool activation, so their
// statistics are bn_stats of x itself, and bn_act_pool_apply reads each
// window from NCHW and writes only the pooled (N, C, H/2, W/2) activation.
// bn_act_bwd (bn_bwd_kernel) is the backward through the batch statistics
// and the LeakyReLU mask, in one launch: per channel dbeta = sum dpre and
// dgamma = sum dpre * xhat, and dx = inv * (gamma * dpre - gamma * dbeta / n
// - xhat * gamma * dgamma / n), with dpre = g where pre >= 0, slope * g
// elsewhere.
//
// The TPU kernels see the activation as a padded (R, C) matrix, R = N*H*W,
// after an NCHW -> NHWC transpose. These kernels read the NCHW tensor in
// place: channel c is N contiguous runs of H*W floats. No transpose and no
// padding, so any N, H, W (odd stages such as 3x3 included) is taken as is.
//
// Bound. Every kernel is a streaming pass at a few flops per element, far
// below the card's ratio of flops to bytes, so memory bounds each: in
// float32, bn_stats reads 4*R*C bytes, bn_stats_act moves 8*R*C (x in, y
// out), bn_act_bwd 12*R*C (x and the cotangent in, dx out),
// bn_act_pool_apply 5*R*C (x in, the pooled quarter out); in bfloat16 half
// of each. There is no product anywhere, so tensor cores play no part. At
// the flagship shapes (a few MB per tensor) the launch itself costs more
// than the traffic.
//
// Element types. Every kernel is a template on the type T of x, y, g and
// dx: float, or __nv_bfloat16 under --compute_dtype bfloat16 (the Pallas
// bodies load any dtype and store y and dx in the input's, :96, :108,
// :118-119). The statistics, gamma, beta, dgamma and dbeta are float in
// both, every reduction and every elementwise step runs in float, and y and
// dx are rounded once, on the store. A staged slice is float in both: a
// bfloat16 element is widened as it is staged (through registers, as no
// cp.async converts), so the plan's staged bytes a row are the same for
// both types. A four-element move is a float4 or 8 bytes of bfloat16.
//
// The design, forward and backward alike. On the TPU, _fwd_kernel and
// _bwd_kernel keep the channel resident in VMEM and reduce and apply in one
// body. Hopper's counterpart is a thread-block cluster: the grid runs over
// channels, and each channel is reduced by one cluster of k blocks (k in 1,
// 2, 4, 8, 16; 16 is non-portable and opted into at load time). Each block
// stages its slice of the channel (the channel's N runs of H*W floats, cut
// in k) in shared memory: x for the forward, x and the cotangent g for the
// backward. Every thread starts a cp.async for each element it owns, 16
// bytes at a time where a run is 16-byte aligned (H*W % 4 == 0), 4 bytes at
// the 7x7, 3x3 and 21x21 stages, so the whole slice is in flight at once.
// Threads own elements across run boundaries, so no lane idles at the end
// of a short run. (One thread starting a TMA bulk copy per run, the block
// summing each run as it landed, was slower on an H100 at the 28x28 and
// 42x42 stages and no faster for bn_stats_act at 84x84; PERF.md has the
// numbers.)
//
// With the slice on chip each block reduces it, and the blocks of a cluster
// push their partial pairs into every peer's shared memory (distributed
// shared memory, map_shared_rank); each block combines the k pairs in rank
// order, so each holds bitwise the same totals. That is one cluster barrier
// per launch. Each barrier holds every block of the cluster, shared memory
// and all, until the slowest arrives; a cluster-wide second pass (a second
// exchange) and a barrier before exit (for peers that read remotely) made
// an earlier form of the forward slower at the north-star shapes. Then
// each block writes its own slice of the output from the staged data: the
// input is read from device memory once, so the traffic is the byte bound
// above. One launch per call: no scratch in device memory, no second
// kernel, no float atomics; at the flagship shapes the launch floor, not
// the traffic, sets the time, so each launch saved counts.
//
// - Forward: each block computes its variance in two passes, its slice's
//   mean first and then sum (x - m)^2 from shared memory, and combines the
//   cluster's (sum, sum of squares about m) pairs by the pairwise form of
//   two-pass (Chan, Golub and LeVeque: M2 = sum of M2_q + n_q (m_q -
//   mean)^2); with k 1 it is plain two-pass, as the plain version and
//   jnp.var.
// - Backward: each block computes xhat, pre and dpre from the staged x and g
//   and sums (dpre, dpre * xhat); the cluster's sum is (dbeta, dgamma). pre
//   is recomputed with the plain version's roundings, (x - mean) * inv then
//   * gamma + beta, each rounded on its own (no fused multiply-add), so the
//   LeakyReLU branch at pre within rounding of 0 is the one plain_bwd takes.
//
// Where a channel is small (N*H*W <= 2048 rows, the 14x14, 7x7 and 3x3
// stages) one warp takes a channel and a block several channels, so threads
// do not sit idle. Where a channel does not fit the cluster's shared memory
// the same launch streams: the forward a shifted single pass over its slice
// (every thread sums (x - K) and (x - K)^2 with K the channel's first
// element; var = E[(x-K)^2] - E[x-K]^2 clamped at 0), the backward the same
// sums as staged, from device memory; then the slice is read again to
// apply. The plan (cluster size, channels per block, staged or streamed,
// shared memory) is chosen in Python (ops/fused_norm.py, _plan) from the
// shape, the staged bytes a row and the device, and passed in. A thread
// steps from run to run without dividing, so no element pays a division.
//
// Determinism. The reductions use no float atomics. Warp shuffles, the
// shared-memory tree and the cluster's rank-order combination add in a
// fixed order. The same input gives the same bits run to run, and bn_stats
// and bn_stats_act the same statistics.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns the launch's cudaError_t (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// Helpers of the cluster kernels
// ---------------------------------------------------------------------------

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

// What one thread group (a warp, or the block) of one block covers: rows
// [begin, end) of channel c, `per` rows a block of the cluster's k.
struct Slice {
  int k, rank, lanes, group, t, c, rows, per, begin, end;
  bool active;  // c < C: the last block of warps may hold fewer channels
};

// The kernel's first call. With k > 1 it arrives on the cluster barrier,
// which push_to_cluster waits on before it writes into a peer.
// grid: C*k blocks in clusters of k (cpb == 1), or ceil(C/cpb) blocks of
// cpb warps, a warp a channel (k == 1).
__device__ __forceinline__ Slice slice_of(const cg::cluster_group& cluster,
                                          int cpb, int N, int C, int HW) {
  Slice s;
  s.k = (int)cluster.num_blocks();
  if (s.k > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  s.rank = (int)cluster.block_rank();
  s.lanes = blockDim.x / cpb;
  s.group = threadIdx.x / s.lanes;
  s.t = threadIdx.x - s.group * s.lanes;
  s.c = s.k > 1 ? blockIdx.x / s.k : blockIdx.x * cpb + s.group;
  s.active = s.c < C;
  s.rows = N * HW;
  s.per = (((s.rows + s.k - 1) / s.k) + 3) & ~3;
  s.begin = s.active ? min(s.rows, s.rank * s.per) : 0;
  s.end = s.active ? min(s.rows, s.begin + s.per) : 0;
  return s;
}

// Calls f(o, e) for the elements of the slice that thread s.t of its group
// owns: float4 (vec) or float number begin + w*t, begin + w*(t + lanes), ...
// with w = 4 or 1, at offset o in the staged slice and e in the tensors.
// Rows run on across the channel's runs: the run n and the place i in it
// are stepped without a division, and a float4 never straddles two runs
// (H*W % 4 == 0).
template <typename F>
__device__ __forceinline__ void for_own(const Slice& s, int C, int HW, bool vec,
                                        F f) {
  const int w = vec ? 4 : 1;
  int r = s.begin + w * s.t;
  if (r >= s.end) return;
  const int step = w * s.lanes;
  int n = r / HW;
  int i = r - n * HW;
  const int dn = step / HW;
  const int di = step - dn * HW;
  for (; r < s.end; r += step) {
    f(r - s.begin, ((long long)n * C + s.c) * HW + i);
    i += di;
    n += dn;
    if (i >= HW) {
      i -= HW;
      ++n;
    }
  }
}

// Element I/O. x, y, g and dx are float or __nv_bfloat16 (the learner's
// compute dtype); everything on chip is float: a bfloat16 element is widened
// on load and rounded once, to nearest even, on store. "vec" moves four
// elements at once (a float4, or four bfloat16 as 8 bytes), else one.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p) : make_float4(*p, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (!vec) return make_float4(__bfloat162float(*p), 0.f, 0.f, 0.f);
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    *p = v.x;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, bool vec) {
  if (!vec) {
    *p = __float2bfloat16_rn(v.x);
    return;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One float4 (vec) or float at src into the float slice at dst: cp.async
// for float; bfloat16 is widened through registers (there is no converting
// cp.async), so the staged slice is float whatever the input's type and the
// plan's bytes a row hold for both. Either way each thread later reads
// back only what it wrote itself.
__device__ __forceinline__ void stage(float* dst, const float* src, bool vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool vec) {
  store4(dst, load4(src, vec), vec);
}

// Whether p is aligned for a four-element move of T.
template <typename T>
__device__ __forceinline__ bool aligned_vec(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
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
// the others before it exits. slice_of arrived on the cluster barrier;
// waiting on it here makes sure every peer has started before its shared
// memory is written.
__device__ __forceinline__ void push_to_cluster(cg::cluster_group& cluster,
                                                float2 mine, float2* peers,
                                                int rank, int k) {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if ((int)threadIdx.x < k) {
    *cluster.map_shared_rank(peers + rank, (int)threadIdx.x) = mine;
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The forward: bn_stats and bn_stats_act
// ---------------------------------------------------------------------------

template <typename T>
struct FwdArgs {
  const T* x;
  const float* gamma;
  const float* beta;
  T* y;
  float* mean;
  float* var;
  int N, C, HW;
  int cpb;     // channels per block: blockDim.x / cpb threads reduce one
  int staged;  // 1: slice staged in shared memory; 0: streamed
  float eps, slope;
};

// Dynamic shared memory: cpb slices of `per` floats when staged, none when
// streamed.
template <bool kApply, typename T>
__global__ void __launch_bounds__(kThreads) bn_fwd_kernel(FwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kWarps];
  __shared__ float2 peers[16];  // each rank's partial pair, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  const Slice s = slice_of(cluster, a.cpb, a.N, a.C, a.HW);
  const int k = s.k, rows = s.rows, per = s.per, lanes = s.lanes;
  const bool vec =
      (a.HW & 3) == 0 && aligned_vec<T>(a.x) && (!kApply || aligned_vec<T>(a.y));
  float* buf = reinterpret_cast<float*>(smem4) + s.group * per;

  float mean, var;
  if (a.staged) {
    // Pass 1: stage the slice and sum it. Each thread copies the elements
    // it owns with cp.async, waits for its own copies and sums them.
    float s1 = 0.0f;
    for_own(s, a.C, a.HW, vec, [&](int o, long long e) { stage(buf + o, a.x + e, vec); });
    cp_async_wait_all();
    for_own(s, a.C, a.HW, vec,
            [&](int o, long long) { s1 += sum4(load4(buf + o, vec), 0.0f, vec); });
    // Pass 2, from shared memory: sum (x - m)^2 about the slice's own mean
    // m. Each thread reads back only the elements it copied.
    const int cnt = s.end - s.begin;
    const float sum = group_sum(s1, 0, lanes, red);
    const float m = cnt > 0 ? sum / (float)cnt : 0.0f;
    float s2 = 0.0f;
    for_own(s, a.C, a.HW, vec,
            [&](int o, long long) { s2 += sq4(load4(buf + o, vec), m, vec); });
    const float m2 = group_sum(s2, 1, lanes, red);
    // The cluster's slices, in rank order: mean = sum / rows and var =
    // (sum over slices of m2 + cnt * (m - mean)^2) / rows, the pairwise
    // form of two-pass (Chan, Golub and LeVeque), exactly two-pass for k 1.
    if (k > 1) {
      push_to_cluster(cluster, make_float2(sum, m2), peers, s.rank, k);
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
    const float shift = s.active ? load4(a.x + (long long)s.c * a.HW, false).x : 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
    for_own(s, a.C, a.HW, vec, [&](int, long long e) {
      const float4 v = load4(a.x + e, vec);
      s1 += sum4(v, shift, vec);
      s2 += sq4(v, shift, vec);
    });
    const float2 mine = make_float2(group_sum(s1, 0, lanes, red),
                                    group_sum(s2, 1, lanes, red));
    float2 tot = mine;
    if (k > 1) {
      push_to_cluster(cluster, mine, peers, s.rank, k);
      tot = peers[0];
      for (int q = 1; q < k; ++q) tot = make_float2(tot.x + peers[q].x, tot.y + peers[q].y);
    }
    const float inv_rows = 1.0f / (float)rows;
    const float m = tot.x * inv_rows;
    mean = shift + m;
    var = fmaxf(tot.y * inv_rows - m * m, 0.0f);
  }
  if (s.active && s.rank == 0 && s.t == 0) {
    a.mean[s.c] = mean;
    a.var[s.c] = var;
  }
  if (kApply && s.active) {
    const float scale = rsqrtf(var + a.eps) * a.gamma[s.c];
    const float shift = a.beta[s.c];
    const float slope = a.slope;
    auto act = [&](float v) {
      const float pre = fmaf(v - mean, scale, shift);
      return pre >= 0.0f ? pre : slope * pre;
    };
    for_own(s, a.C, a.HW, vec, [&](int o, long long e) {
      const float4 v = a.staged ? load4(buf + o, vec) : load4(a.x + e, vec);
      store4(a.y + e, make_float4(act(v.x), act(v.y), act(v.z), act(v.w)), vec);
    });
  }
}

// ---------------------------------------------------------------------------
// The backward: bn_act_bwd
// ---------------------------------------------------------------------------

template <typename T>
struct BwdArgs {
  const T* x;
  const T* g;  // the cotangent of y
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  T* dx;
  float* dgamma;
  float* dbeta;
  int N, C, HW;
  int cpb, staged;  // as in FwdArgs
  float eps, slope;
};

// Dynamic shared memory: for each of the cpb channels, its slice of x then
// its slice of g, `per` floats each, when staged; none when streamed.
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_bwd_kernel(BwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kWarps];
  __shared__ float2 peers[16];  // each rank's (sum dpre, sum dpre * xhat)
  cg::cluster_group cluster = cg::this_cluster();
  const Slice s = slice_of(cluster, a.cpb, a.N, a.C, a.HW);
  const bool vec = (a.HW & 3) == 0 && aligned_vec<T>(a.x) && aligned_vec<T>(a.g) &&
                   aligned_vec<T>(a.dx);
  float* xs = reinterpret_cast<float*>(smem4) + 2 * s.group * s.per;
  float* gs = xs + s.per;
  const int c = s.active ? s.c : 0;
  const float mean = a.mean[c];
  const float inv = rsqrtf(a.var[c] + a.eps);
  const float gamma = a.gamma[c];
  const float beta = a.beta[c];
  const float slope = a.slope;
  // xhat and dpre of one element, each product and sum rounded on its own,
  // as the plain version's tensor ops round them.
  auto xhat_of = [&](float x) { return __fmul_rn(__fsub_rn(x, mean), inv); };
  auto dpre_of = [&](float xh, float g) {
    const float pre = __fadd_rn(__fmul_rn(xh, gamma), beta);
    return pre >= 0.0f ? g : __fmul_rn(slope, g);
  };
  auto x_at = [&](int o, long long e) {
    return a.staged ? load4(xs + o, vec) : load4(a.x + e, vec);
  };
  auto g_at = [&](int o, long long e) {
    return a.staged ? load4(gs + o, vec) : load4(a.g + e, vec);
  };

  if (a.staged) {
    for_own(s, a.C, a.HW, vec, [&](int o, long long e) {
      stage(xs + o, a.x + e, vec);
      stage(gs + o, a.g + e, vec);
    });
    cp_async_wait_all();  // each thread reads back only what it copied
  }
  float s1 = 0.0f, s2 = 0.0f;
  auto add = [&](float x, float g) {
    const float xh = xhat_of(x);
    const float d = dpre_of(xh, g);
    s1 += d;
    s2 = fmaf(d, xh, s2);
  };
  for_own(s, a.C, a.HW, vec, [&](int o, long long e) {
    const float4 x = x_at(o, e), g = g_at(o, e);
    add(x.x, g.x);
    if (vec) {
      add(x.y, g.y);
      add(x.z, g.z);
      add(x.w, g.w);
    }
  });
  float2 tot = make_float2(group_sum(s1, 0, s.lanes, red), group_sum(s2, 1, s.lanes, red));
  if (s.k > 1) {
    push_to_cluster(cluster, tot, peers, s.rank, s.k);
    tot = peers[0];
    for (int q = 1; q < s.k; ++q) tot = make_float2(tot.x + peers[q].x, tot.y + peers[q].y);
  }
  if (!s.active) return;
  if (s.rank == 0 && s.t == 0) {
    a.dbeta[c] = tot.x;
    a.dgamma[c] = tot.y;
  }
  const float inv_n = 1.0f / (float)s.rows;
  const float c1 = inv_n * gamma * tot.x;
  const float c2 = inv_n * gamma * tot.y;
  auto dx_of = [&](float x, float g) {
    const float xh = xhat_of(x);
    return inv * (dpre_of(xh, g) * gamma - c1 - xh * c2);
  };
  for_own(s, a.C, a.HW, vec, [&](int o, long long e) {
    const float4 x = x_at(o, e), g = g_at(o, e);
    store4(a.dx + e,
           make_float4(dx_of(x.x, g.x), dx_of(x.y, g.y), dx_of(x.z, g.z), dx_of(x.w, g.w)),
           vec);
  });
}

cudaLaunchConfig_t plan_config(int cluster, int threads, int blocks, int smem,
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

template <typename Args>
int launch_planned(void (*kernel)(Args), const Args& a, int cluster, int threads,
                   int blocks, int smem, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan_config(
      cluster, threads, blocks, smem, static_cast<cudaStream_t>(stream), &attr);
  // The launch's own error: a refused configuration is reported here, and
  // no earlier call's error is taken for this launch's.
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

// The planned kernels, in the order of `kernel` in bn_fwd_active_clusters:
// bn_stats, bn_stats_act, bn_act_bwd on float, then on bfloat16.
const void* const kPlanned[6] = {
    (const void*)bn_fwd_kernel<false, float>, (const void*)bn_fwd_kernel<true, float>,
    (const void*)bn_bwd_kernel<float>,        (const void*)bn_fwd_kernel<false, __nv_bfloat16>,
    (const void*)bn_fwd_kernel<true, __nv_bfloat16>, (const void*)bn_bwd_kernel<__nv_bfloat16>};

// ---------------------------------------------------------------------------
// Pooled apply
// ---------------------------------------------------------------------------

// Elementwise over the pooled (N, C, H/2, W/2) output (grid-stride): each
// thread reads its 2x2 window straight from the NCHW input as two pairs
// (float2, or two bfloat16 as 4 bytes), normalizes, applies the affine and
// LeakyReLU per element with plain_apply's arithmetic in float, and writes
// the window's max, rounded once to T. The full-size activation is never
// written. H and W are even, so every window's first element sits at an
// even offset and both pair loads are aligned.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void bn_act_pool_apply_kernel(const T* __restrict__ x,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         T* __restrict__ y, long long total,
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
    const float2 top = load2(x + base);
    const float2 bot = load2(x + base + W);
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
    store1(y + e, best);
  }
}

// The C entries' bodies, one instance per element type.
template <typename T>
int stats_entry(const T* x, float* mean, float* var, int N, int C, int HW, int cluster,
                int cpb, int staged, int threads, int blocks, int smem, void* stream) {
  const FwdArgs<T> a{x, nullptr, nullptr, nullptr, mean, var, N, C, HW, cpb, staged,
                     0.0f, 0.0f};
  return launch_planned(bn_fwd_kernel<false, T>, a, cluster, threads, blocks, smem, stream);
}

template <typename T>
int stats_act_entry(const T* x, const float* gamma, const float* beta, T* y, float* mean,
                    float* var, int N, int C, int HW, float eps, float slope, int cluster,
                    int cpb, int staged, int threads, int blocks, int smem, void* stream) {
  const FwdArgs<T> a{x, gamma, beta, y, mean, var, N, C, HW, cpb, staged, eps, slope};
  return launch_planned(bn_fwd_kernel<true, T>, a, cluster, threads, blocks, smem, stream);
}

template <typename T>
int bwd_entry(const T* x, const T* g, const float* mean, const float* var,
              const float* gamma, const float* beta, T* dx, float* dgamma, float* dbeta,
              int N, int C, int HW, float eps, float slope, int cluster, int cpb,
              int staged, int threads, int blocks, int smem, void* stream) {
  const BwdArgs<T> a{x, g, mean, var, gamma, beta, dx, dgamma, dbeta,
                     N, C, HW, cpb, staged, eps, slope};
  return launch_planned(bn_bwd_kernel<T>, a, cluster, threads, blocks, smem, stream);
}

template <typename T>
int pool_entry(const T* x, const float* mean, const float* var, const float* gamma,
               const float* beta, T* y, int N, int C, int H, int W, float eps, float slope,
               int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * C * (H / 2) * (W / 2);
  bn_act_pool_apply_kernel<T><<<blocks, kThreads, 0, st>>>(
      x, mean, var, gamma, beta, y, total, C, H, W, eps, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once, after loading: the SM count and the largest dynamic shared memory a
// planned block may take (the opt-in limit less the kernels' static shared
// memory), which the six planned kernels (both forward instances and the
// backward, on float and on bfloat16) are set to accept, with non-portable cluster sizes (16)
// allowed. The plans are made from these.
int bn_fwd_setup(int* sm_count, int* max_dynamic_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  int optin = 0;
  if (!err) err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int most_static = 0;
  for (const void* k : kPlanned) {
    cudaFuncAttributes fa;
    if (!err) err = cudaFuncGetAttributes(&fa, k);
    if (!err && (int)fa.sharedSizeBytes > most_static) most_static = (int)fa.sharedSizeBytes;
  }
  if (err) return (int)err;
  *max_dynamic_smem = optin - most_static;
  for (const void* k : kPlanned) {
    if (!err) err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         *max_dynamic_smem);
    if (!err) err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return (int)err;
}

// How many clusters of a plan the card can hold at once (0: it cannot run).
// kernel: 0 bn_stats, 1 bn_stats_act, 2 bn_act_bwd on float; 3-5 the same on
// bfloat16.
int bn_fwd_active_clusters(int kernel, int cluster, int threads, int smem,
                           int* active) {
  if (kernel < 0 || kernel > 5) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = plan_config(cluster, threads, cluster, smem, nullptr, &attr);
  cfg.numAttrs = 1;  // the query needs the cluster size, 1 included
  return (int)cudaOccupancyMaxActiveClusters(active, kPlanned[kernel], &cfg);
}

// The kernels' entries: x, y, g and dx float (no suffix) or bfloat16
// (`_bf16`, passed as its 16-bit storage); mean, var, gamma, beta, dgamma and
// dbeta always float. The plan (cluster, cpb, staged, threads, blocks, smem)
// comes from _plan in ops/fused_norm.py.
#define BN_ENTRIES(SUFFIX, T)                                                        \
  /* mean, var: (C,). */                                                            \
  int bn_stats##SUFFIX(const T* x, float* mean, float* var, int N, int C, int HW,   \
                       int cluster, int cpb, int staged, int threads, int blocks,   \
                       int smem, void* stream) {                                    \
    return stats_entry(x, mean, var, N, C, HW, cluster, cpb, staged, threads,       \
                       blocks, smem, stream);                                       \
  }                                                                                 \
  /* y: like x; mean, var: (C,). The same plan and statistics as bn_stats. */       \
  int bn_stats_act##SUFFIX(const T* x, const float* gamma, const float* beta, T* y, \
                           float* mean, float* var, int N, int C, int HW,           \
                           float eps, float slope, int cluster, int cpb,            \
                           int staged, int threads, int blocks, int smem,           \
                           void* stream) {                                          \
    return stats_act_entry(x, gamma, beta, y, mean, var, N, C, HW, eps, slope,      \
                           cluster, cpb, staged, threads, blocks, smem, stream);    \
  }                                                                                 \
  /* dx: like x; dgamma, dbeta: (C,). g is the cotangent of y, mean and var the     \
     forward's statistics. The plan is the backward's (8 staged bytes a row). */    \
  int bn_act_bwd##SUFFIX(const T* x, const T* g, const float* mean,                 \
                         const float* var, const float* gamma, const float* beta,   \
                         T* dx, float* dgamma, float* dbeta, int N, int C, int HW,  \
                         float eps, float slope, int cluster, int cpb, int staged,  \
                         int threads, int blocks, int smem, void* stream) {         \
    return bwd_entry(x, g, mean, var, gamma, beta, dx, dgamma, dbeta, N, C, HW,     \
                     eps, slope, cluster, cpb, staged, threads, blocks, smem,       \
                     stream);                                                       \
  }                                                                                 \
  /* y: (N, C, H/2, W/2); H and W even, x aligned for a pair (checked by the        \
     caller). */                                                                    \
  int bn_act_pool_apply##SUFFIX(const T* x, const float* mean, const float* var,    \
                                const float* gamma, const float* beta, T* y, int N, \
                                int C, int H, int W, float eps, float slope,        \
                                int blocks, void* stream) {                         \
    return pool_entry(x, mean, var, gamma, beta, y, N, C, H, W, eps, slope, blocks, \
                      stream);                                                      \
  }

BN_ENTRIES(, float)
BN_ENTRIES(_bf16, __nv_bfloat16)

#undef BN_ENTRIES

}  // extern "C"
