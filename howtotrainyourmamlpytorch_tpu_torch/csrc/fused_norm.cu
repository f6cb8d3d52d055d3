// Fused batch norm (batch statistics) + LeakyReLU for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py that the one-level
// op fused_bn_leaky_relu reaches:
//
//   bn_stats           <- _fwd_kernel (:93, statistics half), _stats_block_kernel (:183)
//   bn_act_apply       <- _fwd_kernel (:93, apply half),      _apply_block_kernel (:194)
//   bn_act_bwd_reduce  <- _bwd_kernel (:113, reduce half),    _bwd_stats_block_kernel (:206)
//   bn_act_bwd_apply   <- _bwd_kernel (:113, apply half),     _bwd_apply_block_kernel (:226)
//
// The TPU kernels see the activation as a padded (R, C) matrix, R = N*H*W,
// after an NCHW -> NHWC transpose. These kernels read the NCHW tensor in
// place: channel c is N contiguous runs of H*W floats. No transpose and no
// padding, so any N, H, W (odd stages such as 3x3 included) is taken as is.
//
// Bound. Every kernel is a streaming pass that does a few flops per element,
// far below the card's ratio of flops to bytes, so memory bounds each: in
// float32, bn_stats reads 4*R*C bytes, bn_act_apply moves 8*R*C (x in, y
// out), bn_act_bwd_reduce 8*R*C (x and the cotangent in), bn_act_bwd_apply
// 12*R*C. At the flagship shapes (a few MB per tensor) the launch itself
// costs more than the traffic. Design: each element is read once per
// kernel, consecutive threads read consecutive addresses, and the grid is
// sized from the SM count; nothing here is tuned yet.
//
// Determinism. The reductions use no float atomics. bn_stats and
// bn_act_bwd_reduce split each channel's rows over `splits` blocks (more
// blocks than channels where the channel count would leave SMs idle), each
// block writes its partial sums, and a second kernel adds the partials of
// a channel in a fixed order. Warp shuffles and the shared-memory tree add
// in a fixed order too, so the same input gives the same bits run to run.
//
// Variance. Shifted single pass: every thread accumulates (x - K) and
// (x - K)^2 with K the channel's first element, and var = E[(x-K)^2] -
// E[x-K]^2, clamped at 0. With K inside the channel's range the shifted sums
// do not cancel the way the TPU kernels' E[x^2] - mean^2 can when |mean|
// is large against the spread.
//
// Each C entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

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

// grid (C, splits): shifted partial sums of one channel's row range.
__global__ void bn_stats_partial_kernel(const float* __restrict__ x,
                                        float* __restrict__ partials, int N,
                                        int C, int HW, int splits) {
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const long long rows = (long long)N * HW;
  long long begin, end;
  split_range(rows, splits, s, &begin, &end);
  const float shift = x[(long long)c * HW];
  float s1 = 0.0f, s2 = 0.0f;
  for (long long r = begin + threadIdx.x; r < end; r += kThreads) {
    const float v = x[nchw_offset(r, c, C, HW)] - shift;
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    partials[2 * ((long long)c * splits + s)] = s1;
    partials[2 * ((long long)c * splits + s) + 1] = s2;
  }
}

// One thread per channel: partials in split order -> mean, biased var.
__global__ void bn_stats_finalize_kernel(const float* __restrict__ x,
                                         const float* __restrict__ partials,
                                         float* __restrict__ mean,
                                         float* __restrict__ var, int N, int C,
                                         int HW, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int s = 0; s < splits; ++s) {
    s1 += partials[2 * ((long long)c * splits + s)];
    s2 += partials[2 * ((long long)c * splits + s) + 1];
  }
  const float inv_n = 1.0f / (float)((long long)N * HW);
  const float m = s1 * inv_n;
  mean[c] = x[(long long)c * HW] + m;
  var[c] = fmaxf(s2 * inv_n - m * m, 0.0f);
}

// Elementwise over the NCHW tensor (grid-stride): normalize, affine,
// LeakyReLU with the positive branch at pre >= 0.
__global__ void bn_act_apply_kernel(const float* __restrict__ x,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ var,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    float* __restrict__ y, long long total,
                                    int C, int HW, float eps, float slope) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int c = (int)((e / HW) % C);
    const float inv = rsqrtf(var[c] + eps);
    const float pre = (x[e] - mean[c]) * inv * gamma[c] + beta[c];
    y[e] = pre >= 0.0f ? pre : slope * pre;
  }
}

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

int finalize_blocks(int C) { return (C + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// mean, var: (C,). partials: (C, splits, 2) scratch.
int bn_stats(const float* x, float* mean, float* var, float* partials, int N,
             int C, int HW, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_stats_partial_kernel<<<dim3(C, splits), kThreads, 0, st>>>(x, partials, N,
                                                               C, HW, splits);
  bn_stats_finalize_kernel<<<finalize_blocks(C), kThreads, 0, st>>>(
      x, partials, mean, var, N, C, HW, splits);
  return (int)cudaGetLastError();
}

int bn_act_apply(const float* x, const float* mean, const float* var,
                 const float* gamma, const float* beta, float* y, int N, int C,
                 int HW, float eps, float slope, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * C * HW;
  bn_act_apply_kernel<<<blocks, kThreads, 0, st>>>(x, mean, var, gamma, beta, y,
                                                   total, C, HW, eps, slope);
  return (int)cudaGetLastError();
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

}  // extern "C"
