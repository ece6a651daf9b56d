// The diffusion decoder's masked GroupNorm chain, one launch a norm: the
// statistics of each (batch row, group) over the valid frames, the
// normalisation and per-channel affine, then optionally the FiLM
// `* (1 + scale) + shift` of a (B, 2C) pair and SiLU, with padded frames
// written as zero.
//
// It replaces no TPU kernel: the JAX package leaves GroupNorm to XLA. In
// the port's served diffusion forward each such norm was ~21 launches of
// PyTorch's elementwise and reduction kernels, most of them writing a full
// float32 (B, T, C) tensor, 46 norms a CFG step (models/blocks.py
// GroupNorm32, models/diffusion_decoder.py).
//
// Bound: bytes. x is read once and y written once; the statistics are a few
// float operations an element. Design: a group is 32 consecutive channels
// (64 bytes of bf16 a frame), four threads a frame, each a 16-byte vector
// of 8 channels. A (row, group) slice is one thread-block cluster of 8
// blocks of 128 threads that split its frames; each block keeps its piece
// in registers from the one read (512 blocks at B=2, up to six an SM:
// measured on the H100 against 256-thread blocks and clusters of 4, the
// shortest of them). Two exact passes over the registers, as the plain
// version: the masked sum and the valid count, then the centred squares;
// each block's partials go to its shared memory and every block adds the
// cluster's eight over distributed shared memory in rank order, so all
// agree on the statistics bit for bit. The apply step rounds where the
// plain chain's ops round: the normalised value to the output type, then
// `1 + scale`, the product and the sum each, and SiLU once.

#include <cooperative_groups.h>

#include "common.cuh"

namespace tt {
namespace {

namespace cg = cooperative_groups;

constexpr int kWidth = 32;                           // channels a group
constexpr int kVec = 8;                              // channels a thread
constexpr int kLanes = kWidth / kVec;                // threads a frame
constexpr int kThreads = 128;
constexpr int kFramesPerPass = kThreads / kLanes;    // 32
constexpr int kCluster = 8;                          // blocks a (row, group), the portable most
constexpr int kMaxPasses = 12;                       // frames a block <= 384
constexpr int kMinBlocks = 6;                        // an SM's blocks: at most 80 registers

struct Args {
  const bf16* x;          // (B, T, C)
  const bool* mask;       // (B, T)
  const float* weight;    // (C,)
  const float* bias;      // (C,)
  const bf16* film;       // (B, 2C): scale then shift; null for none
  void* out;              // (B, T, C)
  int T, C, frames;       // frames: each block's share of T
  float eps;
  int silu;
};

template <typename OutT>
__device__ __forceinline__ float round_out(float v);
template <>
__device__ __forceinline__ float round_out<bf16>(float v) { return round_bf16(v); }
template <>
__device__ __forceinline__ float round_out<float>(float v) { return v; }

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = o;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The sum over the cluster of each block's `slot` (thread 0 wrote it
// before the cluster barrier), added in rank order by lane 0 of warp 0:
// the same bits in every block. Ends with a block barrier.
__device__ __forceinline__ float cluster_total(cg::cluster_group& cluster, float* slot,
                                               float* result) {
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kCluster ? *cluster.map_shared_rank(slot, threadIdx.x) : 0.f;
#pragma unroll
    for (int o = kCluster / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) *result = v;
  }
  __syncthreads();
  return *result;
}

template <typename OutT, int PASSES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) group_norm_act_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float scratch[kThreads / 32];
  __shared__ float slots[3];      // this block's sum, count, centred squares
  __shared__ float totals[3];
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = a.C / kWidth;
  const int slice = blockIdx.x / kCluster;
  const int b = slice / groups;
  const int c0 = (slice % groups) * kWidth + (threadIdx.x % kLanes) * kVec;
  const int t0 = rank * a.frames + threadIdx.x / kLanes;
  const int t_end = min(a.T, (rank + 1) * a.frames);
  const long long row = static_cast<long long>(b) * a.T;

  // the one read of x, and of the mask beside it
  uint4 raw[PASSES];
  bool valid[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int t = t0 + p * kFramesPerPass;
    raw[p] = make_uint4(0u, 0u, 0u, 0u);
    valid[p] = false;
    if (t < t_end) {
      raw[p] = __ldg(reinterpret_cast<const uint4*>(a.x + (row + t) * a.C + c0));
      valid[p] = a.mask[row + t];
    }
  }

  float s = 0.f, n = 0.f;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (!valid[p]) continue;
    float v[kVec];
    unpack8(raw[p], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += v[j];
    n += kVec;
  }
  s = block_sum<kThreads>(s, scratch);
  n = block_sum<kThreads>(n, scratch);
  if (threadIdx.x == 0) {
    slots[0] = s;
    slots[1] = n;
  }
  cluster.sync();
  const float count = cluster_total(cluster, &slots[1], &totals[1]);
  const float mean = cluster_total(cluster, &slots[0], &totals[0]) / count;

  float q = 0.f;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (!valid[p]) continue;
    float v[kVec];
    unpack8(raw[p], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = v[j] - mean;
      q = fmaf(d, d, q);
    }
  }
  q = block_sum<kThreads>(q, scratch);
  if (threadIdx.x == 0) slots[2] = q;
  cluster.sync();
  const float rstd = rsqrtf(cluster_total(cluster, &slots[2], &totals[2]) / count + a.eps);
  // no block leaves while another reads its slots: arrive now, wait last
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");

  float w[kVec], bias[kVec], scale1[kVec], shift[kVec];
  load8(a.weight + c0, w);
  load8(a.bias + c0, bias);
  if (a.film != nullptr) {
    const bf16* f = a.film + static_cast<long long>(b) * 2 * a.C + c0;
    unpack8(*reinterpret_cast<const uint4*>(f), scale1);
    unpack8(*reinterpret_cast<const uint4*>(f + a.C), shift);
#pragma unroll
    for (int j = 0; j < kVec; ++j) scale1[j] = round_bf16(1.f + scale1[j]);
  }
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int t = t0 + p * kFramesPerPass;
    if (t >= t_end) continue;
    float y[kVec];
    if (valid[p]) {
      float v[kVec];
      unpack8(raw[p], v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float h = __fmul_rn(__fsub_rn(v[j], mean), rstd);
        h = round_out<OutT>(__fadd_rn(__fmul_rn(h, w[j]), bias[j]));
        if (a.film != nullptr)
          h = round_out<OutT>(__fadd_rn(round_out<OutT>(__fmul_rn(h, scale1[j])), shift[j]));
        if (a.silu) h = round_out<OutT>(__fdiv_rn(h, 1.f + expf(-h)));
        y[j] = h;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) y[j] = 0.f;
    }
    store8(out + (row + t) * a.C + c0, y);
  }
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <typename OutT, int PASSES>
cudaError_t launch_passes(const Args& a, int B, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * (a.C / kWidth) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, group_norm_act_kernel<OutT, PASSES>, a);
}

// The kernel whose registers hold a block's share of the frames: the
// smallest built pass count that covers it. Fewer variants build faster
// (nvcc took 44 s for every count up to 16); a spare pass costs a
// predicate.
template <typename OutT>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  switch ((a.frames + kFramesPerPass - 1) / kFramesPerPass) {
    case 1: return launch_passes<OutT, 1>(a, B, s);
    case 2: return launch_passes<OutT, 2>(a, B, s);
    case 3: return launch_passes<OutT, 3>(a, B, s);
    case 4: return launch_passes<OutT, 4>(a, B, s);
    case 5: case 6: return launch_passes<OutT, 6>(a, B, s);
    case 7: case 8: return launch_passes<OutT, 8>(a, B, s);
    default: return launch_passes<OutT, kMaxPasses>(a, B, s);
  }
}

}  // namespace
}  // namespace tt

// x: (B, T, C) bf16, contiguous, 16-byte aligned; mask: (B, T) bool; weight,
// bias: (C,) float32; film: (B, 2C) bf16 or null; out: (B, T, C) bf16
// (out_f32 0) or float32 (1), contiguous. C a multiple of 32 (groups of 32
// channels), 1 <= T <= 3072. A row with no valid frame comes out zero.
// Returns the first CUDA error, 0 on success.
extern "C" int tt_group_norm_act(const void* x, const void* mask, const void* weight,
                                 const void* bias, const void* film, void* out, int out_f32,
                                 int B, int T, int C, float eps, int silu, void* stream) {
  using namespace tt;
  if (B < 1 || T < 1 || C < kWidth || C % kWidth != 0 ||
      T > kCluster * kFramesPerPass * kMaxPasses ||
      static_cast<long long>(B) * (C / kWidth) * kCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(x), static_cast<const bool*>(mask),
               static_cast<const float*>(weight), static_cast<const float*>(bias),
               static_cast<const bf16*>(film), out, T, C, (T + kCluster - 1) / kCluster, eps,
               silu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = out_f32 ? launch<float>(a, B, s) : launch<bf16>(a, B, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
