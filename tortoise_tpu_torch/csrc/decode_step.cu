// K2: one GPT-2 decode step over all layers, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/decode_step_pallas.py
// (fused_decode_step -> _kernel), with both of its static branches: bf16 or
// int8 weights (quant_w) and a bf16 or int8 KV cache (quantized), so four
// variants. Same contract: the residual stream is bf16; every dense product
// accumulates in f32; bf16 weights round it to bf16 and then add the bf16
// bias, int8 weights (per-output-channel qscale) compute acc * qscale + bias
// in f32 and round once; layer norms take f32 statistics (eps 1e-5);
// attention is an f32 softmax over the cache prefix [0, pos) plus the
// current, never-cached row. The int8 cache holds int8 rows and f32 scales
// (L, B, H, T), T-minor: k scales multiply the logits, v scales multiply the
// softmax weights before the PV product while the sum l runs over the
// unscaled weights. The current row comes from the qkv product unquantized,
// so with the int8 cache this step differs from the plain layer stack (which
// reads back its own quantized row) by at most that row's quantization
// error. The cache is read-only: the new k/v rows come back in k_rows/v_rows
// and the caller (quantizes and) writes them.
//
// What bounds it on an H100: bytes. A step must read the 30 layers' weights
// once, 30 x 25.2 MB = 755 MB in bf16 (int8: 378 MB), and the cache prefix,
// B x 30 x pos x C x 4 bytes in bf16: 61 MB at B=1, pos=500 (0.24 ms at
// 3.35 TB/s for the step), 983 MB at B=16, pos=500 (0.52 ms), 6.68 GB at
// B=96, pos=566 (2.22 ms). Its products do 2 x B x 12 C^2 operations a
// layer, 72 GFLOP a step at B=96: ~0.1 ms on the tensor cores, ~1.1 ms on
// the CUDA cores, so they must run on the tensor cores.
//
// Per layer it launches five kernels on the caller's stream, and one C entry
// point loops over the layers, so Python pays one call a step:
//   1. qkv = LN1(x) W^T + b                            (tc_gemm, LN prologue)
//   2. split-prefix attention, writing the k/v rows    (split_attention)
//   3. x += attn Wproj^T + b                           (tc_gemm, residual)
//   4. ffn = gelu_new(LN2(x) Wfc^T + b)                (tc_gemm, LN prologue)
//   5. x += ffn Wfc2^T + b                             (tc_gemm, residual)
// plus, once a step, row_stats over the input (LN1's statistics). At B=1 a
// kernel moves 2-8 MB, a few microseconds of bytes, so what a kernel waits
// on matters as much as its bytes: each is a programmatic dependent launch
// that fetches its weights (or cache rows) before it waits for the kernel
// before it, and launch bounds keep two blocks of the next kernel resident
// beside two of the running one.
//
// The products (tc_gemm): bf16 mma.sync m16n8k16 with f32 sums, "swap AB":
// a block owns 64 output features (the mma's M side, W rows, which are the
// row-major A operand) and every batch row (the n8 side: X (B, K) row-major
// is the column-major B operand), so each weight is read from device memory
// once a step whatever B is (a batch above 128 rows loops over batch tiles
// inside the block, its weights then from L2). A block copies its share of
// K with cp.async into a ring of 64-deep stages, a W tile and an X tile a
// stage (XOR-swizzled 16-byte chunks, so ldmatrix reads without bank
// conflicts), all of it at once where the ring holds it (up to 8 stages for
// B <= 32, 4 above), and then runs the stages back to back; int8 W tiles
// (half the bytes) become bf16 A fragments in registers, exactly. At B=1 a
// product is 16-64 blocks of 64 features, far too few to keep ~25 KB in
// flight on each of 132 SMs, so K is split too (the wrapper's plan: up to
// two blocks an SM, at most 8 splits). The splits of a tile are one
// thread-block cluster: each stages its f32 accumulators in its shared
// memory, and block r of the cluster sums rows r, r + splits, ... over the
// cluster's shared memory in split order and runs their epilogue. No
// workspace, no float atomics: two calls give bit-equal outputs (where a
// last block summing the splits' partials from device memory would run a
// tile's whole epilogue alone). The residual epilogues (proj, fc2) also write each row's
// mean and M2 over their 64 columns; a layer-norm prologue copies those C/64
// partial statistics with its X rows (8 bytes a row a tile, 12 KB a block at
// B=96), merges them in tile order (Chan's formula) and normalises the X
// stages in shared memory. Normalising in every block from x itself would
// read B x C x 2 bytes a block, 74 MB of L2 reads per qkv launch at B=96.
//
// The attention (split_attention): a block per (head, batch row, split of
// the prefix), 256 threads, the design of K5 (csrc/decode_attn_kv128.cu):
// 64-row stages of the head's k and v rows (128 contiguous bytes a row in
// bf16, 64 in int8, with their f32 scales) through a cp.async ring of four;
// eight threads a row, every row independent; one block max and one rescale
// a stage. The prefix is split so that B x H x splits stays within two
// blocks an SM, 32 rows a split at least and 8 splits at most (at B=1,
// pos=500 8 splits, from B=16 one). The splits of a (b, h) are one cluster:
// each leaves its (m, l, acc) in its shared memory and block 0 merges them
// in split order with the current row's f32 weight. Rounding: each stage
// rounds p = exp(s - m_run) to bf16 before the PV sum, m_run the split's
// running max; the plain version rounds relative to the global max, so the
// two differ by at most one bf16 ulp per weight, rescaled in f32 (the TPU
// kernel's chunked online softmax rounds this way too).
#include <cooperative_groups.h>

#include <algorithm>

#include "mma.cuh"

namespace tt {
namespace {

namespace cg = cooperative_groups;

constexpr int kHeadDim = 64;
constexpr float kLnEps = 1e-5f;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)

// tc_gemm
constexpr int kTM = 64;         // output features a block: 16 a warp
constexpr int kBK = 64;         // K depth of a stage
constexpr int kGemmWarps = 4;
constexpr int kGemmThreads = kGemmWarps * 32;
// The ring's slots at most: a block's K steps, up to 8 (100 KB) for up to
// 32 batch rows, so that all of a split's weights are in flight at once, and
// up to 4 (81-99 KB) for up to 128
__host__ __device__ constexpr int gemm_max_stages(int nj) { return nj == 2 ? 8 : 4; }
constexpr int kAccStride = kTM + 4;  // f32 accumulator rows in shared memory
constexpr int kMaxSplits = 8;        // blocks of a cluster (the portable most)
constexpr int kLnBytes = 2 * kBK * 2;  // a stage's slice of the LN scale and bias
constexpr int kMaxSmem = 232448;       // a block's shared memory on the H100

// split_attention
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kGroup = 8;                       // threads a cache row
constexpr int kGroups = kAttnThreads / kGroup;  // rows at once
constexpr int kStageRows = 64;
constexpr int kRowsPerGroup = kStageRows / kGroups;
constexpr int kAttnStages = 4;
constexpr int kSplitStride = kHeadDim + 4;  // floats of a split's (acc, m, l)

enum Prologue { kCopy = 0, kLayerNorm = 1 };
enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Programmatic dependent launch: every kernel of the step is launched so
// that the next may start while it runs. A kernel first issues the copies of
// what no kernel of the step writes (weights, cache rows), then lets the next
// kernel launch and waits for the one before it to complete (its writes
// visible) before it reads or writes anything that kernel touches.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// An 8-byte cp.async; both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

// Two int8 values (the low byte first) as a packed bf16 pair: exact.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t v) {
  const float lo = static_cast<float>(static_cast<int8_t>(v & 0xff));
  const float hi = static_cast<float>(static_cast<int8_t>((v >> 8) & 0xff));
  return pack_bf16(lo, hi);
}

// Eight int8 values in 8 bytes -> eight floats (exact).
__device__ __forceinline__ void unpack8_i8(const uint2 v, float* out) {
  const uint32_t w[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
}

// A 64-column tile's mean and M2 (sum of squared deviations) of one row,
// each lane holding two of the values; lane 0 writes them to stats.
__device__ __forceinline__ void tile_stats(float y0, float y1, float2* stats) {
  const float mean = warp_sum(y0 + y1) * (1.f / 64.f);
  const float d0 = y0 - mean, d1 = y1 - mean;
  const float m2 = warp_sum(d0 * d0 + d1 * d1);
  if ((threadIdx.x & 31) == 0) *stats = make_float2(mean, m2);
}

// One row's layer-norm statistics from its C/64 tiles' (mean, M2), tile i
// at stats[i * stride], merged in tile order (Chan et al.): (mean, rstd).
__device__ __forceinline__ float2 merge_stats(const float2* stats, int tiles, int stride) {
  float mean = 0.f, m2 = 0.f;
  for (int i = 0; i < tiles; ++i) {
    const float2 s = stats[i * stride];
    const float na = 64.f * i, n = na + 64.f;
    const float delta = s.x - mean;
    mean += delta * (64.f / n);
    m2 += s.y + delta * delta * (na * 64.f / n);
  }
  return make_float2(mean, rsqrtf(m2 / (64.f * tiles) + kLnEps));
}

// Per-row (mean, M2) of each 64-column tile of x (B, C): the statistics the
// first layer's LN1 merges. Grid (C/64, B), one warp a block.
struct RowStatsArgs {
  const bf16* x;
  int B, C;
  float2* stats;
};

__global__ void __launch_bounds__(32) row_stats_kernel(const RowStatsArgs a) {
  const int tile = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  wait_for_previous_kernel();
  const float2 v = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)b * a.C + tile * 64)[lane]);
  tile_stats(v.x, v.y, a.stats + (size_t)tile * a.B + b);
}

struct GemmArgs {
  const bf16* in;        // (B, K) bf16
  const void* W;         // (N, K) bf16 or int8
  const void* bias;      // (N) bf16, or f32 with int8 W
  const float* qscale;   // (N) f32, int8 W only
  const bf16* ln;        // (2, K) [scale; bias], LN prologue only
  float2* stats;         // (C/64, B): read by the LN prologue, written by the residual epilogue
  bf16* out;             // (B, N); the residual epilogue reads it as the residual
  int B, K, N, ksteps;   // ksteps: 64-deep K steps a split
};

// The epilogue of one row b of a tile: the lane holds the sums v at columns
// n, n + 1, their bias (and qscale, int8 W only) and, for the residual
// epilogue, the row's residual r there.
template <bool kQuant, int EPI>
__device__ __forceinline__ void finish(const GemmArgs& a, int tile, int b, int n, float2 v,
                                       float2 bias, float2 qs, float2 r) {
  float t0, t1;
  if (kQuant) {
    // two roundings, as acc * qscale + bias in f32 (no FMA contraction)
    t0 = round_bf16(__fadd_rn(__fmul_rn(v.x, qs.x), bias.x));
    t1 = round_bf16(__fadd_rn(__fmul_rn(v.y, qs.y), bias.y));
  } else {
    t0 = round_bf16(round_bf16(v.x) + bias.x);
    t1 = round_bf16(round_bf16(v.y) + bias.y);
  }
  if (EPI == kBiasGelu) {
    t0 = gelu_new(t0);
    t1 = gelu_new(t1);
  }
  if (EPI == kBiasResidual) {
    t0 += r.x;
    t1 += r.y;
  }
  const __nv_bfloat162 y = __floats2bfloat162_rn(t0, t1);
  reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)b * a.N + n)[0] = y;
  if (EPI == kBiasResidual) {
    const float2 yf = __bfloat1622float2(y);
    tile_stats(yf.x, yf.y, a.stats + (size_t)tile * a.B + b);
  }
}

// out[b, n] = epilogue(sum_k pro(in)[b, k] W[n, k]) for the block's 64
// features n and every batch row, over its split's share of K. NJ: the
// batch rows a block holds, in groups of 16 (2 for B <= 32, else 8).
template <typename WT, int PRO, int EPI, int NJ>
// Four blocks an SM at most 128 registers a thread: two of a launch and two
// of the next, which start under programmatic dependent launch
__global__ void __launch_bounds__(kGemmThreads, 4) tc_gemm_kernel(const GemmArgs a) {
  constexpr bool kQuant = sizeof(WT) == 1;
  constexpr int kMaxRows = NJ * 16;
  constexpr int kWBytes = kTM * kBK * (int)sizeof(WT);  // a stage's W tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the splits of a tile's K are one cluster: (1, splits, 1), rank = split
  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * kTM;
  const int n = n0 + 2 * lane;  // the epilogue's columns n, n + 1
  const int k0 = split * a.ksteps * kBK;
  const int ns = min(a.ksteps, a.K / kBK - split * a.ksteps);  // >= 1 by the plan
  const int rows_max = min(kMaxRows, (a.B + 15) & ~15);
  const int stage_bytes = kWBytes + rows_max * kBK * 2 + kLnBytes;
  const int stages = min(a.ksteps, gemm_max_stages(NJ));
  const int tiles = a.K / 64;  // of the LN statistics (K = C)
  // the ring, and the accumulators over it at the end
  const int ring_bytes = max(stages * stage_bytes, rows_max * kAccStride * 4);
  float2* stats_s = reinterpret_cast<float2*>(smem + ring_bytes);  // [tile][row]
  float* mu_s = reinterpret_cast<float*>(stats_s + (PRO == kLayerNorm ? tiles * rows_max : 0));
  float* rstd_s = mu_s + kMaxRows;
  float* acc_s = reinterpret_cast<float*>(smem);  // [rows][kAccStride], over the ring at the end
  const WT* W = static_cast<const WT*>(a.W);
  float2 bias, qs = make_float2(0.f, 0.f);
  if (kQuant) {
    bias = reinterpret_cast<const float2*>(static_cast<const float*>(a.bias) + n)[0];
    qs = reinterpret_cast<const float2*>(a.qscale + n)[0];
  } else {
    bias = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(a.bias) + n)[0]);
  }

  for (int b0 = 0; b0 < a.B; b0 += kMaxRows) {
    const int nb = min(kMaxRows, a.B - b0);
    const int rows = (nb + 15) & ~15;  // the n side, zero-filled past nb
    const int nj = rows / 16;

    // stage i: W rows n0..n0+63 (load_w), X rows b0.. and the LN slice
    // (load_x) at K offset k0 + 64 i
    const auto load_w = [&](int i) {
      unsigned char* st = smem + (i % stages) * stage_bytes;
      const int kb = k0 + i * kBK;
      if (kQuant) {  // 64 rows x 4 chunks of 16 int8
        for (int c = tid; c < kTM * 4; c += kGemmThreads) {
          const int r = c >> 2, ch = c & 3;
          cp_async16(st + r * 64 + ((ch ^ ((r >> 1) & 3)) << 4),
                     W + (size_t)(n0 + r) * a.K + kb + ch * 16, 16);
        }
      } else {  // 64 rows x 8 chunks of 8 bf16
        for (int c = tid; c < kTM * 8; c += kGemmThreads) {
          const int r = c >> 3, ch = c & 7;
          cp_async16(st + r * 128 + ((ch ^ (r & 7)) << 4),
                     W + (size_t)(n0 + r) * a.K + kb + ch * 8, 16);
        }
      }
    };
    const auto load_x = [&](int i) {
      unsigned char* xs = smem + (i % stages) * stage_bytes + kWBytes;
      const int kb = k0 + i * kBK;
      if (PRO == kLayerNorm && tid < 16)  // [scale | bias] at k kb.. behind the X rows
        cp_async16(xs + rows_max * 128 + tid * 16, a.ln + (tid >> 3) * a.K + kb + (tid & 7) * 8,
                   16);
      for (int c = tid; c < rows * 8; c += kGemmThreads) {
        const int r = c >> 3, ch = c & 7;
        const bool valid = r < nb;
        cp_async16(xs + r * 128 + ((ch ^ (r & 7)) << 4),
                   a.in + (size_t)(b0 + (valid ? r : 0)) * a.K + kb + ch * 8, valid ? 16 : 0);
      }
    };
    float acc[2 * NJ][4];
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    // rounds of up to `stages` K steps, one ring slot each: the round's
    // weights, then (the first round once the previous kernel is done) its X
    // rows, LN slices and the rows' LN statistics, in one group; then every
    // stage of the round back to back
    for (int i0 = 0; i0 < ns; i0 += stages) {
      const int cnt = min(stages, ns - i0);
      if (i0 > 0) __syncthreads();  // the last round's slots are read
      for (int i = i0; i < i0 + cnt; ++i) load_w(i);
      if (i0 == 0 && b0 == 0) wait_for_previous_kernel();
      for (int i = i0; i < i0 + cnt; ++i) load_x(i);
      if (PRO == kLayerNorm && i0 == 0)
        for (int c = tid; c < tiles * nb; c += kGemmThreads)
          cp_async8(stats_s + c, a.stats + (size_t)(c / nb) * a.B + b0 + c % nb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (PRO == kLayerNorm) {
        if (i0 == 0) {
          for (int r = tid; r < nb; r += kGemmThreads) {
            const float2 m = merge_stats(stats_s + r, tiles, nb);
            mu_s[r] = m.x;
            rstd_s[r] = m.y;
          }
          __syncthreads();
        }
        // normalise the round's X rows in place
        for (int c = tid; c < cnt * nb * 8; c += kGemmThreads) {
          const int slot = c / (nb * 8), r = (c % (nb * 8)) >> 3, ch = c & 7;
          unsigned char* xs = smem + slot * stage_bytes + kWBytes;
          const uint4* ls = reinterpret_cast<const uint4*>(xs + rows_max * 128);
          uint4* p = reinterpret_cast<uint4*>(xs + r * 128 + ((ch ^ (r & 7)) << 4));
          float v[8], g[8], be[8];
          unpack8(*p, v);
          unpack8(ls[ch], g);
          unpack8(ls[8 + ch], be);
          const float mu = mu_s[r], rs = rstd_s[r];
          uint32_t packed[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            packed[e] = pack_bf16((v[2 * e] - mu) * rs * g[2 * e] + be[2 * e],
                                  (v[2 * e + 1] - mu) * rs * g[2 * e + 1] + be[2 * e + 1]);
          *p = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
        __syncthreads();
      }
      for (int slot = 0; slot < cnt; ++slot) {
        const unsigned char* st = smem + slot * stage_bytes;
        const unsigned char* xs = st + kWBytes;
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          uint32_t af[4];
          if (kQuant) {
            const int g = lane >> 2, t = lane & 3;
            const int r0 = warp * 16 + g, r1 = r0 + 8;
            const unsigned char* p0 = st + r0 * 64 + ((ks ^ ((r0 >> 1) & 3)) << 4);
            const unsigned char* p1 = st + r1 * 64 + ((ks ^ ((r1 >> 1) & 3)) << 4);
            af[0] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0 + 2 * t));
            af[1] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1 + 2 * t));
            af[2] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0 + 8 + 2 * t));
            af[3] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1 + 8 + 2 * t));
          } else {
            const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int ch = 2 * ks + (lane >> 4);
            ldmatrix_x4(af, st + r * 128 + ((ch ^ (r & 7)) << 4));
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j < nj) {
              uint32_t bfr[4];
              const int r = j * 16 + (lane & 7) + (lane >> 4) * 8;
              const int ch = 2 * ks + ((lane >> 3) & 1);
              ldmatrix_x4(bfr, xs + r * 128 + ((ch ^ (r & 7)) << 4));
              mma_bf16(acc[2 * j], af, bfr[0], bfr[1]);
              mma_bf16(acc[2 * j + 1], af, bfr[2], bfr[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the ring is free: the accumulators go over it

    {
      const int g = lane >> 2, t = lane & 3, m = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j) {
        if (j < 2 * nj) {
          const int b = j * 8 + 2 * t;
          acc_s[b * kAccStride + m] = acc[j][0];
          acc_s[(b + 1) * kAccStride + m] = acc[j][1];
          acc_s[b * kAccStride + m + 8] = acc[j][2];
          acc_s[(b + 1) * kAccStride + m + 8] = acc[j][3];
        }
      }
    }
    // every split's accumulators are staged; block `split` of the cluster
    // takes rows split, split + splits, ... and sums them in split order,
    // four rows a warp at a time (their loads in flight together)
    cluster.sync();
    const int step = splits * kGemmWarps;
    for (int r0 = split + splits * warp; r0 < nb; r0 += 4 * step) {
      float2 v[4], res[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u * step;
        v[u] = res[u] = make_float2(0.f, 0.f);
        if (r < nb) {
          // out is the residual stream: each element read here, then written
          // by the same lane in finish
          if (EPI == kBiasResidual)
            res[u] = __bfloat1622float2(
                reinterpret_cast<const __nv_bfloat162*>(a.out + (size_t)(b0 + r) * a.N + n)[0]);
#pragma unroll
          for (int q = 0; q < kMaxSplits; ++q) {
            if (q < splits) {
              const float2 p = reinterpret_cast<const float2*>(
                  cluster.map_shared_rank(acc_s, q) + r * kAccStride)[lane];
              v[u].x += p.x;
              v[u].y += p.y;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + u * step < nb)
          finish<kQuant, EPI>(a, tile, b0 + r0 + u * step, n, v[u], bias, qs, res[u]);
    }
    cluster.sync();  // no block reuses or leaves its ring while another reads it
  }
}

struct AttnArgs {
  const bf16* qkv;                // (B, 3C) = [q | k | v]
  const void* cache_k;            // the layer's (B, T, C), bf16 or int8
  const void* cache_v;
  const float* k_scale;           // the layer's (B, H, T), int8 cache only
  const float* v_scale;
  bf16* attn;                     // (B, C)
  bf16* k_row;                    // (B, C)
  bf16* v_row;
  int T, C, pos, rows_per_split;
};

// One block per (head, batch row, split of the prefix [0, pos)); the splits
// of a (head, batch row) are one cluster (1, 1, splits), rank = split.
// Shared memory: the ring (dynamic, kAttnStages x (k tile, v tile) of
// kStageRows head rows, fewer stages for a short split), then at the end the
// groups' sums in its place; the split's (acc, m, l) in split_s.
template <typename CT>
__global__ void __launch_bounds__(kAttnThreads) split_attention_kernel(const AttnArgs a) {
  constexpr bool kQuant = sizeof(CT) == 1;
  constexpr int kRowBytes = kHeadDim * (int)sizeof(CT);  // a head's row: 128 or 64 bytes
  constexpr int kChunks = kRowBytes / 16;
  constexpr int kTileBytes = kStageRows * kRowBytes;
  // a stage: k tile, v tile and, with the int8 cache, the rows' k and v scales
  constexpr int kSlotBytes = 2 * kTileBytes + (kQuant ? 2 * kStageRows * 4 : 0);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float max_s[kAttnWarps];
  __shared__ float q_s[kHeadDim];
  __shared__ float cur_s;
  __shared__ float split_s[kSplitStride];  // the split's acc[64], m, l
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int H = gridDim.x, C = a.C;
  const int tid = threadIdx.x, grp = tid / kGroup, sub = tid % kGroup;
  const bf16* q = a.qkv + (size_t)b * 3 * C + h * kHeadDim;
  const bf16* k_cur = q + C;
  const bf16* v_cur = q + 2 * C;
  const int r0 = split * a.rows_per_split;
  const int rows = max(0, min(a.pos, r0 + a.rows_per_split) - r0);
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  const size_t row0 = (size_t)b * a.T + r0;  // cache row r0 of batch row b
  const CT* ck = static_cast<const CT*>(a.cache_k) + row0 * C + h * kHeadDim;
  const CT* cv = static_cast<const CT*>(a.cache_v) + row0 * C + h * kHeadDim;
  const float* ks = kQuant ? a.k_scale + ((size_t)b * H + h) * a.T + r0 : nullptr;
  const float* vs = kQuant ? a.v_scale + ((size_t)b * H + h) * a.T + r0 : nullptr;

  // stage c: the split's rows 64c.. into ring slot c % kAttnStages, k then
  // v (then their scales)
  const auto load_stage = [&](int c) {
    unsigned char* kt = smem + (c % kAttnStages) * kSlotBytes;
    unsigned char* vt = kt + kTileBytes;
    const int rows_c = min(kStageRows, rows - c * kStageRows);
    const int n = rows_c * kChunks;
    for (int x = tid; x < n; x += kAttnThreads) {
      const size_t src =
          (size_t)(c * kStageRows + x / kChunks) * C + (x % kChunks) * (16 / sizeof(CT));
      cp_async16(kt + x * 16, ck + src, 16);
      cp_async16(vt + x * 16, cv + src, 16);
    }
    if (kQuant && tid < 2 * kStageRows) {
      const int r = tid % kStageRows;
      if (r < rows_c)
        cp_async4(vt + kTileBytes + tid * 4,
                  (tid < kStageRows ? ks : vs) + c * kStageRows + r, 4);
    }
  };
#pragma unroll
  for (int c = 0; c < kAttnStages - 1; ++c) {
    if (c < chunks) load_stage(c);
    cp_async_commit();
  }
  wait_for_previous_kernel();  // the qkv product
  if (tid < kHeadDim) {
    q_s[tid] = __bfloat162float(q[tid]);
    if (split == 0) {
      a.k_row[(size_t)b * C + h * kHeadDim + tid] = k_cur[tid];
      a.v_row[(size_t)b * C + h * kHeadDim + tid] = v_cur[tid];
    }
  }
  __syncthreads();  // q_s
  if (tid < 32) {   // the current row's logit
    const float d = q_s[2 * tid] * __bfloat162float(k_cur[2 * tid]) +
                    q_s[2 * tid + 1] * __bfloat162float(k_cur[2 * tid + 1]);
    const float s = warp_sum(d) * kLogitScale;
    if (tid == 0) cur_s = s;
  }
  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = q_s[sub * 8 + e];

  float m_run = -INFINITY, l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kAttnStages - 2>();  // this thread's copies of stage c have landed
    __syncthreads();                   // everyone's; and stage c - 1's slot is read
    if (c + kAttnStages - 1 < chunks) load_stage(c + kAttnStages - 1);
    cp_async_commit();
    const unsigned char* kt = smem + (c % kAttnStages) * kSlotBytes;
    const unsigned char* vt = kt + kTileBytes;
    const float* ks_s = reinterpret_cast<const float*>(vt + kTileBytes);  // int8 cache only
    const float* vs_s = ks_s + kStageRows;
    const int n = min(kStageRows, rows - c * kStageRows);

    // the logits of the group's rows grp, grp + 32 (-inf for a row past n)
    float lg[kRowsPerGroup], wmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const int r = grp + j * kGroups;
      float d = 0.f, sc = 1.f;
      if (r < n) {
        float k8[8];
        if (kQuant) {
          sc = ks_s[r];
          unpack8_i8(*reinterpret_cast<const uint2*>(kt + r * kRowBytes + sub * 8), k8);
        } else {
          unpack8(*reinterpret_cast<const uint4*>(kt + r * kRowBytes + sub * 16), k8);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qv[e], k8[e], d);
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      lg[j] = r < n ? d * kLogitScale * sc : -INFINITY;
      wmax = fmaxf(wmax, lg[j]);
    }
    wmax = warp_max(wmax);
    if (tid % 32 == 0) max_s[tid / 32] = wmax;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) m_new = fmaxf(m_new, max_s[w]);
    const float alpha = expf(m_run - m_new);  // 0 at the first stage
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
    m_run = m_new;

#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const int r = grp + j * kGroups;
      if (r < n) {
        const float p = expf(lg[j] - m_new);
        l += p;
        // the weight the PV sum applies, with its v scale, rounded to bf16
        const float w = round_bf16(kQuant ? p * vs_s[r] : p);
        float v8[8];
        if (kQuant)
          unpack8_i8(*reinterpret_cast<const uint2*>(vt + r * kRowBytes + sub * 8), v8);
        else
          unpack8(*reinterpret_cast<const uint4*>(vt + r * kRowBytes + sub * 16), v8);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, v8[e], acc[e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring (and max_s)

  // m_run is the same in every thread, so the groups' sums add as they are
  float* acc_s = reinterpret_cast<float*>(smem);  // [kGroups][kHeadDim]
  float* l_s = acc_s + kGroups * kHeadDim;        // [kGroups]
  float4* a4 = reinterpret_cast<float4*>(acc_s + grp * kHeadDim + sub * 8);
  a4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  a4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (sub == 0) l_s[grp] = l;
  __syncthreads();
  float o = 0.f, lsum = 0.f;
  if (tid < kHeadDim) {
#pragma unroll 8
    for (int g = 0; g < kGroups; ++g) {
      o += acc_s[g * kHeadDim + tid];
      lsum += l_s[g];
    }
  }
  if (tid < kHeadDim) split_s[tid] = o;
  if (tid == 0) {
    split_s[kHeadDim] = m_run;
    split_s[kHeadDim + 1] = lsum;
  }
  cluster.sync();
  // block 0 of the cluster merges the splits in split order with the
  // current row
  if (split == 0 && tid < kHeadDim) {
    const float cur = cur_s;
    float m = cur;
    for (int q = 0; q < splits; ++q) m = fmaxf(m, cluster.map_shared_rank(split_s, q)[kHeadDim]);
    o = 0.f;
    lsum = 0.f;
    for (int q = 0; q < splits; ++q) {
      const float* sq = cluster.map_shared_rank(split_s, q);
      const float f = expf(sq[kHeadDim] - m);
      o += sq[tid] * f;
      lsum += sq[kHeadDim + 1] * f;
    }
    const float p_cur = expf(cur - m);
    lsum += p_cur;
    o += p_cur * __bfloat162float(v_cur[tid]);
    a.attn[(size_t)b * C + h * kHeadDim + tid] = __float2bfloat16(o / lsum);
  }
  cluster.sync();  // no block leaves while block 0 reads its split_s
}

// Dynamic shared memory of a tc_gemm launch: the ring (at least the room of
// the accumulators), the rows' LN statistics (LN prologue) and their mean
// and rstd.
template <typename WT, int PRO, int NJ>
size_t gemm_smem(int B, int K, int ksteps) {
  const int rows = std::min(NJ * 16, (B + 15) & ~15);
  const int stages = std::min(ksteps, gemm_max_stages(NJ));
  const size_t ring = (size_t)stages * (kTM * kBK * sizeof(WT) + rows * kBK * 2 + kLnBytes);
  return std::max(ring, (size_t)rows * kAccStride * sizeof(float)) +
         (PRO == kLayerNorm ? (size_t)K / 64 * rows * sizeof(float2) : 0) +
         2 * NJ * 16 * sizeof(float);
}

// Launches `kernel` on `grid` in clusters of `splits` blocks along `axis`
// (1: y, 2: z; 0: no clusters), as a programmatic dependent launch.
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, int axis, int splits,
                   cudaStream_t s, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = axis == 1 ? splits : 1;
  attr[1].val.clusterDim.z = axis == 2 ? splits : 1;
  cfg.attrs = attr;
  cfg.numAttrs = axis ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

template <typename WT, int PRO, int EPI, int NJ>
cudaError_t launch_gemm_nj(const GemmArgs& a, int splits, cudaStream_t s) {
  // a ring may take more than the default 48 KB: allowed once a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc_gemm_kernel<WT, PRO, EPI, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = gemm_smem<WT, PRO, NJ>(a.B, a.K, a.ksteps);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return launch(tc_gemm_kernel<WT, PRO, EPI, NJ>, dim3(a.N / kTM, splits), kGemmThreads, smem,
                splits > 1 ? 1 : 0, splits, s, a);
}

// ksteps: the 64-deep K steps of a split; the split count follows.
template <typename WT, int PRO, int EPI>
cudaError_t launch_gemm(GemmArgs a, int ksteps, cudaStream_t s) {
  a.ksteps = ksteps;
  const int splits = (a.K / kBK + ksteps - 1) / ksteps;
  return a.B <= 32 ? launch_gemm_nj<WT, PRO, EPI, 2>(a, splits, s)
                   : launch_gemm_nj<WT, PRO, EPI, 8>(a, splits, s);
}

// Dynamic shared memory of a split_attention launch whose splits hold up to
// `rows` prefix rows: the ring, at least the room of the groups' sums.
template <typename CT>
size_t attn_smem(int rows) {
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  const size_t slot = 2 * kStageRows * (kHeadDim * sizeof(CT) + (sizeof(CT) == 1 ? 4 : 0));
  const size_t ring = (size_t)std::min(chunks, kAttnStages) * slot;
  const size_t sums = (size_t)kGroups * (kHeadDim + 1) * sizeof(float);
  return ring > sums ? ring : sums;
}

struct StepArgs {
  bf16 *x, *qkv, *attn, *ffn;
  const bf16 *ln1, *ln2;
  const void *wqkv, *bqkv, *wproj, *bproj, *wfc, *bfc, *wfc2, *bfc2;
  const float *sqkv, *sproj, *sfc, *sfc2;  // int8 weights only
  const void *cache_k, *cache_v;
  const float *k_scale, *v_scale;          // int8 cache only
  bf16 *k_rows, *v_rows;
  float2* stats;
  int L, B, T, C, pos;
  int ks_qkv, ks_proj, ks_fc, ks_fc2, attn_rows;  // the plan
};

// The layer loop for weight type WT (bf16 or int8) and cache type CT.
template <typename WT, typename CT>
cudaError_t run_layers(const StepArgs& a, cudaStream_t s) {
  constexpr bool kQuantW = sizeof(WT) == 1;
  constexpr bool kQuantC = sizeof(CT) == 1;
  constexpr size_t kW = sizeof(WT);
  const int C = a.C, B = a.B, H = C / kHeadDim;
  const size_t c = (size_t)C;
  const size_t bias_bytes = kQuantW ? sizeof(float) : sizeof(bf16);
  const auto at = [](const void* p, size_t bytes) {
    return static_cast<const void*>(static_cast<const unsigned char*>(p) + bytes);
  };
  const auto qs = [&](const float* p, size_t off) { return kQuantW ? p + off : nullptr; };
  const int splits = a.pos > 0 ? (a.pos + a.attn_rows - 1) / a.attn_rows : 1;
  static const cudaError_t attr =
      cudaFuncSetAttribute(split_attention_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_smem<CT>(kAttnStages * kStageRows));
  if (attr != cudaSuccess) return attr;
  const size_t attn_smem_bytes = attn_smem<CT>(a.pos > 0 ? a.attn_rows : 0);

  cudaError_t e = launch(row_stats_kernel, dim3(C / 64, B), 32, 0, 0, 1, s,
                         RowStatsArgs{a.x, B, C, a.stats});
  if (e != cudaSuccess) return e;

  GemmArgs g{};
  g.B = B;
  g.stats = a.stats;
  for (int l = 0; l < a.L; ++l) {
    g.in = a.x, g.K = C, g.N = 3 * C, g.out = a.qkv, g.ln = a.ln1 + l * 2 * c;
    g.W = at(a.wqkv, l * 3 * c * c * kW), g.bias = at(a.bqkv, l * 3 * c * bias_bytes);
    g.qscale = qs(a.sqkv, l * 3 * c);
    if ((e = launch_gemm<WT, kLayerNorm, kBias>(g, a.ks_qkv, s)) != cudaSuccess) return e;

    AttnArgs t;
    t.qkv = a.qkv;
    t.cache_k = at(a.cache_k, l * (size_t)B * a.T * c * sizeof(CT));
    t.cache_v = at(a.cache_v, l * (size_t)B * a.T * c * sizeof(CT));
    t.k_scale = kQuantC ? a.k_scale + l * (size_t)B * H * a.T : nullptr;
    t.v_scale = kQuantC ? a.v_scale + l * (size_t)B * H * a.T : nullptr;
    t.attn = a.attn;
    t.k_row = a.k_rows + l * (size_t)B * c;
    t.v_row = a.v_rows + l * (size_t)B * c;
    t.T = a.T, t.C = C, t.pos = a.pos, t.rows_per_split = a.attn_rows;
    e = launch(split_attention_kernel<CT>, dim3(H, B, splits), kAttnThreads, attn_smem_bytes,
               splits > 1 ? 2 : 0, splits, s, t);
    if (e != cudaSuccess) return e;

    g.in = a.attn, g.K = C, g.N = C, g.out = a.x, g.ln = nullptr;
    g.W = at(a.wproj, l * c * c * kW), g.bias = at(a.bproj, l * c * bias_bytes);
    g.qscale = qs(a.sproj, l * c);
    if ((e = launch_gemm<WT, kCopy, kBiasResidual>(g, a.ks_proj, s)) != cudaSuccess) return e;

    g.in = a.x, g.K = C, g.N = 4 * C, g.out = a.ffn, g.ln = a.ln2 + l * 2 * c;
    g.W = at(a.wfc, l * 4 * c * c * kW), g.bias = at(a.bfc, l * 4 * c * bias_bytes);
    g.qscale = qs(a.sfc, l * 4 * c);
    if ((e = launch_gemm<WT, kLayerNorm, kBiasGelu>(g, a.ks_fc, s)) != cudaSuccess) return e;

    g.in = a.ffn, g.K = 4 * C, g.N = C, g.out = a.x, g.ln = nullptr;
    g.W = at(a.wfc2, l * 4 * c * c * kW), g.bias = at(a.bfc2, l * c * bias_bytes);
    g.qscale = qs(a.sfc2, l * c);
    if ((e = launch_gemm<WT, kCopy, kBiasResidual>(g, a.ks_fc2, s)) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tt

// x: (B, C) bf16, the residual stream: holds the input embedding on entry and
// the pre-ln_f hidden state on return. qkv (B, 3C), attn (B, C), ffn (B, 4C)
// are scratch. Stacked weights: ln (L, 2, C) bf16, wqkv (L, 3C, C), bqkv
// (L, 3C), wproj (L, C, C), bproj (L, C), wfc (L, 4C, C), bfc (L, 4C), wfc2
// (L, C, 4C), bfc2 (L, C): bf16 weights and biases, or int8 weights with f32
// biases and f32 qscales sqkv (L, 3C), sproj (L, C), sfc (L, 4C), sfc2 (L, C)
// (null for bf16 weights). cache_k/cache_v: (L, B, T, C), bf16, or int8 with
// f32 k_scale/v_scale (L, B, H, T) (null for the bf16 cache); read-only.
// k_rows/v_rows: (L, B, C) bf16 outputs. The plan (ops/decode_step.py
// plan_step): ks_* the 64-deep K steps of each product's split, attn_rows
// the prefix rows of an attention split; at most 8 splits each (a portable
// cluster). stats: (C/64, B, 2) f32 workspace. Returns the first CUDA
// error, 0 on success.
extern "C" int tt_decode_step(void* x, void* qkv, void* attn, void* ffn, const void* ln1,
                              const void* wqkv, const void* bqkv, const void* wproj,
                              const void* bproj, const void* ln2, const void* wfc,
                              const void* bfc, const void* wfc2, const void* bfc2,
                              const void* sqkv, const void* sproj, const void* sfc,
                              const void* sfc2, const void* cache_k, const void* cache_v,
                              const void* k_scale, const void* v_scale, void* k_rows,
                              void* v_rows, void* stats, int L, int B, int T, int C, int pos,
                              int ks_qkv,
                              int ks_proj, int ks_fc, int ks_fc2, int attn_rows, void* stream) {
  using namespace tt;
  const bool quant_w = sqkv != nullptr;
  const bool quant_c = k_scale != nullptr;
  const auto splits_ok = [](int steps, int per) {
    return per >= 1 && (steps + per - 1) / per <= kMaxSplits;
  };
  if (C % kHeadDim != 0 || B < 1 || L < 1 || pos < 0 || pos >= T || !stats ||
      !splits_ok(C / kBK, ks_qkv) || !splits_ok(C / kBK, ks_proj) ||
      !splits_ok(C / kBK, ks_fc) || !splits_ok(4 * C / kBK, ks_fc2) ||
      (pos > 0 && !splits_ok(pos, attn_rows)))
    return (int)cudaErrorInvalidValue;
  if (quant_w && (!sproj || !sfc || !sfc2)) return (int)cudaErrorInvalidValue;
  if (quant_c && !v_scale) return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.x = static_cast<bf16*>(x);
  a.qkv = static_cast<bf16*>(qkv);
  a.attn = static_cast<bf16*>(attn);
  a.ffn = static_cast<bf16*>(ffn);
  a.ln1 = static_cast<const bf16*>(ln1);
  a.ln2 = static_cast<const bf16*>(ln2);
  a.wqkv = wqkv;
  a.bqkv = bqkv;
  a.wproj = wproj;
  a.bproj = bproj;
  a.wfc = wfc;
  a.bfc = bfc;
  a.wfc2 = wfc2;
  a.bfc2 = bfc2;
  a.sqkv = static_cast<const float*>(sqkv);
  a.sproj = static_cast<const float*>(sproj);
  a.sfc = static_cast<const float*>(sfc);
  a.sfc2 = static_cast<const float*>(sfc2);
  a.cache_k = cache_k;
  a.cache_v = cache_v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.k_rows = static_cast<bf16*>(k_rows);
  a.v_rows = static_cast<bf16*>(v_rows);
  a.stats = static_cast<float2*>(stats);
  a.L = L;
  a.B = B;
  a.T = T;
  a.C = C;
  a.pos = pos;
  a.ks_qkv = ks_qkv;
  a.ks_proj = ks_proj;
  a.ks_fc = ks_fc;
  a.ks_fc2 = ks_fc2;
  a.attn_rows = attn_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (quant_w)
    e = quant_c ? run_layers<int8_t, int8_t>(a, s) : run_layers<int8_t, bf16>(a, s);
  else
    e = quant_c ? run_layers<bf16, int8_t>(a, s) : run_layers<bf16, bf16>(a, s);
  return (int)e;
}
