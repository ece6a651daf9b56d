// K6: the flash-decode attention body of the fused decode step, over a
// merged (B, T, C) k/v slab, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_attn_body_pallas.py
// (attn_pallas -> _attn_kernel), which timed two formulations of K2's
// attention inner loop. Same contract and the same rounding points: q (B, C)
// bf16, k / v (B, T, C) bf16, C = H x 64, rows 0..pos attended, walked in
// chunks of ck rows with an online softmax whose max and sum stay f32:
//   variant a: logit = sum over the head's 64 lanes of k * q in f32 (the
//              bf16 products are exact in f32);
//   variant b: logit = sum of bf16(k * q) in f32 (each product rounded to
//              bf16 first, as the TPU's bf16 multiply before its 0/1 head
//              mask matmul);
//   both: logit / 8, -1e30 past row pos; p = exp(logit - m) in f32, l sums
//   the f32 p; each weighted value is bf16(bf16(p) * v), summed over the
//   chunk in f32; acc = acc * alpha + that sum; out = bf16(acc / l).
// The rounding depends on ck, so the kernel takes the caller's ck. Rows
// past pos weigh exp(-1e30 - m) = 0 and are not read; the TPU kernel's DMA
// reads whole chunks, so the wrapper refuses a T that ck does not divide.
// The f32 sums are taken in another order than the plain version's: within
// a chunk, and acc is kept as one partial sum per group of threads (each
// rescaled by the same alpha), added together at the end.
//
// What bounds it on an H100: bytes. At B = 128, pos = 300, C = 1024 a call
// reads the k and v prefix, 2 x 128 x 301 x 1024 x 2 B = 157.8 MB (about
// 47 us at 3.35 TB/s); 4 FLOP per cache value.
//
// The design. A block takes one (head, row): 64 threads, 2048 blocks at
// B = 128, all resident at once (16 an SM). A block per row over all 16
// heads, whose cache rows are 2 KB contiguous, measured 5% slower on the
// card (PERF.md, section 7). The rows
// stream through a ring of shared-memory stages filled by 16-byte cp.async,
// as K5's (csrc/decode_attn_kv128.cu): a chunk is ceil(ck / IR) stages of
// its k rows, then as many of its v rows (IR = min(ck, the stage's rows)),
// so v is in flight while the chunk's softmax runs. Eight threads take one
// row: 16 bytes each, four rows a warp at once, a logit closed by a
// 3-step shuffle over the eight. A stage costs one block barrier (the
// ring's); the first v stage's barrier also publishes the chunk's logits,
// from which each group of eight reads the chunk max. Each
// group keeps its own acc (8 lanes of v a thread) and l; the groups' sums
// are added in a fixed order at the end, by all threads. The rounded
// products (variant b's k * q, and bf16(p) * v) are bf16x2 multiplies, two
// an instruction, each the exact product rounded once as the plain
// version's f32 product then bf16 cast.
#include "mma.cuh"

namespace tt {
namespace {

constexpr int kHeadDim = 64;
constexpr int kGroup = 8;     // threads a (row, head): 16 bytes each
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)

// 64 threads: eight groups of eight, each a row of the stage at a time;
// 3 stages of 32 rows (4 KB each) and the chunk's ck f32 logits
constexpr int kThreads = 64;
constexpr int kRowPhases = kThreads / kGroup;  // rows a stage takes at once
constexpr int kStageRows = 32;
constexpr int kStages = 3;
constexpr size_t kStageBytes = (size_t)kStageRows * kHeadDim * sizeof(bf16);

size_t smem_bytes(int ck) { return kStages * kStageBytes + (size_t)ck * sizeof(float); }

// bf16 pairs as floats: the low half, the high half
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// the four bf16 pairs of a 16-byte piece, each multiplied by the pair in w
// and rounded to bf16 (bf16x2 multiplies: the exact f32 product, rounded
// once), summed into s[0..7] in f32
__device__ __forceinline__ void add_rounded_products(const uint4 v, const __nv_bfloat162* w,
                                                     float* s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 p = __hmul2(h[e], w[e]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
    s[2 * e] += lo_f(u);
    s[2 * e + 1] += hi_f(u);
  }
}

template <bool kRoundProducts>
__global__ void __launch_bounds__(kThreads)
attn_body_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int T, int C, int pos, int ck,
                 bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* lg = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [ck] logits
  const int tid = threadIdx.x, phase = tid / kGroup, sub = tid % kGroup;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = pos + 1;
  const int ir = min(ck, kStageRows);    // rows a stage
  const int half = (ck + ir - 1) / ir;   // k stages (and v stages) a chunk
  const int items = (n + ck - 1) / ck * 2 * half;
  const size_t base = (size_t)b * T * C + h * kHeadDim;
  constexpr int kChunks = kHeadDim * sizeof(bf16) / 16;  // 16-byte pieces a row

  // item i: chunk i / (2 half), its k (then v) rows off.. off + ir - 1
  const auto rows_of = [&](int i, int& c, int& kind, int& off) {
    c = i / (2 * half);
    const int jj = i % (2 * half);
    kind = jj / half;
    off = (jj % half) * ir;
    return max(0, min(ir, min(ck, n - c * ck) - off));
  };
  const auto load = [&](int i) {
    int c, kind, off;
    const int nr = rows_of(i, c, kind, off);
    bf16* dst = ring + (size_t)(i % kStages) * kStageRows * kHeadDim;
    const bf16* src = (kind ? v : k) + base + (size_t)(c * ck + off) * C;
    for (int x = tid; x < nr * kChunks; x += kThreads)
      cp_async16(dst + x * 8, src + (size_t)(x / kChunks) * C + (x % kChunks) * 8, 16);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < items) load(i);
    cp_async_commit();
  }

  const uint4 q16 = *reinterpret_cast<const uint4*>(q + (size_t)b * C + h * kHeadDim + sub * 8);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&q16);
  float qv[8];
  unpack8(q16, qv);
  float m = -1e30f, l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < items; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item i have landed
    __syncthreads();               // everyone's; item i - 1's slot and logits are done
    if (i + kStages - 1 < items) load(i + kStages - 1);
    cp_async_commit();
    int c, kind, off;
    const int nr = rows_of(i, c, kind, off);
    const bf16* stage = ring + (size_t)(i % kStages) * kStageRows * kHeadDim;
    if (kind == 0) {  // the logits of the stage's rows; the same trip count in every lane
      for (int r0 = 0; r0 < ir; r0 += kRowPhases) {
        const int r = r0 + phase;
        float d = 0.f;
        if (r < nr) {
          const uint4 k16 = *reinterpret_cast<const uint4*>(stage + r * kHeadDim + sub * 8);
          if (kRoundProducts) {
            float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            add_rounded_products(k16, q2, s8);
#pragma unroll
            for (int e = 0; e < 8; ++e) d += s8[e];
          } else {
            float k8[8];
            unpack8(k16, k8);
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(k8[e], qv[e], d);
          }
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (r < nr && sub == 0) lg[off + r] = d * kLogitScale;
      }
      continue;
    }
    if (off == 0) {  // the chunk's first v stage: its max, the rescale
      const int rows = min(ck, n - c * ck);
      float cmax = -1e30f;
      for (int r = sub; r < rows; r += kGroup) cmax = fmaxf(cmax, lg[r]);
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= alpha;
      m = m_new;
    }
    for (int r = phase; r < nr; r += kRowPhases) {
      const float p = expf(lg[off + r] - m);
      l += p;
      const __nv_bfloat162 pb = __float2bfloat162_rn(p);
      const __nv_bfloat162 p4[4] = {pb, pb, pb, pb};
      add_rounded_products(*reinterpret_cast<const uint4*>(stage + r * kHeadDim + sub * 8), p4,
                           acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // the row phases' sums, added in a fixed order
  float* acc_s = reinterpret_cast<float*>(smem);  // [phase][64]
  float* l_s = acc_s + kRowPhases * kHeadDim;     // [phase]
  float4* a4 = reinterpret_cast<float4*>(acc_s + phase * kHeadDim + sub * 8);
  a4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  a4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (sub == 0) l_s[phase] = l;
  __syncthreads();
  const int o = tid;  // kThreads == kHeadDim: one output lane a thread
  float s = 0.f, sum = 0.f;
#pragma unroll
  for (int ph = 0; ph < kRowPhases; ++ph) {
    s += acc_s[ph * kHeadDim + o];
    sum += l_s[ph];
  }
  out[(size_t)b * C + h * kHeadDim + o] = __float2bfloat16(s / sum);
}
static_assert(kThreads == kHeadDim, "the epilogue writes one output lane a thread");

template <bool kRoundProducts>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, int B, int T, int C, int pos,
                   int ck, bf16* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(ck);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_body_kernel<kRoundProducts>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_body_kernel<kRoundProducts>
      <<<dim3(C / kHeadDim, B), kThreads, smem, stream>>>(q, k, v, T, C, pos, ck, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

// q: (B, C) bf16; k, v: (B, T, C) bf16; out: (B, C) bf16; all contiguous and
// 16-byte aligned. variant 0 is a, 1 is b. C a multiple of 64, 0 <= pos < T,
// ck >= 1 and a divisor of T, the ring and ck logits within 227 KB. Returns
// the first CUDA error, 0 on success.
extern "C" int tt_attn_body(const void* q, const void* k, const void* v, void* out, int B, int T,
                            int C, int pos, int ck, int variant, void* stream) {
  using namespace tt;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B < 1 || C < kHeadDim || C % kHeadDim != 0 || pos < 0 || pos >= T || ck < 1 ||
      T % ck != 0 || (variant != 0 && variant != 1) || misaligned(q) || misaligned(k) ||
      misaligned(v) || smem_bytes(ck) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(variant ? launch<true>(qp, kp, vp, B, T, C, pos, ck, op, s)
                       : launch<false>(qp, kp, vp, B, T, C, pos, ck, op, s));
}
