// K3: non-causal attention with a T5 relative-position bias and per-row key
// masking, hand-written for Hopper (sm_90a) on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/attn_pallas.py
// (flash_rel_attention -> _kernel). It computes what that kernel computes,
// softmax(q k^T / sqrt(D) + bias[h, j - i]) v with keys j >= valid_len[b]
// masked, but not its tiling: instead of the TPU's (H, 2nq-1, 256, 256) stack
// of Toeplitz bias tiles it reads a pre-scaled diagonal vector (H, 2T-1),
// bias[h, j - i + T - 1], built once per sampling call.
//
// FlashAttention-2's shape. One block of 4 warps per (64-row q tile, head,
// batch row); each warp owns 16 q rows (128-row tiles of 8 warps were slower
// at both of the quality path's batches). The q tile and 64-key
// k/v tiles come into shared memory as bf16 through 16-byte cp.async copies,
// k/v double-buffered (the next tile loads while this one is computed), each
// row's eight 16-byte chunks XOR-swizzled by the row so ldmatrix has no
// bank conflicts without padding. S = q k^T and o += p v are mma.sync
// m16n8k16 (bf16 in, f32 sums). The tile's slice of the bias vector comes
// into shared memory with its k/v tile (4-byte cp.async copies in the same
// pipeline), and each score adds the entry its (row, col) names; only the
// last key tile masks columns one by one, and tiles at or past valid_len
// are skipped. The softmax is online in registers (row max
// and sum per fragment row, exp2f); p is rounded to bf16 in registers and
// fed straight back as the A operand of the pv product, as the TPU kernel
// rounds its weights to v's dtype (here before the normalisation, which is
// done in f32 at the end). The output tile goes out through shared memory
// in 16-byte stores. Output rows at or past valid_len are computed like the
// others but carry no meaning (the caller masks them); valid_len = 0 gives
// zeros.
//
// What bounds it on an H100: operations. At B=2, H=16, T~2230 one call is
// ~36 GFLOP for ~18 MB of q/k/v/out traffic (0.036 ms at the 989 TFLOP/s
// bf16 peak). mma.sync reaches a fraction of that peak; wgmma with
// warp-specialised TMA loads (FlashAttention-3's shape) is the next step.
#include "mma.cuh"

namespace tt {
namespace {

constexpr int kD = 64;  // head dim; the wrapper checks it
constexpr int kBK = 64;
constexpr int kTile = kBK * kD;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.125f;  // 1/sqrt(kD)
constexpr float kMasked = -1e30f;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;
constexpr int kBias = kBQ + kBK - 1;  // j - i = -(kBQ-1) .. kBK-1
constexpr size_t kSmem = (size_t)(kBQ * kD + 4 * kTile) * sizeof(bf16) +
                         2 * kBias * sizeof(float);

// Element (row, col) of a (rows, kD) bf16 shared tile: 16-byte chunk col / 8
// of a row is stored at chunk (col / 8) ^ (row % 8), so the eight rows an
// ldmatrix reads at one chunk fall in eight different bank groups.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kD + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// The bias entries of key tile j0 against q tile i0, b_s[j - i + kBQ - 1] =
// bias_h[j - i + T - 1], asynchronously; entries outside the vector are zero.
__device__ __forceinline__ void load_bias(const float* __restrict__ bias_h, int i0, int j0, int T,
                                          float* b_s) {
  for (int i = threadIdx.x; i < kBQ + kBK - 1; i += kThreads) {
    const int idx = j0 - i0 + i - (kBQ - 1) + T - 1;
    const bool in = idx >= 0 && idx <= 2 * T - 2;
    cp_async4(b_s + i, bias_h + (in ? idx : 0), in ? 4 : 0);
  }
}

// rows r0 .. r0 + rows - 1 of a (T, kD) bf16 matrix -> swizzled shared tile,
// asynchronously; rows at or past T are zero.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int r0, int rows, int T,
                                          bf16* dst) {
  for (int i = threadIdx.x; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    const bool in = r0 + r < T;
    cp_async16(dst + swz(r, c * 8), src + (size_t)(in ? r0 + r : 0) * kD + c * 8, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
flash_rel_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ valid_len, bf16* __restrict__ out, int H, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBQ][kD], at the end the output tile
  bf16* k_s = q_s + kBQ * kD;                 // [2][kBK][kD]
  bf16* v_s = k_s + 2 * kTile;                // [2][kBK][kD]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [2][kBias]: j - i + kBQ - 1
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t head = ((size_t)b * H + h) * T * kD;
  const int len = min(valid_len[b], T);
  const int n_tiles = len > 0 ? (len + kBK - 1) / kBK : 0;
  const float* bias_h = bias + (size_t)h * (2 * T - 1);

  load_tile(q + head, i0, kBQ, T, q_s);
  if (n_tiles > 0) {
    load_tile(k + head, 0, kBK, T, k_s);
    load_tile(v + head, 0, kBK, T, v_s);
    load_bias(bias_h, i0, 0, T, b_s);
  }
  cp_async_commit();

  float o[kD / 8][4];       // output accumulators, 8 columns of d each
  // rows g and g + 8: running max, and this lane's part of the running sum
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kBK, buf = jt & 1;
    if (jt + 1 < n_tiles) {
      load_tile(k + head, j0 + kBK, kBK, T, k_s + (buf ^ 1) * kTile);
      load_tile(v + head, j0 + kBK, kBK, T, v_s + (buf ^ 1) * kTile);
      load_bias(bias_h, i0, j0 + kBK, T, b_s + (buf ^ 1) * kBias);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile jt (and, at jt = 0, the q tile) has landed
    __syncthreads();
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;
    const float* bt = b_s + buf * kBias;

    // s = q k^T: 8 key columns per fragment
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      // this warp's 16 q rows, d ks*16 .. +15, as an A fragment: read again
      // each tile rather than held, to keep registers for more blocks an SM
      uint32_t qa[4];
      ldmatrix_x4(qa, q_s + swz(warp * 16 + lane % 16, ks * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kb[4];  // keys np*16 .. +7 (d lo, d hi), keys +8 .. +15 (d lo, d hi)
        ldmatrix_x4(kb, kt + swz(np * 16 + (lane / 16) * 8 + lane % 8,
                                 ks * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, bias, mask; online softmax per fragment row (a quad shares a row)
    const bool edge = j0 + kBK > len;
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + (e / 2) * 8, col = nt * 8 + 2 * t4 + e % 2;
        float x = fmaf(s[nt][e], kScale, bt[col - row + kBQ - 1]);
        if (edge && j0 + col >= len) x = kMasked;
        s[nt][e] = x;
        tmax[e / 2] = fmaxf(tmax[e / 2], x);
      }
    float alpha[2], m_log2[2];  // exp(x - m) = exp2(x log2(e) - m log2(e))
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      tmax[rh] = fmaxf(tmax[rh], __shfl_xor_sync(0xffffffffu, tmax[rh], 1));
      tmax[rh] = fmaxf(tmax[rh], __shfl_xor_sync(0xffffffffu, tmax[rh], 2));
      const float m_new = fmaxf(m[rh], tmax[rh]);
      alpha[rh] = exp2f((m[rh] - m_new) * kLog2e);
      m[rh] = m_new;
      m_log2[rh] = m_new * kLog2e;
      l[rh] *= alpha[rh];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], kLog2e, -m_log2[e / 2]));
        s[nt][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

    // o += p v, p rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];  // d dp*16 .. +7 (keys lo, keys hi), d +8 .. +15 (keys lo, keys hi)
        ldmatrix_x4_trans(vb, vt + swz(kk * 16 + ((lane / 8) % 2) * 8 + lane % 8,
                                       dp * 16 + (lane / 16) * 8));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // epilogue: normalise in f32, stage this warp's rows in q_s, 16-byte stores
  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    inv[rh] = l[rh] > 0.f ? 1.f / l[rh] : 0.f;
  }
  cp_async_wait<0>();  // with no key tile, the q tile's copies may still be in flight
  __syncthreads();
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      *reinterpret_cast<uint32_t*>(q_s + swz(warp * 16 + g + rh * 8, dt * 8 + 2 * t4)) =
          pack_bf16(o[dt][2 * rh] * inv[rh], o[dt][2 * rh + 1] * inv[rh]);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * (kD / 8); c += 32) {
    const int r = warp * 16 + c / (kD / 8), col = (c % (kD / 8)) * 8;
    if (i0 + r < T)
      *reinterpret_cast<uint4*>(out + head + (size_t)(i0 + r) * kD + col) =
          *reinterpret_cast<const uint4*>(q_s + swz(r, col));
  }
}

}  // namespace
}  // namespace tt

// q, k, v, out: (B, H, T, 64) bf16 contiguous; bias: (H, 2T-1) f32;
// valid_len: (B,) int32. Returns the launch's CUDA error, 0 on success.
extern "C" int tt_flash_rel_attn(const void* q, const void* k, const void* v, const void* bias,
                                 const void* valid_len, void* out, int B, int H, int T,
                                 void* stream) {
  using namespace tt;
  if (B < 1 || H < 1 || T < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_rel_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_rel_attn_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const int*>(valid_len),
      static_cast<bf16*>(out), H, T);
  return (int)cudaGetLastError();
}
