// K7 and K8: the data-movement and contraction probes of the Pallas TPU
// harness tools/probe_mosaic_ops.py, hand-written for Hopper (sm_90a).
//
// K7 replaces `run` (:18) and its seven kernel bodies (:39-76): each probe
// below computes what its body computes, on f32 inputs, with its indices
// written out, so a transposed or shifted index shows as a wrong value:
//   1 collapse reshape (B, ck, H) -> (B*ck, H)
//   2 split reshape (B, ck*H) -> (B, ck, H)
//   3 static lane slice (B, H, T)[..., 32:64]
//   4 dynamic lane slice (B, H, T)[..., start:start+32], start at run time
//   5 transpose (B, H, ck) -> (B, ck, H)
//   6 contraction (B, H, ck) x (C, H) over H -> (B, ck, C)
//   7 broadcast multiply (B, H, ck) * (B, 1, ck)
// One thread an output element (a grid-stride loop); the five data movers
// and the broadcast multiply are bit-exact by construction, the contraction
// sums its 16 products in order, each product rounded apart (no fma).
//
// K8 replaces `timed_probes.timeit` (:87) and its four bodies (:119-150):
// bf16 operands, f32 sums, out[bt, i, j] = sum_r A[bt, i, r] * B[bt, r, j]
// over operands given by their element strides, so one kernel takes each
// orientation of K2's attention inner loop as it lies in memory:
//   o1 logits (B, ck, C) x (B, C, H) -> (B, ck, H)
//   o2 logits (B, H, C) x (B, ck, C) -> (B, H, ck)
//   p_exp (B*ck, H) x (H, C) -> (B*ck, C)
//   pv (B, H, ck) x (B, ck, C) -> (B, H, C)
// A warp per output row (bt, i) with f32 accumulation, in one of two forms:
// lanes split the contraction and a warp sum closes each output (o1, o2:
// long r, few outputs a row), or lanes own output columns and loop over r
// (p_exp, pv: short r, 1024 outputs a row, the B operand read coalesced).
// bf16 products are exact in f32, so only the order of the f32 sums differs
// from the plain version. No tensor cores: the first version is plain.
//
// What bounds them on an H100: bytes. K7's calls move 0.05-8.6 MB each; at
// the probe shapes (B=64, ck=128, C=1024, H=16) o1 and o2 read 19 MB
// (about 6 us at 3.35 TB/s), p_exp writes 34 MB, pv moves 21 MB; their
// arithmetic is at most 268 MFLOP.
#include "common.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long first_index() { return (long)blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ long index_stride() { return (long)gridDim.x * blockDim.x; }

// 1: out (B*ck, H) from x (B, ck, H)
__global__ void collapse_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                                int CK, int H) {
  const long n = (long)B * CK * H;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long r = o / H, h = o % H;
    const long b = r / CK, k = r % CK;
    out[o] = x[(b * CK + k) * H + h];
  }
}

// 2: out (B, ck, H) from x (B, ck*H)
__global__ void split_kernel(const float* __restrict__ x, float* __restrict__ out, int B, int CK,
                             int H) {
  const long n = (long)B * CK * H;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long b = o / ((long)CK * H), k = (o / H) % CK, h = o % H;
    out[o] = x[b * ((long)CK * H) + k * H + h];
  }
}

// 3: out (B, H, 32) = x (B, H, T)[..., 32:64]
__global__ void static_slice_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                                    int H, int T) {
  const long n = (long)B * H * 32;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long bh = o / 32, j = o % 32;
    out[o] = x[bh * T + 32 + j];
  }
}

// 4: out (B, H, 32) = x (B, H, T)[..., start:start+32]
__global__ void dynamic_slice_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                                     int H, int T, int start) {
  const long n = (long)B * H * 32;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long bh = o / 32, j = o % 32;
    out[o] = x[bh * T + start + j];
  }
}

// 5: out (B, ck, H) = x (B, H, ck) transposed
__global__ void transpose_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                                 int CK, int H) {
  const long n = (long)B * CK * H;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long b = o / ((long)CK * H), k = (o / H) % CK, h = o % H;
    out[o] = x[(b * H + h) * CK + k];
  }
}

// 6: out (B, ck, C)[b, k, c] = sum_h p (B, H, ck)[b, h, k] * m (C, H)[c, h]
__global__ void contract_kernel(const float* __restrict__ p, const float* __restrict__ m,
                                float* __restrict__ out, int B, int CK, int H, int C) {
  const long n = (long)B * CK * C;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long b = o / ((long)CK * C), k = (o / C) % CK, c = o % C;
    float acc = 0.f;
    for (int h = 0; h < H; ++h)
      acc = __fadd_rn(acc, __fmul_rn(p[(b * H + h) * CK + k], m[c * H + h]));
    out[o] = acc;
  }
}

// 7: out (B, H, ck) = x (B, H, ck) * s (B, 1, ck)
__global__ void broadcast_kernel(const float* __restrict__ x, const float* __restrict__ s,
                                 float* __restrict__ out, int B, int H, int CK) {
  const long n = (long)B * H * CK;
  for (long o = first_index(); o < n; o += index_stride()) {
    const long b = o / ((long)H * CK), k = o % CK;
    out[o] = __fmul_rn(x[o], s[b * CK + k]);
  }
}

struct Strides {
  long a_bt, a_i, a_r, b_bt, b_r, b_j;
};

// K8: out (BT, I, J) contiguous f32. kLanesOverR: lanes split r, a warp sum
// per output; else lanes own output columns j, j + 32, ... and loop over r.
template <bool kLanesOverR>
__global__ void __launch_bounds__(kThreads)
contraction_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                   float* __restrict__ out, int BT, int I, int J, int R, Strides s) {
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;  // (bt, i)
  if (row >= (long)BT * I) return;
  const long bt = row / I, i = row % I;
  const bf16* a = A + bt * s.a_bt + i * s.a_i;
  const bf16* b = Bm + bt * s.b_bt;
  float* o = out + row * J;
  if (kLanesOverR) {
    for (int j = 0; j < J; ++j) {
      float acc = 0.f;
      for (int r = lane; r < R; r += 32)
        acc = fmaf(__bfloat162float(a[r * s.a_r]), __bfloat162float(b[r * s.b_r + j * s.b_j]),
                   acc);
      acc = warp_sum(acc);
      if (lane == 0) o[j] = acc;
    }
  } else {
    for (int j = lane; j < J; j += 32) {
      float acc = 0.f;
      for (int r = 0; r < R; ++r)
        acc = fmaf(__bfloat162float(a[r * s.a_r]), __bfloat162float(b[r * s.b_r + j * s.b_j]),
                   acc);
      o[j] = acc;
    }
  }
}

int blocks_for(long n) {
  const long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? b : 4096);
}

}  // namespace
}  // namespace tt

// K7. probe 1-7 as listed above; x, y (the second input of probes 6 and 7,
// else unused) and out contiguous f32 on the device. Shapes: B, CK, H, T, C;
// start is probe 4's first column. Returns the first CUDA error, 0 on success.
extern "C" int tt_probe(int probe, const float* x, const float* y, float* out, int B, int CK,
                        int H, int T, int C, int start, void* stream) {
  using namespace tt;
  if (B < 1 || CK < 1 || H < 1 || T < 64 || C < 1 || start < 0 || start + 32 > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long bkh = (long)B * CK * H;
  switch (probe) {
    case 1: collapse_kernel<<<blocks_for(bkh), kThreads, 0, st>>>(x, out, B, CK, H); break;
    case 2: split_kernel<<<blocks_for(bkh), kThreads, 0, st>>>(x, out, B, CK, H); break;
    case 3:
      static_slice_kernel<<<blocks_for((long)B * H * 32), kThreads, 0, st>>>(x, out, B, H, T);
      break;
    case 4:
      dynamic_slice_kernel<<<blocks_for((long)B * H * 32), kThreads, 0, st>>>(x, out, B, H, T,
                                                                             start);
      break;
    case 5: transpose_kernel<<<blocks_for(bkh), kThreads, 0, st>>>(x, out, B, CK, H); break;
    case 6:
      contract_kernel<<<blocks_for((long)B * CK * C), kThreads, 0, st>>>(x, y, out, B, CK, H, C);
      break;
    case 7: broadcast_kernel<<<blocks_for(bkh), kThreads, 0, st>>>(x, y, out, B, H, CK); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8. out (BT, I, J) contiguous f32 = sum over r of A[bt, i, r] B[bt, r, j],
// A and B bf16 on the device addressed by element strides (a batch stride
// of 0 shares an operand across the batch). lanes_over_r picks the form.
extern "C" int tt_contraction(const void* A, const void* B, float* out, int BT, int I, int J,
                              int R, long a_bt, long a_i, long a_r, long b_bt, long b_r, long b_j,
                              int lanes_over_r, void* stream) {
  using namespace tt;
  if (BT < 1 || I < 1 || J < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const Strides s{a_bt, a_i, a_r, b_bt, b_r, b_j};
  const long rows = (long)BT * I;
  const long grid = (rows + kWarps - 1) / kWarps;
  if (grid > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  if (lanes_over_r)
    contraction_kernel<true><<<(unsigned)grid, kThreads, 0, st>>>(a, b, out, BT, I, J, R, s);
  else
    contraction_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(a, b, out, BT, I, J, R, s);
  return (int)cudaGetLastError();
}
