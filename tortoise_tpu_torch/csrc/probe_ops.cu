// K7 and K8: the data-movement and contraction probes of the Pallas TPU
// harness tools/probe_mosaic_ops.py, hand-written for Hopper (sm_90a).
//
// K7 replaces `run` (:18) and its seven kernel bodies (:39-76): each probe
// below computes what its body computes, on f32 inputs:
//   1 collapse reshape (B, ck, H) -> (B*ck, H)
//   2 split reshape (B, ck*H) -> (B, ck, H)
//   3 static lane slice (B, H, T)[..., 32:64]
//   4 dynamic lane slice (B, H, T)[..., start:start+32], start at run time
//   5 transpose (B, H, ck) -> (B, ck, H)
//   6 contraction (B, H, ck) x (C, H) over H -> (B, ck, C)
//   7 broadcast multiply (B, H, ck) * (B, 1, ck)
// What bounds them on an H100: bytes, 0.05-8.6 MB a call (0.015-2.6 us at
// 3.35 TB/s), so a call's time is mostly the launch. On the device each
// moves 16 bytes a thread (float4 loads and stores, neighbouring threads on
// neighbouring addresses) with 32-bit index arithmetic, in a grid that
// covers its output once:
//   1, 2 are the identity on row-major memory: a float4 copy;
//   3, 4 take eight threads a 32-lane row slice, a float4 each (4 with a
//     start that is not a multiple of 4 reads four floats a thread);
//   5 goes a b a block through a shared tile whose rows are padded by one
//     float, so both the row-wise writes and the column-wise reads are
//     coalesced in device memory;
//   6 stages a block's 128-column slice of m (transposed, so a thread reads
//     four c's of one h as a float4) and its two b's slices of p in shared
//     memory; each thread writes a float4 of outputs along c for four k's,
//     each output's 16 products rounded apart and summed over h in order
//     (__fmul_rn / __fadd_rn, no fma), so it equals the plain version bit
//     for bit;
//   7 multiplies a float4 of x by a float4 of s.
// The five data movers and the broadcast multiply are bit-exact by
// construction. The sizes the vector paths need (ck, H, C, T multiples of
// 4, 16-byte aligned pointers) are checked at the entry point.
//
// K8 replaces `timed_probes.timeit` (:87) and its four bodies (:119-150):
// bf16 operands, f32 sums, out[bt, i, j] = sum_r A[bt, i, r] * B[bt, r, j]
// over operands given by their element strides, so one kernel takes each
// orientation of K2's attention inner loop as it lies in memory:
//   o1 logits (B, ck, C) x (B, C, H) -> (B, ck, H)
//   o2 logits (B, H, C) x (B, ck, C) -> (B, H, ck)
//   p_exp (B*ck, H) x (H, C) -> (B*ck, C)
//   pv (B, H, ck) x (B, ck, C) -> (B, H, C)
// A tiled tensor-core contraction (mma.sync m16n8k16, bf16 in, f32 sums):
// a block computes one bt's BM x BN output tile, the tile shape chosen on
// the host from (I, J) so that BT x tiles fills the 132 SMs (32 x 16 with
// two warps splitting r for o1, 16 x 32 for o2 and pv, 64 x 128 for
// p_exp). Each operand comes into shared memory as bf16 laid out for
// ldmatrix: through 16-byte cp.async copies where its innermost stride is 1
// and its rows are 16-byte aligned (B kept as [r][n] and read with
// ldmatrix.trans when n is the unit-stride dim, as [n][r] when r is: o2's
// B is a transposed view), else through element loads that transpose on
// the way in; 128-deep stages in a cp.async ring of up to four (three in
// flight while one is computed) where r is long. Edge tiles are predicated
// (zero-filled), so any I, J, R works. The epilogue sums the warps' partial
// tiles in a fixed order (no atomics) and writes 16-byte rows. bf16
// products are exact in f32, so only the order of the f32 sums differs from
// the plain version.
//
// What bounds K8 on an H100: bytes. At the probe shapes (B=64, ck=128,
// C=1024, H=16) o1 and o2 read 19 MB
// (about 6 us at 3.35 TB/s), p_exp writes 34 MB, pv moves 21 MB; their
// arithmetic is at most 268 MFLOP. o1 and o2 give 256 blocks, two an SM,
// each walking a 1024-deep r: the per-stage cost of issuing the copies and
// meeting at the barrier, not the tensor cores or the bytes in flight, sets
// their pace (a deeper stage shortens them, a longer ring does not). TMA
// loads into wgmma, with the host's launch cost cut, is the next step.
#include "mma.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;                 // K7
constexpr int kSliceLanes = 32;               // probes 3, 4: lanes of the slice
constexpr int kContractC = 128;               // probe 6: c of a block
constexpr int kContractB = 2;                 // probe 6: b of a block
constexpr int kContractH = 16;                // probe 6: H, the sum's length
constexpr int kContractRow = kContractC + 4;  // probe 6: shared row of m's slice

__device__ __forceinline__ int thread_index() { return blockIdx.x * blockDim.x + threadIdx.x; }

// 1, 2: out = x, n4 float4s
__global__ void copy_kernel(const float4* __restrict__ x, float4* __restrict__ out, int n4) {
  const int i = thread_index();
  if (i < n4) out[i] = x[i];
}

// 3, 4: out (R, 32) = x (R, T)[:, start:start+32]; output float4 i is lanes
// 4 (i % 8) .. +3 of row i / 8
template <bool kVec>
__global__ void slice_kernel(const float* __restrict__ x, float4* __restrict__ out, int rows,
                             int T, int start) {
  const int i = thread_index();
  if (i >= rows * (kSliceLanes / 4)) return;
  const float* src = x + (i / (kSliceLanes / 4)) * T + start + (i % (kSliceLanes / 4)) * 4;
  out[i] = kVec ? *reinterpret_cast<const float4*>(src)
                : make_float4(src[0], src[1], src[2], src[3]);
}

// 5: out (B, ck, H) = x (B, H, ck) transposed, block b; tile [H][CK + 1]
__global__ void transpose_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                                 int CK) {
  extern __shared__ float tile[];
  const int n4 = H * CK / 4, row = CK + 1;
  const float4* src = reinterpret_cast<const float4*>(x) + blockIdx.x * n4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = src[i];
    float* t = tile + (4 * i / CK) * row + 4 * i % CK;  // four k's of one h
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out) + blockIdx.x * n4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float* t = tile + (4 * i % H) * row + 4 * i / H;  // four h's of one k
    dst[i] = make_float4(t[0], t[row], t[2 * row], t[3 * row]);
  }
}

// 6: out (B, ck, C)[b, k, c] = sum_h p (B, H, ck)[b, h, k] * m (C, H)[c, h];
// block (c0 = 128 x, b0 = 2 y). Shared: m_s [H][kContractRow] holds
// m[c0 + c, h] at [h][c]; p_s [kContractB][H][CK] p's b-slice. A thread
// takes a float4 along c for four k's, so each m load serves 16 outputs.
// H is the probes' 16, a constant, so the loop over h unrolls.
__global__ void __launch_bounds__(kThreads)
contract_kernel(const float* __restrict__ p, const float* __restrict__ m, float* __restrict__ out,
                int B, int CK, int C) {
  constexpr int H = kContractH;
  extern __shared__ float4 smem4[];
  float* m_s = reinterpret_cast<float*>(smem4);
  float* p_s = m_s + H * kContractRow;
  const int c0 = blockIdx.x * kContractC, b0 = blockIdx.y * kContractB;
  const int nc = min(kContractC, C - c0), nb = min(kContractB, B - b0);
  const float4* m4 = reinterpret_cast<const float4*>(m + c0 * H);
  for (int i = threadIdx.x; i < nc * H / 4; i += blockDim.x) {
    const float4 v = m4[i];
    float* t = m_s + (4 * i % H) * kContractRow + 4 * i / H;  // four h's of one c
    t[0] = v.x;
    t[kContractRow] = v.y;
    t[2 * kContractRow] = v.z;
    t[3 * kContractRow] = v.w;
  }
  const float4* p4 = reinterpret_cast<const float4*>(p + b0 * H * CK);
  for (int i = threadIdx.x; i < nb * H * CK / 4; i += blockDim.x)
    reinterpret_cast<float4*>(p_s)[i] = p4[i];
  __syncthreads();
  // a warp: 32 float4s along c of the same (b, k's): p broadcast, m
  // conflict-free, each k's stores 512 contiguous bytes
  const int n4 = nc / 4, nk = CK / 4;
  for (int i = threadIdx.x; i < nb * nk * n4; i += blockDim.x) {
    const int c4 = i % n4, k0 = i / n4 % nk * 4, bb = i / (n4 * nk);
    const float* pk = p_s + bb * H * CK + k0;
    const float* mc = m_s + 4 * c4;
    float4 acc[4] = {};
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float4 mv = *reinterpret_cast<const float4*>(mc + h * kContractRow);
      const float4 pv = *reinterpret_cast<const float4*>(pk + h * CK);
      const float pk4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(pk4[j], mv.x));
        acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(pk4[j], mv.y));
        acc[j].z = __fadd_rn(acc[j].z, __fmul_rn(pk4[j], mv.z));
        acc[j].w = __fadd_rn(acc[j].w, __fmul_rn(pk4[j], mv.w));
      }
    }
    float* o = out + ((b0 + bb) * CK + k0) * C + c0 + 4 * c4;
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<float4*>(o + j * C) = acc[j];
  }
}

// 7: out (B, H, ck) = x (B, H, ck) * s (B, 1, ck), n4 float4s of x
__global__ void broadcast_kernel(const float4* __restrict__ x, const float4* __restrict__ s,
                                 float4* __restrict__ out, int n4, int H, int CK4) {
  const int i = thread_index();
  if (i >= n4) return;
  const float4 a = x[i], v = s[i / (H * CK4) * CK4 + i % CK4];
  out[i] = make_float4(__fmul_rn(a.x, v.x), __fmul_rn(a.y, v.y), __fmul_rn(a.z, v.z),
                       __fmul_rn(a.w, v.w));
}

__global__ void null_kernel() {}

struct Strides {
  long a_bt, a_i, a_r, b_bt, b_r, b_j;
};

// K8: out (BT, I, J) contiguous f32. One block computes a BM x BN tile of
// one bt's output with WM x WN x WK warps: each warp a (BM/WM) x (BN/WN)
// tile over every WK-th 16-deep step of r, the WK partial tiles summed in
// order in the epilogue.
constexpr int kDepth = 128;         // r of one pipeline stage
constexpr int kRRow = kDepth + 8;   // padded shared row along r (272 bytes)

template <int BM, int BN, int WM, int WN, int WK, int STAGES>
struct Tile {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int kWTM = BM / WM, kWTN = BN / WN;  // one warp's output tile
  static constexpr int kMT = kWTM / 16, kNT = kWTN / 8;
  static constexpr int kNRow = BN + 8;  // padded shared row of an (r, n) B tile
  static constexpr int kA = BM * kRRow;
  static constexpr int kB = kDepth * kNRow > BN * kRRow ? kDepth * kNRow : BN * kRRow;
  static constexpr int kCRow = BN + 4;
  static constexpr size_t kStage = (size_t)(kA + kB) * sizeof(bf16);
  static constexpr size_t kEpi = (size_t)WK * BM * kCRow * sizeof(float);
  // shared bytes for a call of `chunks` stages' worth of r: no more stages
  // than it has chunks, so a shallow call keeps its blocks an SM
  static size_t smem(int chunks) {
    const size_t main = (size_t)(chunks < STAGES ? chunks : STAGES) * kStage;
    return main > kEpi ? main : kEpi;
  }
  static_assert(kWTM % 16 == 0 && kWTN % 16 == 0, "a warp tile is whole 16 x 16 fragments");
};

// f(x) for x = threadIdx.x, threadIdx.x + kThreads, ... below `limit`, at
// most kCount (a full stage's slots). Up to four slots a thread the loop is
// unrolled, so the index arithmetic of each x, the same in every stage, is
// worked out once; more would cost more registers than it saves.
template <int kCount, int kThreads, class F>
__device__ __forceinline__ void for_each_slot(int limit, F f) {
  if constexpr (kCount <= 4 * kThreads) {
#pragma unroll
    for (int it = 0; it < (kCount + kThreads - 1) / kThreads; ++it) {
      const int x = threadIdx.x + it * kThreads;
      if (x < limit) f(x);
    }
  } else {
#pragma unroll 1
    for (int x = threadIdx.x; x < limit; x += kThreads) f(x);
  }
}

// One stage: A rows i0.. x r0 .. r0+depth-1 as [m][r]; B rows r0.. x cols
// j0.. as [r][n] (kBKN) or [n][r]; depth is a multiple of 16, the r the
// stage's mma steps read. Unit-stride operands with 16-byte aligned rows
// come in through cp.async (a partial chunk at an edge copies its valid
// bytes and zero-fills the rest); any other layout through element loads
// that transpose on the way in. Everything outside (I, J, R) is zero.
template <class T_, bool kBKN>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ a, const bf16* __restrict__ b,
                                           bf16* As, bf16* Bs, int i0, int j0, int r0,
                                           int depth, int I, int J, int R, const Strides& s,
                                           bool a_vec, bool b_vec) {
  constexpr int BM = T_::kBM, BN = T_::kBN, kThreads = T_::kThreads;
  constexpr int kC = kDepth / 8;  // 16-byte chunks along r in a full stage
  if (a_vec) {
    for_each_slot<BM * kC, kThreads>(BM * kC, [&](int x) {
      const int m = x / kC, c = x % kC, i = i0 + m, r = r0 + c * 8;
      if (c * 8 >= depth) return;
      const int n = i < I ? max(0, min(8, R - r)) : 0;
      cp_async16(As + m * kRRow + c * 8, n ? a + i * s.a_i + r : a, 2 * n);
    });
  } else {
    const bool by_i = s.a_i == 1;  // walk the unit-stride dim fastest
    for (int x = threadIdx.x; x < BM * depth; x += kThreads) {
      const int m = by_i ? x % BM : x / depth, k = by_i ? x / BM : x % depth;
      const int i = i0 + m, r = r0 + k;
      As[m * kRRow + k] = i < I && r < R ? a[i * s.a_i + r * s.a_r] : __float2bfloat16(0.f);
    }
  }
  if (kBKN && b_vec) {
    for_each_slot<kDepth * (BN / 8), kThreads>(depth * (BN / 8), [&](int x) {
      const int k = x / (BN / 8), c = x % (BN / 8), r = r0 + k, j = j0 + c * 8;
      const int n = r < R ? max(0, min(8, J - j)) : 0;
      cp_async16(Bs + k * T_::kNRow + c * 8, n ? b + r * s.b_r + j : b, 2 * n);
    });
  } else if (kBKN) {
    for (int x = threadIdx.x; x < depth * BN; x += kThreads) {
      const int k = x / BN, n = x % BN, r = r0 + k, j = j0 + n;
      Bs[k * T_::kNRow + n] = r < R && j < J ? b[r * s.b_r + j * s.b_j] : __float2bfloat16(0.f);
    }
  } else if (b_vec) {
    for_each_slot<BN * kC, kThreads>(BN * kC, [&](int x) {
      const int n = x / kC, c = x % kC, j = j0 + n, r = r0 + c * 8;
      if (c * 8 >= depth) return;
      const int cnt = j < J ? max(0, min(8, R - r)) : 0;
      cp_async16(Bs + n * kRRow + c * 8, cnt ? b + j * s.b_j + r : b, 2 * cnt);
    });
  } else {
    for (int x = threadIdx.x; x < BN * depth; x += kThreads) {
      const int n = x / depth, k = x % depth, r = r0 + k, j = j0 + n;
      Bs[n * kRRow + k] = r < R && j < J ? b[r * s.b_r + j * s.b_j] : __float2bfloat16(0.f);
    }
  }
}

template <int BM, int BN, int WM, int WN, int WK, int STAGES, bool kBKN>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN, WK, STAGES>::kThreads)
contraction_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                   float* __restrict__ out, int I, int J, int R, Strides s, bool a_vec,
                   bool b_vec) {
  using T_ = Tile<BM, BN, WM, WN, WK, STAGES>;
  // stage st: A [BM][kRRow] at st * (kA + kB), then B [kDepth][kNRow] or [BN][kRRow]
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + T_::kA;
  constexpr int kStride = T_::kA + T_::kB;
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM, bt = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int wk = warp / (WM * WN), wm = (warp % (WM * WN)) / WN, wn = warp % WN;
  const bf16* a = A + bt * s.a_bt;
  const bf16* b = Bm + bt * s.b_bt;

  float acc[T_::kMT][T_::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T_::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T_::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n_chunks = (R + kDepth - 1) / kDepth;
  // the r a chunk's mma steps read: kDepth, less in a short last chunk
  const auto depth = [R](int c) { return (min(kDepth, R - c * kDepth) + 15) / 16 * 16; };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks)
      load_stage<T_, kBKN>(a, b, As + st * kStride, Bs + st * kStride, i0, j0, st * kDepth,
                           depth(st), I, J, R, s, a_vec, b_vec);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();              // and every warp is done with chunk c - 1's stage
    const int nxt = c + STAGES - 1;
    if (nxt < n_chunks)
      load_stage<T_, kBKN>(a, b, As + (nxt % STAGES) * kStride, Bs + (nxt % STAGES) * kStride,
                           i0, j0, nxt * kDepth, depth(nxt), I, J, R, s, a_vec, b_vec);
    cp_async_commit();
    const bf16* at = As + (c % STAGES) * kStride;
    const bf16* bt_s = Bs + (c % STAGES) * kStride;
    for (int ks = wk; ks < depth(c) / 16; ks += WK) {
      uint32_t af[T_::kMT][4];
#pragma unroll
      for (int mt = 0; mt < T_::kMT; ++mt)
        ldmatrix_x4(af[mt], at + (wm * T_::kWTM + mt * 16 + lane % 16) * kRRow + ks * 16 +
                                (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < T_::kNT / 2; ++np) {
        uint32_t bf[4];  // cols np*16 .. +7 (r lo, r hi), cols +8 .. +15 (r lo, r hi)
        if (kBKN)
          ldmatrix_x4_trans(bf, bt_s + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * T_::kNRow +
                                    wn * T_::kWTN + np * 16 + (lane / 16) * 8);
        else
          ldmatrix_x4(bf, bt_s + (wn * T_::kWTN + np * 16 + (lane / 16) * 8 + lane % 8) * kRRow +
                              ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < T_::kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the WK partial tiles through shared memory, summed in order,
  // written as 16-byte rows of 4 floats where J allows
  float* c_s = reinterpret_cast<float*>(smem);  // [WK][BM][kCRow]
#pragma unroll
  for (int mt = 0; mt < T_::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T_::kNT; ++nt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = wm * T_::kWTM + mt * 16 + g + rh * 8, col = wn * T_::kWTN + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(c_s + (wk * BM + row) * T_::kCRow + col) =
            make_float2(acc[mt][nt][2 * rh], acc[mt][nt][2 * rh + 1]);
      }
  __syncthreads();
  float* o = out + (long)bt * I * J;
  for (int x = threadIdx.x; x < BM * (BN / 4); x += T_::kThreads) {
    const int row = x / (BN / 4), col = (x % (BN / 4)) * 4, i = i0 + row, j = j0 + col;
    if (i >= I || j >= J) continue;
    float4 v = *reinterpret_cast<const float4*>(c_s + row * T_::kCRow + col);
#pragma unroll
    for (int w = 1; w < WK; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(c_s + (w * BM + row) * T_::kCRow + col);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    float* dst = o + (long)i * J + j;
    if (J % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vals[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && j + e < J; ++e) dst[e] = vals[e];
    }
  }
}

template <int BM, int BN, int WM, int WN, int WK, int STAGES>
int launch_contraction(const bf16* a, const bf16* b, float* out, int BT, int I, int J, int R,
                       const Strides& s, bool a_vec, bool b_kn, bool b_vec, cudaStream_t st) {
  using T_ = Tile<BM, BN, WM, WN, WK, STAGES>;
  const dim3 grid((J + BN - 1) / BN, (I + BM - 1) / BM, BT);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = b_kn ? contraction_kernel<BM, BN, WM, WN, WK, STAGES, true>
                     : contraction_kernel<BM, BN, WM, WN, WK, STAGES, false>;
  const size_t smem = T_::smem((R + kDepth - 1) / kDepth);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, T_::kThreads, smem, st>>>(a, b, out, I, J, R, s, a_vec, b_vec);
  return (int)cudaGetLastError();
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace tt

// K7. probe 1-7 as listed above; x, y (the second input of probes 6 and 7,
// else null) and out contiguous f32 on the device, 16-byte aligned. Shapes:
// B, CK, H, T, C, with CK, H, T and C multiples of 4 (probe 6: H = 16);
// start is probe 4's first column. Returns the first CUDA error, 0 on
// success.
extern "C" int tt_probe(int probe, const float* x, const float* y, float* out, int B, int CK,
                        int H, int T, int C, int start, void* stream) {
  using namespace tt;
  const long int_max = 0x7fffffffL;
  if (B < 1 || CK < 4 || H < 4 || T < 64 || C < 4 || CK % 4 || H % 4 || T % 4 || C % 4 ||
      start < 0 || start + kSliceLanes > T || (long)B * H * T > int_max ||
      (long)B * CK * C > int_max || !aligned16(x) || !aligned16(y) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bkh4 = B * CK * H / 4, rows = B * H;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  switch (probe) {
    case 1:
    case 2: copy_kernel<<<blocks(bkh4), kThreads, 0, st>>>(x4, out4, bkh4); break;
    case 3:
      slice_kernel<true><<<blocks(rows * kSliceLanes / 4), kThreads, 0, st>>>(x, out4, rows, T,
                                                                              32);
      break;
    case 4:
      if (start % 4 == 0)
        slice_kernel<true><<<blocks(rows * kSliceLanes / 4), kThreads, 0, st>>>(x, out4, rows, T,
                                                                                start);
      else
        slice_kernel<false><<<blocks(rows * kSliceLanes / 4), kThreads, 0, st>>>(x, out4, rows, T,
                                                                                 start);
      break;
    case 5: {
      const size_t smem = (size_t)H * (CK + 1) * sizeof(float);
      if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
      transpose_kernel<<<B, 128, smem, st>>>(x, out, H, CK);
      break;
    }
    case 6: {
      const size_t smem = (size_t)H * (kContractRow + kContractB * CK) * sizeof(float);
      if (H != kContractH || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
      const dim3 grid((C + kContractC - 1) / kContractC, (B + kContractB - 1) / kContractB);
      contract_kernel<<<grid, kThreads, smem, st>>>(x, y, out, B, CK, C);
      break;
    }
    case 7:
      broadcast_kernel<<<blocks(bkh4), kThreads, 0, st>>>(
          x4, reinterpret_cast<const float4*>(y), out4, bkh4, H, CK / 4);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An empty kernel: what a launch through the wrappers' ctypes path costs.
extern "C" int tt_null(void* stream) {
  tt::null_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// K8. out (BT, I, J) contiguous f32 = sum over r of A[bt, i, r] B[bt, r, j],
// A and B bf16 on the device addressed by element strides (a batch stride
// of 0 shares an operand across the batch). The tile shape follows (I, J):
// 32 x 16 tiles with two warps down r for a narrow output (o1), 16 x 32 for
// a short one (o2, pv), 64 x 128 for a large one (p_exp).
extern "C" int tt_contraction(const void* A, const void* B, float* out, int BT, int I, int J,
                              int R, long a_bt, long a_i, long a_r, long b_bt, long b_r, long b_j,
                              void* stream) {
  using namespace tt;
  if (BT < 1 || I < 1 || J < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const Strides s{a_bt, a_i, a_r, b_bt, b_r, b_j};
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const bool a_vec = a_r == 1 && a_i % 8 == 0 && a_bt % 8 == 0 && (uintptr_t)A % 16 == 0;
  const bool b_kn = b_j <= b_r;  // n the faster dim: stage B as [r][n]
  const bool b_vec = (b_kn ? b_j == 1 && b_r % 8 == 0 : b_r == 1 && b_j % 8 == 0) &&
                     b_bt % 8 == 0 && (uintptr_t)B % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (J <= 16)
    return launch_contraction<32, 16, 2, 1, 2, 4>(a, b, out, BT, I, J, R, s, a_vec, b_kn, b_vec,
                                                  st);
  if (I <= 16)
    return launch_contraction<16, 32, 1, 2, 2, 4>(a, b, out, BT, I, J, R, s, a_vec, b_kn, b_vec,
                                                  st);
  return launch_contraction<64, 128, 2, 2, 1, 2>(a, b, out, BT, I, J, R, s, a_vec, b_kn, b_vec,
                                                  st);
}
