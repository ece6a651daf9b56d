// K4: UnivNet's location-variable convolution (LVC), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/lvc_pallas.py
// (location_variable_convolution_pallas -> _lvc_kernel). Same contract:
// x (B, F*hop, Ci), kernels (B, F, Ci, Co, K), bias (B, F, Co) -> out
// (B, F*hop, Co), float32. Each hop-long frame of x is convolved with its own
// (Ci, Co, K) kernel, 'same' padding: the K-1 halo rows come from the
// neighbouring frames, zeros past the clip's ends. The TPU kernel leaves the
// bias to XLA; here it is added in the epilogue.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), UnivNet c32 (Ci=32, Co=64, K=3) at F=2186 frames, B=1:
//   hop=8:   61 MB a call, 54 MB of it the frames' 24 KB kernels, 0.22 GFLOP:
//            bytes, ~18 us;
//   hop=64:  108 MB, 1.7 GFLOP: bytes, ~32 us;
//   hop=256: 269 MB (~80 us), 6.9 GFLOP (~103 us): f32 FMAs.
// The products stay f32 FMAs on the CUDA cores (TF32 tensor cores keep ~3
// decimal digits; the contract is full f32).
//
// The design. A block of 256 threads takes a tile of `frames` consecutive
// frames of one batch row (the launch plan, ops/lvc.py plan_lvc, picks
// rows_per_thread R, frames, the input channels a stage and the stage's
// layout, which tt_lvc checks against what the kernel reads) and walks the
// input channels in stages through a ring of four in shared memory, filled
// by cp.async while the stage before computes. A stage holds, for its
// channels, every frame's (Co, K) weights and the tile's x segment
// time-contiguous ([channel][tile rows + K - 1], the halo rows included,
// zeros past the clip's ends). A thread owns R consecutive rows of one frame
// by 8 output channels (4o..4o+3 and 4(o+G)..4(o+G)+3, G = Co/8, so the
// eight threads of a quarter warp read 8 different 16-byte weight chunks on
// 8 different bank quads): per input channel it loads the R + K - 1 x values
// it needs once (16-byte loads for R = 4, 8) and serves all K taps from
// registers, loads its 8 x K weights in 16-byte loads, and does R x 8 x K
// FMAs; at R = 8, K = 3 that is 9 16-byte shared loads per 192 FMAs.
// The plan weighs R against the card's 132 SMs: the blocks an SM its
// registers allow (2 at R = 8, 3 below) and the share of the last wave's
// block slots the tiles fill.
//   hop=256: R = 8 fills a frame with the block's 32 x 8 rows; FMAs set the
//            pace, 2 blocks an SM, 2186 tiles in 8.3 waves.
//   hop=64:  R = 4, 2 frames a block: 1093 tiles fill 92% of 3 waves (R = 8
//            would make 547, 69% of 3); on the predictor's layout R = 8, 4
//            frames, whose kernels use half of each 32-byte sector (2
//            frames: a quarter).
//   hop=8:   R = 2, 8 frames a block: 274 tiles, all resident at once, two
//            or three an SM, so every SM streams; every thread has rows.
// Four stages (at most 28 KB each, and a ring that leaves room for the
// blocks the registers allow) keep three stages a block in flight while
// one computes.
// Layouts. x may be channels-last or the transposed view of a channels-first
// conv output (UnivNet's: time-contiguous rows, copied as they lie). The
// kernels' (Ci, Co, K) dims must lie as one run of stride km: each frame's
// block contiguous (km = 1, 16-byte copies), or frames innermost, as the
// predictor's conv leaves them (km = F, frame stride 1): then the block's
// frames of one weight are adjacent, and 4-byte copies along frames read
// them coalesced, transposing into the stage's [frame][Ci][Co][K] order;
// each asks L2 to prefetch 256 bytes, the next tiles' frames of the weight,
// which the blocks beside it read next.
#include "mma.cuh"

namespace tt {
namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kOut = 8;  // output channels a thread

struct LvcArgs {
  const float* x;
  const float* kern;
  const float* bias;
  float* out;
  int B, T, F, hop, Ci, Co;
  long long xb, xt, xi;  // x (b, t, i) at b*xb + t*xt + i*xi
  long long kb, kf, km;  // kernels (b, f, m = (i*Co + o)*K + k) at b*kb + f*kf + m*km
  long long bb, bf, bo;  // bias (b, f, o) at b*bb + f*bf + o*bo
  int frames;            // frames a block
  int channels;          // input channels a stage
  int w_frame;           // floats of one frame's weights in a stage (the plan's)
  int x_row;             // floats of one channel's x segment in a stage (the plan's)
  int stage;             // floats of a stage
  int vec;               // kernels copyable in 16-byte pieces (km == 1, aligned)
};

// cp_async4 with a 256-byte L2 prefetch: a 4-byte copy of the predictor's
// frames-innermost kernels brings its neighbours' frames into L2 with it,
// so the blocks of the next tiles find them there
__device__ __forceinline__ void cp_async4_l2(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// the floats of x a thread with R rows loads from its first row on: R + K - 1,
// in whole 16-byte loads when R is a multiple of 4 (ops/lvc.py x_reads)
__host__ __device__ constexpr int x_reads(int R, int K) {
  return R % 4 == 0 ? (R + K - 1 + 3) / 4 * 4 : R + K - 1;
}

// x values xs[0 .. R + K - 2] into registers: 16-byte loads where the rows
// start 16-byte aligned (R a multiple of 4), the tail read past into padding
template <int R, int K>
struct XRegs {
  static constexpr int N = x_reads(R, K);
  float v[N];
  __device__ __forceinline__ void load(const float* xs) {
    if constexpr (R % 4 == 0) {
#pragma unroll
      for (int e = 0; e < N / 4; ++e) {
        const float4 q = reinterpret_cast<const float4*>(xs)[e];
        v[4 * e] = q.x, v[4 * e + 1] = q.y, v[4 * e + 2] = q.z, v[4 * e + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = xs[e];
    }
  }
};

// fn(i, o) for every i < n_in, o < n_out, the block's threads taking the
// pairs in order with i fastest (neighbouring threads on neighbouring i),
// without a division a pair
template <typename Fn>
__device__ __forceinline__ void walk(int n_in, int n_out, Fn fn) {
  int i = threadIdx.x % n_in, o = threadIdx.x / n_in;
  const int di = kThreads % n_in, dout = kThreads / n_in;
  while (o < n_out) {
    fn(i, o);
    i += di, o += dout;
    if (i >= n_in) i -= n_in, ++o;
  }
}

// blocks an SM the register budget allows: 2 for the 8-row tile (64
// accumulators), 3 below; ops/lvc.py plan_lvc counts on these (BLOCKS_PER_SM)
template <int R>
constexpr int kMinBlocks = R == 8 ? 2 : 3;

template <int R, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<R>) lvc_kernel(const LvcArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = (K - 1) / 2;
  const int G = a.Co / kOut;
  const int og = threadIdx.x % G, rg = threadIdx.x / G;
  const int f0 = blockIdx.x * a.frames, b = blockIdx.y;
  const int nf = min(a.frames, a.F - f0);
  const int rows = nf * a.hop;   // the tile's output rows
  const int seg = rows + K - 1;  // its x rows, the halo included
  const int u0 = rg * R;         // the thread's first row in the tile
  const int j = u0 / a.hop;      // its frame in the tile
  const bool active = u0 < rows;
  const int mk = a.Co * K;  // weights of one input channel
  const int chunks = (a.Ci + a.channels - 1) / a.channels;
  const long long t0 = (long long)f0 * a.hop - P;

  // stage c: input channels c*channels.. of every frame's weights and of x
  const auto load = [&](int c) {
    float* ws = smem + (c % kStages) * a.stage;
    float* xs = ws + a.frames * a.w_frame;
    const int i0 = c * a.channels, nic = min(a.channels, a.Ci - i0);
    const int m = nic * mk;
    const float* kp = a.kern + b * a.kb + f0 * a.kf + (long long)i0 * mk * a.km;
    if (a.vec)  // each frame's block contiguous: 16-byte copies along it
      walk(m / 4, nf, [&](int q, int jj) {
        cp_async16(ws + jj * a.w_frame + 4 * q, kp + jj * a.kf + 4 * q, 16);
      });
    else        // frames innermost: 4-byte copies along frames, transposed
      walk(nf, m, [&](int jj, int mm) {
        cp_async4_l2(ws + jj * a.w_frame + mm, kp + jj * a.kf + mm * a.km);
      });
    const float* xp = a.x + b * a.xb + i0 * a.xi;
    // zeros past the clip's ends
    const auto copy_x = [&](int ii, int u) {
      const long long t = t0 + u;
      const bool in = t >= 0 && t < a.T;
      cp_async4(xs + ii * a.x_row + u, in ? xp + t * a.xt + ii * a.xi : a.x, in ? 4 : 0);
    };
    if (a.xt == 1)  // channels-first: along time
      walk(seg, nic, [&](int u, int ii) { copy_x(ii, u); });
    else            // channels-last: along channels
      walk(nic, seg, copy_x);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }

  float acc[R][kOut];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[r][o] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage c have landed
    __syncthreads();               // everyone's; and stage c - 1's slot is read
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const float* ws = smem + (c % kStages) * a.stage;
    const float* xs = ws + a.frames * a.w_frame + u0;
    const float* wp = ws + j * a.w_frame + og * 4 * K;  // w[i][4 og + e][k] at wp[i*mk + e*K + k]
    const int nic = min(a.channels, a.Ci - c * a.channels);
    for (int ii = 0; ii < nic; ++ii) {
      XRegs<R, K> xr;
      xr.load(xs + ii * a.x_row);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float w[4 * K];
        const float4* w4 = reinterpret_cast<const float4*>(wp + ii * mk + g * G * 4 * K);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          const float4 v = w4[e];
          w[4 * e] = v.x, w[4 * e + 1] = v.y, w[4 * e + 2] = v.z, w[4 * e + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < K; ++k)
              acc[r][4 * g + e] = fmaf(xr.v[r + k], w[e * K + k], acc[r][4 * g + e]);
      }
    }
  }
  if (!active) return;

  const int f = f0 + j, s0 = u0 - j * a.hop;
  const float* bp = a.bias + b * a.bb + f * a.bf;
  float bv[kOut];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[4 * g + e] = __ldg(bp + (4 * (og + g * G) + e) * a.bo);
  float* op = a.out + ((size_t)b * a.T + (size_t)f * a.hop + s0) * a.Co;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (s0 + r >= a.hop) break;  // a frame's last rows (R need not divide hop)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(op + r * a.Co + 4 * (og + g * G)) =
          make_float4(acc[r][4 * g] + bv[4 * g], acc[r][4 * g + 1] + bv[4 * g + 1],
                      acc[r][4 * g + 2] + bv[4 * g + 2], acc[r][4 * g + 3] + bv[4 * g + 3]);
  }
}

template <int R, int K>
cudaError_t launch(const LvcArgs& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lvc_kernel<R, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  lvc_kernel<R, K><<<dim3((a.F + a.frames - 1) / a.frames, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_rows(int R, const LvcArgs& a, size_t smem, cudaStream_t stream) {
  switch (R) {
    case 1: return launch<1, K>(a, smem, stream);
    case 2: return launch<2, K>(a, smem, stream);
    case 4: return launch<4, K>(a, smem, stream);
    default: return launch<8, K>(a, smem, stream);
  }
}

}  // namespace
}  // namespace tt

// x: (B, F*hop, Ci) f32, element (b, t, i) at b*xb + t*xt + i*xi with xt == 1
// or xi == 1; kernels: f32, element (b, f, i, o, k) at b*kb + f*kf +
// ((i*Co + o)*K + k)*km (km = 1: each frame's block contiguous, as a slice of
// the predictor's output made contiguous; kf = 1, km = F: the predictor's own
// frames-innermost layout); bias: f32, element (b, f, o) at b*bb + f*bf +
// o*bo; out: (B, F*hop, Co) f32 contiguous, 16-byte aligned. The launch plan
// (ops/lvc.py plan_lvc): rows_per_thread R in {1, 2, 4, 8}, `frames` frames
// a block, `channels` input channels a stage, and the stage's layout:
// `w_frame` floats of each frame's weights, then `x_row` floats of each
// channel's x, `smem` bytes for the ring of kStages stages. Needs Co a
// multiple of 8 with Co / 8 dividing 256, K in {1, 3, 5, 7}, a tile of
// frames x hop rows within the block's (256 / (Co / 8)) x R rows, R dividing
// hop unless a block holds one frame, a layout of whole 16-byte pieces that
// holds the stage's weights and the x every thread loads, and a ring of
// `smem` bytes within 227 KB. Returns the launch's CUDA error, 0 on success.
extern "C" int tt_lvc(const void* x, const void* kernels, const void* bias, void* out, int B,
                      int F, int hop, int Ci, int Co, int K, long long xb, long long xt,
                      long long xi, long long kb, long long kf, long long km, long long bb,
                      long long bf, long long bo, int rows_per_thread, int frames, int channels,
                      int w_frame, int x_row, int smem, void* stream) {
  using namespace tt;
  const int R = rows_per_thread;
  if (B < 1 || F < 1 || hop < 1 || Ci < 1 || Co < kOut || Co % kOut != 0 ||
      kThreads % (Co / kOut) != 0 || (K != 1 && K != 3 && K != 5 && K != 7) ||
      (xt != 1 && xi != 1) || (R != 1 && R != 2 && R != 4 && R != 8) || frames < 1 ||
      channels < 1 || (long long)frames * hop > (long long)(kThreads / (Co / kOut)) * R ||
      (hop % R != 0 && frames != 1) || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // the layout: whole 16-byte pieces, a frame's weights, and the x of the
  // last thread with rows (its loads may run past the tile's segment)
  const int tile = frames * hop;
  const long long stage = (long long)frames * w_frame + (long long)channels * x_row;
  if (w_frame % 4 != 0 || x_row % 4 != 0 || w_frame < channels * Co * K ||
      x_row < ((tile + R - 1) / R - 1) * R + x_reads(R, K) ||
      (long long)smem != kStages * stage * (long long)sizeof(float) || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  LvcArgs a;
  a.x = static_cast<const float*>(x);
  a.kern = static_cast<const float*>(kernels);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.T = F * hop, a.F = F, a.hop = hop, a.Ci = Ci, a.Co = Co;
  a.xb = xb, a.xt = xt, a.xi = xi, a.kb = kb, a.kf = kf, a.km = km;
  a.bb = bb, a.bf = bf, a.bo = bo;
  a.frames = frames, a.channels = channels;
  a.w_frame = w_frame, a.x_row = x_row, a.stage = (int)stage;
  a.vec = km == 1 && kb % 4 == 0 && kf % 4 == 0 && reinterpret_cast<uintptr_t>(kernels) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 1: e = launch_rows<1>(R, a, smem, s); break;
    case 3: e = launch_rows<3>(R, a, smem, s); break;
    case 5: e = launch_rows<5>(R, a, smem, s); break;
    default: e = launch_rows<7>(R, a, smem, s); break;
  }
  return (int)e;
}
