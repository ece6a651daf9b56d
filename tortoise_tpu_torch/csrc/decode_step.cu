// K2: one GPT-2 decode step over all layers, hand-written for Hopper (sm_90a),
// as one persistent kernel launch.
//
// Replaces the Pallas TPU kernel tortoise_tpu/ops/decode_step_pallas.py
// (fused_decode_step -> _kernel), with both of its static branches: bf16 or
// int8 weights (quant_w) and a bf16 or int8 KV cache (quantized), so four
// variants, the template arguments (WT, CT) of the one kernel. Same contract:
// the residual stream is bf16; every dense product accumulates in f32; bf16
// weights round it to bf16 and then add the bf16 bias, int8 weights
// (per-output-channel qscale) compute acc * qscale + bias in f32 and round
// once; layer norms take f32 statistics (eps 1e-5); attention is an f32
// softmax over the cache prefix [0, pos) plus the current, never-cached row.
// The int8 cache holds int8 rows and f32 scales (L, B, H, T), T-minor: k
// scales multiply the logits, v scales multiply the softmax weights before
// the PV product while the sum l runs over the unscaled weights. The current
// row comes from the qkv product unquantized, so with the int8 cache this
// step differs from the plain layer stack (which reads back its own
// quantized row) by at most that row's quantization error. The cache is
// read-only: the new k/v rows come back in k_rows/v_rows and the caller
// (quantizes and) writes them.
//
// What bounds it on an H100: bytes. A step must read the 30 layers' weights
// once, 30 x 25.2 MB = 755 MB in bf16 (int8: 378 MB), and the cache prefix,
// B x 30 x pos x C x 4 bytes in bf16: 61 MB at B=1, pos=500 (0.24 ms at
// 3.35 TB/s for the step), 983 MB at B=16, pos=500 (0.52 ms), 6.68 GB at
// B=96, pos=566 (2.22 ms). Its products do 2 x B x 12 C^2 operations a
// layer, 72 GFLOP a step at B=96: ~0.1 ms on the tensor cores, ~1.1 ms on
// the CUDA cores, so they run on the tensor cores.
//
// The step's phases each read what the one before wrote. Launched as one
// kernel a phase (151 a step: four products and the attention a layer, and
// the first layer norm's statistics), each phase paid a drain and a fill,
// and at B=96 the products ran at a tenth of their bytes' bound. Here one
// cooperative launch holds one block an SM (the occupancy API sizes the
// grid) for the whole step and walks 1 + 7 L phases with a grid-wide
// barrier (an arrival counter in device memory) after each:
//   0. xn = LN1(x) of layer 0                          (row pass)
// then per layer
//   1. qkv's pieces: xn Wqkv^T, K split over blocks    (product)
//   2. attention over the prefix and the current row, which sums qkv's
//      pieces itself and writes the new k/v rows
//   3. proj's pieces: attn Wproj^T                     (product)
//   4. x += proj + b; xn = LN2(x)                      (row pass)
//   5. fc: ffn = gelu_new(xn Wfc^T + b)                (product, its tiles finished in place)
//   6. fc2's pieces: ffn Wfc2^T                        (product)
//   7. x += fc2 + b; xn = LN1(x) of the next layer     (row pass)
// What a phase streams from device memory does not depend on the
// activations: weights and the cache's prefix rows. So a producer warp in
// each block walks the block's share of every phase in order and has the
// tensor memory accelerator copy those boxes (a 64 x 64 weight tile, or 32
// rows of a head's k and v) into a ring of 9 KB slots (all the shared memory
// the products' inputs leave, 19 to 24), as far ahead as the ring has room,
// across the barriers its consumers wait at: the weight stream runs through
// the step. Sixteen consumer warps wait at the barriers and take the ring's
// slots in the same order (an mbarrier a slot each way).
//
// The products: bf16 mma.sync m16n8k16 with f32 sums, "swap AB": a tile is 64
// output features (the mma's M side, W rows, the row-major A operand) and
// every batch row (the n8 side: X (B, K) row-major is the column-major B
// operand), so each weight is read from device memory once a step whatever
// B is. The copies land swizzled (128-byte rows of bf16, 64-byte rows of
// int8) as ldmatrix reads them without bank conflicts; int8 W tiles become
// bf16 A fragments in registers, exactly; a K step's even and odd 16-deep
// slices sum apart and add at the end of a piece. The four warps of each
// quarter of the batch rows (up to 128 rows a launch; the wrapper launches
// larger batches in parts) take the 64 features 16 each; the input's K step
// of every row comes in by the same accelerator, two steps ahead. Each
// product's N/64 x K/64 tile steps are cut into one contiguous share a
// block (each block's weight bytes within one tile step of the others'), so
// a tile's K is split over the few blocks whose shares it crosses; each
// writes its piece's f32 sums to a workspace. The consumer of a product
// sums a tile's pieces in piece order and runs the epilogue (bias, qscale,
// gelu, the residual), so no float atomics: two calls give bit-equal
// outputs. qkv's pieces are summed by the attention items that read them;
// fc's by the blocks of each tile once its counter shows every piece (row r
// by piece r mod pieces); proj's and fc2's by a row pass, a block a row,
// which also takes the row's layer norm (f32 mean and variance over the row,
// eps 1e-5) for the next product's input xn.
//
// The attention: one work item per (batch row, head, split of the prefix),
// the items cut into one contiguous share a block and given to its warps,
// sixteen at a time (at B=1 the prefix is split so that B x H x splits fills
// the grid, from B=16 it is not). A warp holds q and its item's sums; its
// four groups of eight lanes take the slot's rows four apart, 8 dims a lane
// (the row layout of K5, csrc/decode_attn_kv128.cu), with one running max
// and rescale a slot. A split leaves its (acc, m, l) in a workspace and the
// last split of its (b, h) to arrive merges them in split order with the
// current row's f32 weight. Rounding: each slot rounds p = exp(s - m_run)
// to bf16 before the PV sum, m_run the item's running max; the plain version
// rounds relative to the global max, so the two differ by at most one bf16
// ulp per weight, rescaled in f32 (the TPU kernel's chunked online softmax
// rounds this way too).
//
// The kernel keeps the name tc_gemm_kernel<WT, CT>, weight type first: the
// benchmark's frozen table of kernel families (portbench/trace.py) maps that
// name to "K2 gemm" ("K2 gemm int8" for signed char weights), and K2's
// roofline divides its bound by that family's device time.
#include <cuda.h>

#include <algorithm>

#include "mma.cuh"

namespace tt {
namespace {

constexpr int kHeadDim = 64;
constexpr float kLnEps = 1e-5f;
constexpr float kLogitScale = 0.125f;  // 1/sqrt(kHeadDim)

constexpr int kTM = 64;                          // output features of a tile
constexpr int kBK = 64;                          // K depth of a tile step
constexpr int kWarps = 16;                       // consumer warps
constexpr int kThreads = kWarps * 32;            // consumer threads
constexpr int kBlockThreads = kThreads + 32;     // and the producer warp
constexpr int kMaxRows = 128;                    // batch rows of a launch
constexpr int kRowWarps = kWarps / 4;            // warps along the batch rows
constexpr int kNJ = kMaxRows / 16 / kRowWarps;   // 16-row groups a warp holds, at most
constexpr int kSmemBytes = 232448;               // a block's shared memory on the H100: all
constexpr int kScratchOff = 0;                   // the row pass's sums, the ring's `issued`
constexpr int kMaxSlots = 24;                    // the producer's ring, at most
constexpr int kBarOff = 256;                     // its mbarriers, then the X stages'
constexpr int kXOff = 1024;                      // the consumers' X stages, then the ring
constexpr int kXStages = 3;                      // the consumers' X ring
constexpr int kXBars = 4;                        // its mbarriers (four K steps at once up to 16 rows)
constexpr int kQuarterBytes = 4 * 4 * 32 * 8 * 4;  // up to 16 rows: the quarters' sums to add
constexpr int kSlotBytes = 9216;                 // a W tile, or k and v rows and their scales
static_assert(kBarOff + (2 * kMaxSlots + kXBars) * 8 <= kXOff, "the mbarriers");
constexpr int kSplitStride = kHeadDim + 4;       // floats of an attention split's (acc, m, l)

// The sync words (unsigned, zero between calls): the barriers' arrivals,
// the blocks that finished, then fc's tile counters and each (b, h)'s split
// counter.
constexpr int kSyncHeader = 64;

enum ProductKind { kQkv = 0, kProj = 1, kFc = 2, kFc2 = 3 };

template <typename CT>
__host__ __device__ constexpr int stage_rows() { return 8192 / (2 * kHeadDim * (int)sizeof(CT)); }

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
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

// --- synchronisation -------------------------------------------------------

// The consumer warps only (the producer never waits with them).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Every wait of the step ends in microseconds. One that lasts ~10 s of SM
// cycles waits for something that never comes (a fault elsewhere, or a
// schedule the two sides disagree on): trap, so the launch fails rather than
// holding the card.
constexpr long long kWaitLimitCycles = 20000000000ll;

__device__ __forceinline__ void check_wait(long long t0) {
  if (clock64() - t0 > kWaitLimitCycles) __trap();
}

// Spins until *p >= target.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned target) {
  const long long t0 = clock64();
  while (ld_acquire(p) < target) check_wait(t0);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// The grid's barriers: the n-th of the launch waits for n x blocks arrivals
// on one counter. Every block's consumers reach it before any goes on; their
// writes before it are visible to every block's reads after it.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& n) {
  ++n;
  consumer_sync();
  if (threadIdx.x == 0) {
    atom_add_release(count, 1u);
    wait_count(count, n * gridDim.x);
  }
  consumer_sync();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) check_wait(t0);
}

// `count` arrivals at once (a slot that one warp reads stands for all).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned count = 1) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(count)
      : "memory");
}

// This thread's arrival, and `bytes` more that copies will bring.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The barrier's phase also waits for this thread's cp.asyncs so far (not an
// arrival of its own).
__device__ __forceinline__ void cp_async_arrive_pending(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// A box of a 2-D tensor map into shared memory (the tensor memory
// accelerator); completion counts on the mbarrier. c0: the inner coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The ring: slot f % slots takes the block's f-th copy of the step. full:
// the producer's lane 0 arrives and its boxes' bytes land; empty: each consumer warp arrives
// when it has read the slot (a warp that alone reads it, for all). A wait
// tells two uses of a slot apart by parity only, so a consumer first waits
// until the producer holds copy f (`issued` > f: copy f - slots is read),
// which keeps a warp that runs ahead in the attention from taking an older
// phase of the slot for the one it wants.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  volatile int* issued;
  int slots;
  int f, s;        // the next copy, its slot
  unsigned round;  // and the parity of its slot's use

  __device__ void next() {
    ++f;
    if (++s == slots) s = 0, round ^= 1u;
  }
  __device__ void advance(int n) {
    f += n;
    s = f % slots;
    round = (unsigned)(f / slots) & 1u;
  }
  // producer: slot f, once its last copy is read
  __device__ unsigned char* acquire() {
    mbar_wait(&empty[s], round ^ 1u);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) *issued = f + 1;
    return base + s * kSlotBytes;
  }
  __device__ uint64_t* full_bar() const { return &full[s]; }
  // consumers: copy i (slot i % slots, parity (i / slots) & 1) has landed
  __device__ const unsigned char* wait(int i, int slot, unsigned parity) const {
    if (*issued <= i) {
      const long long t0 = clock64();
      while (*issued <= i) check_wait(t0);
    }
    mbar_wait(&full[slot], parity);
    return base + slot * kSlotBytes;
  }
  // consumers that take every copy in order, in step (the products):
  // copy f - slots is theirs, and read
  __device__ const unsigned char* wait_next() const {
    mbar_wait(&full[s], round);
    return base + s * kSlotBytes;
  }
  __device__ void release(int slot, unsigned count = 1) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot], count);
  }
};

// --- the schedule ------------------------------------------------------------

// Block g's share of U work units is [lo(g), lo(g + 1)); owner(u) is the
// block whose share holds unit u. ops/decode_step.py's plan computes the same.
__device__ __forceinline__ int share_lo(int g, int blocks, int units) {
  return (int)((unsigned)g * (unsigned)units / (unsigned)blocks);
}
__device__ __forceinline__ int owner(int u, int blocks, int units) {
  return (int)(((unsigned)(u + 1) * (unsigned)blocks - 1u) / (unsigned)units);
}

// A product's U tile steps go to its first min(blocks, U) blocks, so that
// every block of a tile's pieces holds some.
struct Share {
  int lo, hi;
};

__device__ __forceinline__ Share product_share(int units) {
  const int blocks = min((int)gridDim.x, units), g = blockIdx.x;
  if (g >= blocks) return {units, units};
  return {share_lo(g, blocks, units), share_lo(g + 1, blocks, units)};
}

struct Layout {
  int rows, xbytes, ring_off, slots;
};

struct StepArgs {
  // boxes the tensor memory accelerator copies: the cache's k and v ((L Bt
  // T rows, C columns), a slot's rows of a head), the weights ((L N rows, K
  // columns), a 64 x 64 tile, swizzled as ldmatrix reads it) and the
  // products' inputs xn, attn, ffn ((B rows, K columns), a K step of every
  // row, rows past B read as zeros)
  CUtensorMap kmap, vmap, wmap[4], xmap[3];
  bf16 *x, *xn, *attn, *ffn;   // this launch's rows; xn: the LN of x the next product reads
  const bf16 *ln1, *ln2;
  const void *bqkv, *bproj, *bfc, *bfc2;
  const float *sqkv, *sproj, *sfc, *sfc2;  // int8 weights only
  const float *k_scale, *v_scale;          // int8 cache only, at this launch's first row
  bf16 *k_rows, *v_rows;                   // at this launch's first row
  float* part;                             // (blocks, max_pieces, B, 64)
  float* attn_part;                        // (B, H, splits, kSplitStride), splits > 1
  unsigned* sync;
  // null, or (1 + 7 L phases, blocks, 4) ns stamps: [1] a block's
  // consumers done with the phase's own work, [2] past its barrier, [3] its
  // producer starting the phase's copies
  unsigned long long* trace;
  int L, B, Bt, row0, T, C, pos, attn_rows, splits, max_pieces;
};

// The consumers' X stages and the producer's ring of a launch: kXStages
// stages of a K step of every row (16-row groups x 128 bytes; up to 16 rows
// four stages and the quarters' sums); the ring of 9 KB slots (1024-byte
// aligned, as the tensor memory accelerator's 128-byte swizzle wants) takes
// the rest.
__device__ __forceinline__ Layout layout(const StepArgs& a) {
  Layout y;
  y.rows = (a.B + 15) & ~15;
  y.xbytes = y.rows * kBK * 2;
  const int xregion = y.rows == 16 ? 4 * y.xbytes + kQuarterBytes : kXStages * y.xbytes;
  y.ring_off = (kXOff + xregion + 1023) / 1024 * 1024;  // for 128-byte swizzles
  y.slots = min(kMaxSlots, (kSmemBytes - y.ring_off) / kSlotBytes);
  return y;
}

// One product of layer l.
struct Product {
  const CUtensorMap* wmap;  // (L N, K)
  const CUtensorMap* xmap;  // (B, K)
  const unsigned char* bias;
  const float* qscale;      // int8 W only
  int N, K;
};

template <typename WT>
__device__ __forceinline__ Product product(const StepArgs& a, int l, int kind) {
  const int C = a.C;
  Product d;
  const void* b;
  const float* s;
  switch (kind) {
    case kQkv:
      d.N = 3 * C, d.K = C, b = a.bqkv, s = a.sqkv, d.xmap = &a.xmap[0];
      break;
    case kProj:
      d.N = C, d.K = C, b = a.bproj, s = a.sproj, d.xmap = &a.xmap[1];
      break;
    case kFc:
      d.N = 4 * C, d.K = C, b = a.bfc, s = a.sfc, d.xmap = &a.xmap[0];
      break;
    default:
      d.N = C, d.K = 4 * C, b = a.bfc2, s = a.sfc2, d.xmap = &a.xmap[2];
      break;
  }
  d.wmap = &a.wmap[kind];
  constexpr size_t kBiasBytes = sizeof(WT) == 1 ? sizeof(float) : sizeof(bf16);
  d.bias = static_cast<const unsigned char*>(b) + (size_t)l * d.N * kBiasBytes;
  d.qscale = sizeof(WT) == 1 ? s + (size_t)l * d.N : nullptr;
  return d;
}

// A tile's pieces: the blocks whose shares cross its K steps, in order, and
// the first one's piece index (the later ones' shares start in the tile:
// their piece 0).
struct Pieces {
  int q0, count, first;
};

__device__ __forceinline__ Pieces pieces(int t, int S, int units) {
  const int blocks = min((int)gridDim.x, units);
  const int q0 = owner(t * S, blocks, units);
  return {q0, owner(t * S + S - 1, blocks, units) - q0 + 1,
          t - share_lo(q0, blocks, units) / S};
}

// Offset (floats) of row 0 of piece q of the tile in the workspace.
__device__ __forceinline__ size_t piece_offset(const StepArgs& a, const Pieces& p, int q) {
  return (size_t)((p.q0 + q) * a.max_pieces + (q == 0 ? p.first : 0)) * a.B * kTM;
}

// The epilogue's value of one product sum: bf16 weights round the f32 sum to
// bf16 and add the bf16 bias (rounding again); int8 weights compute
// acc * qscale + bias in f32 (no FMA contraction) and round once.
template <bool kQuant>
__device__ __forceinline__ float dense_out(float acc, float bias, float qs) {
  return kQuant ? round_bf16(__fadd_rn(__fmul_rn(acc, qs), bias))
                : round_bf16(round_bf16(acc) + bias);
}

// The attention item i of this launch: (batch row, head, split) and its
// prefix rows [r0, r0 + rows).
struct Item {
  int b, h, split, bh, r0, rows;
};

__device__ __forceinline__ Item item(const StepArgs& a, int i) {
  Item it;
  const int H = a.C / kHeadDim;
  it.bh = i / a.splits;
  it.split = i - it.bh * a.splits;
  it.b = it.bh / H;
  it.h = it.bh - it.b * H;
  it.r0 = it.split * a.attn_rows;
  it.rows = max(0, min(a.pos, it.r0 + a.attn_rows) - it.r0);
  return it;
}

template <typename CT>
__device__ __forceinline__ int item_stages(const Item& it) {
  return (it.rows + stage_rows<CT>() - 1) / stage_rows<CT>();
}

// --- the producer --------------------------------------------------------------

template <typename WT>
__device__ void produce_product(const StepArgs& a, int l, int kind, Ring& ring) {
  const Product d = product<WT>(a, l, kind);
  const int S = d.K / kBK, U = d.N / kTM * S;
  const Share sh = product_share(U);
  for (int u = sh.lo; u < sh.hi; ++u) {
    unsigned char* st = ring.acquire();
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive_expect(ring.full_bar(), kTM * kBK * sizeof(WT));
      tma_load(st, d.wmap, (u % S) * kBK, l * d.N + (u / S) * kTM, ring.full_bar());
    }
    ring.next();
  }
}

// An attention slot: stage c of an item, the k rows at 0 and the v rows at
// 4096 (two boxes of the tensor maps, lane 0), with the int8 cache their k
// and v scales at 8192 and 8448 (cp.async, lanes 1-31, which the slot's
// barrier waits for too). The block's items go
// to its warps kWarps at a time: stage c of each item of a group, item by
// item, then stage c + 1; an item with fewer stages than the group's most
// takes empty slots.
template <typename CT>
__device__ void produce_attention(const StepArgs& a, int l, Ring& ring) {
  constexpr bool kQuant = sizeof(CT) == 1;
  constexpr int kSR = stage_rows<CT>();
  const int lane = threadIdx.x & 31;
  const int H = a.C / kHeadDim, I = a.B * H * a.splits;
  const int hi = share_lo(blockIdx.x + 1, gridDim.x, I);
  for (int i0 = share_lo(blockIdx.x, gridDim.x, I); i0 < hi; i0 += kWarps) {
    const int m = min(kWarps, hi - i0);
    int stages = 0;
    for (int k = 0; k < m; ++k) stages = max(stages, item_stages<CT>(item(a, i0 + k)));
    for (int c = 0; c < stages; ++c)
      for (int k = 0; k < m; ++k) {
        const Item it = item(a, i0 + k);
        const int c0 = c * kSR, n = min(kSR, it.rows - c0);  // n <= 0: an empty slot
        unsigned char* st = ring.acquire();
        uint64_t* full = ring.full_bar();
        if (kQuant && n > 0) {  // the rows' scales, lanes 1-31, before lane 0 arrives
          const size_t srow = (((size_t)l * a.Bt + it.b) * H + it.h) * a.T + it.r0 + c0;
          for (int x = lane - 1; x < n && lane > 0; x += 31) {
            cp_async4(st + 8192 + x * 4, a.k_scale + srow + x, 4);
            cp_async4(st + 8448 + x * 4, a.v_scale + srow + x, 4);
          }
          if (lane > 0) cp_async_arrive_pending(full);
        }
        __syncwarp();
        if (lane == 0) {
          if (n > 0) {
            const int row = (l * a.Bt + a.row0 + it.b) * a.T + it.r0 + c0;
            mbar_arrive_expect(full, 8192);
            tma_load(st, &a.kmap, it.h * kHeadDim, row, full);
            tma_load(st + 4096, &a.vmap, it.h * kHeadDim, row, full);
          } else {
            mbar_arrive(full);
          }
        }
        ring.next();
      }
  }
}

// The producer's phases, as the consumers' (consume) run them.
template <typename WT, typename CT>
__device__ void produce(const StepArgs& a, Ring& ring) {
  const auto stamp = [&](int ph) {
    if (a.trace && threadIdx.x == kThreads)
      a.trace[((size_t)ph * gridDim.x + blockIdx.x) * 4 + 3] = now_ns();
  };
  for (int l = 0; l < a.L; ++l)
    for (int k = 0; k < 6; ++k) {
      if (k == 3) continue;  // the row pass copies nothing
      stamp(1 + 7 * l + k);
      if (k == 1)
        produce_attention<CT>(a, l, ring);
      else
        produce_product<WT>(a, l, k == 0 ? kQkv : k == 2 ? kProj : k == 4 ? kFc : kFc2, ring);
    }
  cp_async_wait<0>();
}

// --- the consumers: products ----------------------------------------------------

// The block's share of a product's tile steps: each tile's piece of it
// summed in f32 into the workspace, [row][64].
template <typename WT>
__device__ void product_pieces(const StepArgs& a, int l, int kind, unsigned char* smem,
                               Ring& ring, int& xloads, int& xparity) {
  constexpr bool kQuant = sizeof(WT) == 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x, B = a.B;
  const Product d = product<WT>(a, l, kind);
  const int S = d.K / kBK, U = d.N / kTM * S;
  const Share sh = product_share(U);
  const int lo = sh.lo, hi = sh.hi;
  if (lo >= hi) return;
  const Layout y = layout(a);
  const int rows = y.rows;  // the n side, zero-filled past B
  const int groups = rows / 16, per = (groups + kRowWarps - 1) / kRowWarps;
  const int j0 = (warp >> 2) * per;          // the warp's first 16-row group
  const int nj = min(per, groups - j0);      // and its count (0 or less: none)
  // the K step's even and odd 16-deep slices sum apart (two mma chains of
  // half the depth), and add at a piece's end
  float acc[2][2 * kNJ][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2 * kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
  // one K step of the warp's 16 features: W tile st, X stage xs, the warp's
  // nj 16-row groups from j0
  const auto mma_step = [&](const unsigned char* st, const unsigned char* xs, int g0, int ng) {
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4];
      if (kQuant) {
        const int gq = lane >> 2, tq = lane & 3;
        const int q0 = (warp & 3) * 16 + gq, q1 = q0 + 8;
        const unsigned char* p0 = st + q0 * 64 + ((ks ^ ((q0 >> 1) & 3)) << 4);
        const unsigned char* p1 = st + q1 * 64 + ((ks ^ ((q1 >> 1) & 3)) << 4);
        af[0] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0 + 2 * tq));
        af[1] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1 + 2 * tq));
        af[2] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p0 + 8 + 2 * tq));
        af[3] = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p1 + 8 + 2 * tq));
      } else {
        const int r = (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ch = 2 * ks + (lane >> 4);
        ldmatrix_x4(af, st + r * 128 + ((ch ^ (r & 7)) << 4));
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (j < ng) {
          uint32_t bfr[4];
          const int r = (g0 + j) * 16 + (lane & 7) + (lane >> 4) * 8;
          const int ch = 2 * ks + ((lane >> 3) & 1);
          ldmatrix_x4(bfr, xs + r * 128 + ((ch ^ (r & 7)) << 4));
          mma_bf16(acc[ks & 1][2 * j], af, bfr[0], bfr[1]);
          mma_bf16(acc[ks & 1][2 * j + 1], af, bfr[2], bfr[3]);
        }
      }
    }
  };
  // the warp's sums (even and odd added) of the piece of tile t to dst, and
  // zeroed: rows g0 * 16 + .. of its 16 features
  const auto store_piece = [&](float* dst, int g0, int ng) {
    const int m = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 2 * kNJ; ++j) {
      if (j < 2 * ng) {
        const int b = g0 * 16 + j * 8 + 2 * (lane & 3);
        if (b < B) {
          dst[b * kTM + m] = acc[0][j][0] + acc[1][j][0];
          dst[b * kTM + m + 8] = acc[0][j][2] + acc[1][j][2];
        }
        if (b + 1 < B) {
          dst[(b + 1) * kTM + m] = acc[0][j][1] + acc[1][j][1];
          dst[(b + 1) * kTM + m + 8] = acc[0][j][3] + acc[1][j][3];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
    }
  };
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + kBarOff) + 2 * kMaxSlots;

  if (groups == 1) {
    // up to 16 rows: the four warp quarters take four K steps of a piece at
    // once (quarter q the round's step q), and add their sums in quarter
    // order at the piece's end; xparity holds the X barriers' phases
    const int q = warp >> 2;
    float* quarter = reinterpret_cast<float*>(smem + kXOff + 4 * y.xbytes);  // [q][warp & 3][lane][8]
    for (int u0 = lo; u0 < hi;) {
      const int t = u0 / S, end = min(hi, (t + 1) * S);
      for (int r0 = u0; r0 < end; r0 += 4) {
        const int cnt = min(4, end - r0);
        consumer_sync();  // the last round's stages are read
        if (tid == kThreads - 32)
          for (int i = 0; i < cnt; ++i) {
            mbar_arrive_expect(&xfull[i], y.xbytes);
            tma_load(smem + kXOff + i * y.xbytes, d.xmap, ((r0 + i) % S) * kBK, 0, &xfull[i]);
          }
        if (q < cnt) {
          const int f = ring.f + q;
          mbar_wait(&xfull[q], (unsigned)(xparity >> q) & 1u);
          const unsigned char* st = ring.wait(f, f % ring.slots, (unsigned)(f / ring.slots) & 1u);
          mma_step(st, smem + kXOff + q * y.xbytes, 0, 1);
          ring.release(f % ring.slots, 4);  // a quarter's four warps stand for all sixteen
        }
        xparity ^= (1 << cnt) - 1;
        ring.advance(cnt);
      }
      // the piece ends: every quarter's sums, then quarter 0 adds them in order
      {
        float* mine = quarter + ((q * 4 + (warp & 3)) * 32 + lane) * 8;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[j * 4 + e] = acc[0][j][e] + acc[1][j][e];
      }
      consumer_sync();
      if (q == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = 0.f;
#pragma unroll
            for (int p = 0; p < 4; ++p) v += quarter[((p * 4 + warp) * 32 + lane) * 8 + j * 4 + e];
            acc[0][j][e] = v;
            acc[1][j][e] = 0.f;
          }
        store_piece(a.part + (size_t)(g * a.max_pieces + (t - lo / S)) * B * kTM, 0, 1);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2 * kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
      }
      u0 = end;
    }
    return;
  }

  // X stage of tile step u: a box of every row of the input at K offset
  // 64 (u % S); the launch's loads take the stages in turn. The last warp
  // issues them (at B <= 96 it holds no rows of the products).
  const auto load_x = [&](int u) {
    const int n = xloads + (u - lo);
    if (tid == kThreads - 32) {
      mbar_arrive_expect(&xfull[n % kXStages], y.xbytes);
      tma_load(smem + kXOff + (n % kXStages) * y.xbytes, d.xmap, (u % S) * kBK, 0,
               &xfull[n % kXStages]);
    }
  };
  for (int i = 0; i < kXStages - 1 && lo + i < hi; ++i) load_x(lo + i);
  int piece_end = min(hi, (lo / S + 1) * S);
  for (int u = lo; u < hi; ++u) {
    const int n = xloads + (u - lo);
    consumer_sync();  // stage u - 1 is read
    if (u + kXStages - 1 < hi) load_x(u + kXStages - 1);
    mbar_wait(&xfull[n % kXStages], (unsigned)(n / kXStages) & 1u);
    const unsigned char* xs = smem + kXOff + (n % kXStages) * y.xbytes;
    const unsigned char* st = ring.wait_next();
    if (nj > 0) mma_step(st, xs, j0, nj);
    ring.release(ring.s);
    ring.next();
    if (u + 1 == piece_end) {  // the piece of tile u / S ends: its sums to the workspace
      store_piece(a.part + (size_t)(g * a.max_pieces + (u / S - lo / S)) * B * kTM, j0, nj);
      piece_end = min(hi, piece_end + S);
    }
  }
  xloads += hi - lo;
}

// The sums of rows r of tile t over its pieces, in piece order, R rows at a
// time with up to kChunk pieces' loads of each in flight together: the
// lane's columns t * 64 + 2 lane, + 1.
template <int R, int kChunk>
__device__ __forceinline__ void sum_pieces(const StepArgs& a, int t, int S, int U,
                                           const int (&r)[R], float2 (&v)[R]) {
  const int lane = threadIdx.x & 31;
  const Pieces p = pieces(t, S, U);
#pragma unroll
  for (int e = 0; e < R; ++e) v[e] = make_float2(0.f, 0.f);
  for (int qc = 0; qc < p.count; qc += kChunk) {
    float2 x[R][kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const size_t off = piece_offset(a, p, min(qc + i, p.count - 1));
#pragma unroll
      for (int e = 0; e < R; ++e)
        x[e][i] = qc + i < p.count && r[e] < a.B
                      ? __ldcg(reinterpret_cast<const float2*>(a.part + off + (size_t)r[e] * kTM) +
                               lane)
                      : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (qc + i < p.count)
#pragma unroll
        for (int e = 0; e < R; ++e) {
          v[e].x += x[e][i].x;
          v[e].y += x[e][i].y;
        }
  }
}

// fc: once every piece of a tile is in (its counter), the blocks of the
// tile finish its rows (row r by piece r mod pieces): bias, gelu, ffn.
template <typename WT>
__device__ void fc_finish(const StepArgs& a, int l, unsigned char* smem) {
  constexpr bool kQuant = sizeof(WT) == 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x, B = a.B;
  const Product d = product<WT>(a, l, kFc);
  const int S = d.K / kBK, U = d.N / kTM * S;
  const Share sh = product_share(U);
  const int lo = sh.lo, hi = sh.hi;
  if (lo >= hi) return;
  unsigned* counters = a.sync + kSyncHeader;
  const int t_first = lo / S, t_last = (hi - 1) / S;
  consumer_sync();  // every thread's sums are written
  if (tid == 0) {
    __threadfence();
    for (int t = t_first; t <= t_last; ++t) atomicAdd(counters + t, 1u);
  }
  for (int t = t_first; t <= t_last; ++t) {
    const Pieces p = pieces(t, S, U);
    const int j = g - p.q0;
    if (j >= B) continue;  // no row of this tile is this block's
    const int n = t * kTM + 2 * lane;
    float2 bias, qs = make_float2(0.f, 0.f);
    if (kQuant) {
      bias = reinterpret_cast<const float2*>(reinterpret_cast<const float*>(d.bias) + n)[0];
      qs = reinterpret_cast<const float2*>(d.qscale + n)[0];
    } else {
      bias = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const bf16*>(d.bias) + n)[0]);
    }
    if (tid == 0) wait_count(counters + t, (unsigned)(l + 1) * p.count);
    consumer_sync();
    for (int k = warp; j + k * p.count < B; k += 2 * kWarps) {
      const int r[2] = {j + k * p.count, j + (k + kWarps) * p.count};
      float2 v[2];
      sum_pieces<2, 8>(a, t, S, U, r, v);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (r[e] < B)
          reinterpret_cast<__nv_bfloat162*>(a.ffn + (size_t)r[e] * d.N + n)[0] =
              __floats2bfloat162_rn(gelu_new(dense_out<kQuant>(v[e].x, bias.x, qs.x)),
                                    gelu_new(dense_out<kQuant>(v[e].y, bias.y, qs.y)));
    }
  }
}

// The sum of every consumer thread's `v` (each warp's lanes summed first,
// then the warps in order): every thread receives it.
__device__ __forceinline__ float block_total(float v, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  consumer_sync();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  consumer_sync();
  return t;
}

// A row pass: for each of the block's rows r, its new value y = x +
// dense(sum of the residual product's pieces) (kind proj or fc2; kind < 0:
// y = x, the step's first LN), written to x, and with `ln` its layer norm
// (f32 statistics over the row, eps 1e-5) written to xn for the next
// product.
template <typename WT>
__device__ void row_pass(const StepArgs& a, int l, int kind, const bf16* ln, unsigned char* smem) {
  constexpr bool kQuant = sizeof(WT) == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = a.C, tiles = C / kTM;
  float* scratch = reinterpret_cast<float*>(smem + kScratchOff);
  Product d;
  int S = 1, U = 1;
  if (kind >= 0) {
    d = product<WT>(a, l, kind);
    S = d.K / kBK;
    U = d.N / kTM * S;
  }
  // warp w holds the row's tile w (C <= 16 x 64), or none
  const bool has = warp < tiles;
  const int n = warp * kTM + 2 * lane;  // the lane's columns n, n + 1
  for (int r = blockIdx.x; r < a.B; r += gridDim.x) {
    float2 y = make_float2(0.f, 0.f);
    if (has) {
      y = __bfloat1622float2(
          __ldcg(reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)r * C + n)));
      if (kind >= 0) {
        const int rr[1] = {r};
        float2 v[1];
        sum_pieces<1, 8>(a, warp, S, U, rr, v);
        float2 bias, qs = make_float2(0.f, 0.f);
        if (kQuant) {
          bias = reinterpret_cast<const float2*>(reinterpret_cast<const float*>(d.bias) + n)[0];
          qs = reinterpret_cast<const float2*>(d.qscale + n)[0];
        } else {
          bias = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
              reinterpret_cast<const bf16*>(d.bias) + n)[0]);
        }
        const __nv_bfloat162 out =
            __floats2bfloat162_rn(dense_out<kQuant>(v[0].x, bias.x, qs.x) + y.x,
                                  dense_out<kQuant>(v[0].y, bias.y, qs.y) + y.y);
        reinterpret_cast<__nv_bfloat162*>(a.x + (size_t)r * C + n)[0] = out;
        y = __bfloat1622float2(out);
      }
    }
    if (!ln) continue;
    const float mean = block_total(y.x + y.y, scratch) / C;
    const float d0 = has ? y.x - mean : 0.f, d1 = has ? y.y - mean : 0.f;
    const float rstd = rsqrtf(block_total(d0 * d0 + d1 * d1, scratch) / C + kLnEps);
    if (has) {
      const float2 gm = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(ln + n)[0]);
      const float2 be = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(ln + C + n)[0]);
      reinterpret_cast<__nv_bfloat162*>(a.xn + (size_t)r * C + n)[0] = __floats2bfloat162_rn(
          d0 * rstd * gm.x + be.x, d1 * rstd * gm.y + be.y);
    }
  }
}

// --- the consumers: attention -----------------------------------------------------

// Eight values of qkv row b at columns t * 64 + 8 sub.. of layer l: the qkv
// product's pieces summed in order, then its epilogue.
template <typename WT>
__device__ __forceinline__ void qkv_values(const StepArgs& a, const Product& d, int t, int b,
                                           int sub, float (&out)[8]) {
  const int S = d.K / kBK, U = d.N / kTM * S;
  const Pieces p = pieces(t, S, U);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int qc = 0; qc < p.count; qc += 4) {  // four pieces' loads in flight together
    float4 x[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4* src = reinterpret_cast<const float4*>(
          a.part + piece_offset(a, p, min(qc + i, p.count - 1)) + (size_t)b * kTM +
          sub * 8);
      x[i][0] = qc + i < p.count ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[i][1] = qc + i < p.count ? __ldcg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (qc + i < p.count) {
        acc[0] += x[i][0].x, acc[1] += x[i][0].y, acc[2] += x[i][0].z, acc[3] += x[i][0].w;
        acc[4] += x[i][1].x, acc[5] += x[i][1].y, acc[6] += x[i][1].z, acc[7] += x[i][1].w;
      }
  }
  const int n = t * kTM + sub * 8;
  if (sizeof(WT) == 1) {
    const float* bias = reinterpret_cast<const float*>(d.bias) + n;
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = dense_out<true>(acc[e], bias[e], d.qscale[n + e]);
  } else {
    float bias[8];
    unpack8(*reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(d.bias) + n), bias);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = dense_out<false>(acc[e], bias[e], 0.f);
  }
}

// Each warp takes one item of a group: its stages' slots lie m apart (the
// group's items), and only that warp reads them. Lanes 8 g.. of the warp take
// the stage's rows g, g + 4, ...; a lane holds 8 of the head's 64 dims of q
// and of the item's sums.
template <typename WT, typename CT>
__device__ void attention(const StepArgs& a, int l, Ring& ring) {
  constexpr bool kQuant = sizeof(CT) == 1;
  constexpr int kSR = stage_rows<CT>();
  constexpr int kRowBytes = kHeadDim * (int)sizeof(CT);
  constexpr int kRowsPerLane = kSR / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 3, sub = lane & 7;
  const int C = a.C, H = C / kHeadDim, I = a.B * H * a.splits;
  const Product dq = product<WT>(a, l, kQkv);
  const int hi = share_lo(blockIdx.x + 1, gridDim.x, I);
  for (int i0 = share_lo(blockIdx.x, gridDim.x, I); i0 < hi; i0 += kWarps) {
    const int m = min(kWarps, hi - i0);
    int stages = 0;
    for (int k = 0; k < m; ++k) stages = max(stages, item_stages<CT>(item(a, i0 + k)));
    const int base = ring.f;
    ring.advance(stages * m);  // every warp's place after the group
    if (warp >= m) continue;
    const Item it = item(a, i0 + warp);
    // q, k and v of the current row: lanes 0-7 sum q's pieces, 8-15 k's,
    // 16-23 v's; every lane then takes its 8 dims of each
    float val[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (grp < 3) qkv_values<WT>(a, dq, grp * H + it.h, it.b, sub, val);
    float qv[8], kc[8], vc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qv[e] = __shfl_sync(0xffffffffu, val[e], sub);
      kc[e] = __shfl_sync(0xffffffffu, val[e], 8 + sub);
      vc[e] = __shfl_sync(0xffffffffu, val[e], 16 + sub);
    }
    if (it.split == 0 && (grp == 1 || grp == 2)) {  // the new k and v rows
      const size_t o = ((size_t)l * a.Bt + it.b) * C + it.h * kHeadDim + sub * 8;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) packed[e] = pack_bf16(val[2 * e], val[2 * e + 1]);
      *reinterpret_cast<uint4*>((grp == 1 ? a.k_rows : a.v_rows) + o) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    float cur = 0.f;  // the current row's logit
#pragma unroll
    for (int e = 0; e < 8; ++e) cur = fmaf(qv[e], kc[e], cur);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) cur += __shfl_xor_sync(0xffffffffu, cur, o);
    cur *= kLogitScale;

    float m_run = -INFINITY, lsum = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < stages; ++c) {
      const int f = base + c * m + warp;
      const unsigned char* kt = ring.wait(f, f % ring.slots, (unsigned)(f / ring.slots) & 1u);
      const unsigned char* vt = kt + 4096;
      const float* ks_s = reinterpret_cast<const float*>(kt + 8192);  // int8 cache only
      const float* vs_s = ks_s + 64;
      const int n = min(kSR, it.rows - c * kSR);  // <= 0: an empty slot
      // the logits of the lane's rows grp, grp + 4, ... (-inf past n)
      float lg[kRowsPerLane], smax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int r = grp + 4 * j;
        float dsum = 0.f, sc = 1.f;
        if (r < n) {
          float k8[8];
          if (kQuant) {
            sc = ks_s[r];
            unpack8_i8(*reinterpret_cast<const uint2*>(kt + r * kRowBytes + sub * 8), k8);
          } else {
            unpack8(*reinterpret_cast<const uint4*>(kt + r * kRowBytes + sub * 16), k8);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) dsum = fmaf(qv[e], k8[e], dsum);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
        lg[j] = r < n ? dsum * kLogitScale * sc : -INFINITY;
        smax = fmaxf(smax, lg[j]);
      }
      smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 8));
      smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 16));
      if (n > 0) {
        const float m_new = fmaxf(m_run, smax);
        const float alpha = expf(m_run - m_new);  // 0 at the first stage
        lsum *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] *= alpha;
        m_run = m_new;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int r = grp + 4 * j;
          if (r < n) {
            const float p = expf(lg[j] - m_new);
            lsum += p;
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
      ring.release(f % ring.slots, kWarps);
    }
    // the four lane groups' sums (m_run is the warp's)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 8);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 16);
    bf16* out = a.attn + (size_t)it.b * C + it.h * kHeadDim + sub * 8;
    const auto store = [&](const float* o, float denom) {
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) packed[e] = pack_bf16(o[2 * e] / denom, o[2 * e + 1] / denom);
      *reinterpret_cast<uint4*>(out) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    };
    if (a.splits == 1) {
      if (grp == 0) {
        const float mx = fmaxf(cur, m_run), f = expf(m_run - mx), p_cur = expf(cur - mx);
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = acc[e] * f + p_cur * vc[e];
        store(o, lsum * f + p_cur);
      }
      continue;
    }
    // the split's (acc, m, l) to the workspace; the last split of (b, h) to
    // arrive merges them in split order with the current row
    float* part = a.attn_part + (size_t)it.bh * a.splits * kSplitStride;
    if (grp == 0) {
      float4* dst = reinterpret_cast<float4*>(part + it.split * kSplitStride + sub * 8);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (sub == 0) {
        part[it.split * kSplitStride + kHeadDim] = m_run;
        part[it.split * kSplitStride + kHeadDim + 1] = lsum;
      }
    }
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) {
      unsigned* cnt = a.sync + kSyncHeader + 4 * C / kTM + it.bh;
      last = atom_add_release(cnt, 1u) == (unsigned)a.splits - 1;
      if (last) {
        __threadfence();
        atomicExch(cnt, 0u);  // for the next layer
      }
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    if (!last) continue;
    // the warp's max over the splits' m (lane s reads split s); lane group
    // g sums its 8 dims over splits g, g + 4, ... and the four groups add
    // in lane order
    float mx = cur;
    for (int s0 = 0; s0 < a.splits; s0 += 32) {
      const int sp = s0 + lane;
      const float ms = sp < a.splits ? __ldcg(part + sp * kSplitStride + kHeadDim) : -INFINITY;
      mx = fmaxf(mx, warp_max(ms));
    }
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, den = 0.f;
#pragma unroll 2
    for (int sp = grp; sp < a.splits; sp += 4) {
      const float* ps = part + sp * kSplitStride;
      const float4* src = reinterpret_cast<const float4*>(ps + sub * 8);
      const float4 o0 = __ldcg(src), o1 = __ldcg(src + 1);
      const float f = expf(__ldcg(ps + kHeadDim) - mx);
      o[0] += o0.x * f, o[1] += o0.y * f, o[2] += o0.z * f, o[3] += o0.w * f;
      o[4] += o1.x * f, o[5] += o1.y * f, o[6] += o1.z * f, o[7] += o1.w * f;
      den += __ldcg(ps + kHeadDim + 1) * f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] += __shfl_xor_sync(0xffffffffu, o[e], 8);
      o[e] += __shfl_xor_sync(0xffffffffu, o[e], 16);
    }
    den += __shfl_xor_sync(0xffffffffu, den, 8);
    den += __shfl_xor_sync(0xffffffffu, den, 16);
    if (grp == 0) {
      const float p_cur = expf(cur - mx);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += p_cur * vc[e];
      store(o, den + p_cur);
    }
  }
}

// The step's phases: the first LN, then per layer qkv's pieces, the
// attention (which sums them), proj's pieces, the row pass (x += proj, LN2),
// fc (pieces, then its tiles), fc2's pieces, the row pass (x += fc2, the next
// layer's LN1); a grid barrier after each.
template <typename WT, typename CT>
__device__ void consume(const StepArgs& a, unsigned char* smem, Ring& ring) {
  const int tid = threadIdx.x;
  unsigned barriers = 0;
  int ph = 0, xloads = 0, xparity = 0;
  // the phase's own work is done: stamp, wait at the barrier, stamp
  const auto done = [&](bool barrier) {
    unsigned long long* t = a.trace ? a.trace + ((size_t)ph * gridDim.x + blockIdx.x) * 4 : nullptr;
    if (t && tid == 0) t[1] = now_ns();
    if (barrier) grid_sync(a.sync, barriers);
    if (t && tid == 0) t[2] = now_ns();
    ++ph;
  };
  // one call site a phase kind, so that the step's code stays small
  for (; ph <= 7 * a.L; ) {
    const int l = ph == 0 ? 0 : (ph - 1) / 7, k = ph == 0 ? 6 : (ph - 1) % 7;
    if (k == 0 || k == 2 || k == 4 || k == 5)
      product_pieces<WT>(a, l, k == 0 ? kQkv : k == 2 ? kProj : k == 4 ? kFc : kFc2, smem, ring,
                         xloads, xparity);
    if (k == 4) fc_finish<WT>(a, l, smem);
    if (k == 1) attention<WT, CT>(a, l, ring);
    if (k == 3 || k == 6) {
      // after proj: LN2 of layer l; after fc2: LN1 of layer l + 1 (none
      // after the last); at the step's start: LN1 of layer 0
      const int kind = ph == 0 ? -1 : k == 3 ? kProj : kFc2;
      const bf16* ln = k == 3 ? a.ln2 + (size_t)l * 2 * a.C
                       : ph == 0 ? a.ln1
                       : l + 1 < a.L ? a.ln1 + (size_t)(l + 1) * 2 * a.C
                                     : nullptr;
      row_pass<WT>(a, l, kind, ln, smem);
    }
    done(ph < 7 * a.L);
  }
  // the last block to finish zeroes the counters for the next call
  consumer_sync();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.sync + 1, 1u) == gridDim.x - 1) {
      for (int i = 0; i < 4 * a.C / kTM; ++i) atomicExch(a.sync + kSyncHeader + i, 0u);
      atomicExch(a.sync, 0u);
      atomicExch(a.sync + 1, 0u);
      __threadfence();
    }
  }
}

// One block an SM for the whole step: warps 0-15 consume, warp 16 produces.
template <typename WT, typename CT>
__global__ void __launch_bounds__(kBlockThreads, 1)
    tc_gemm_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kMaxSlots;
  volatile int* issued = reinterpret_cast<volatile int*>(smem + kScratchOff + 128);
  const Layout y = layout(a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < y.slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    for (int s = 0; s < kXBars; ++s) mbar_init(&full[2 * kMaxSlots + s], 1);
    *issued = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{smem + y.ring_off, full, empty, issued, y.slots, 0, 0, 0u};
  if (threadIdx.x >= kThreads)
    produce<WT, CT>(a, ring);
  else
    consume<WT, CT>(a, smem, ring);
}

template <typename WT, typename CT>
cudaError_t launch_step(const StepArgs& a, int blocks, cudaStream_t s) {
  // the ring takes more than the default 48 KB: allowed once a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc_gemm_kernel<WT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;  // every block resident, or no launch
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tc_gemm_kernel<WT, CT>, a);
}

template <typename WT, typename CT>
cudaError_t blocks_per_sm(int* n) {
  cudaError_t e = cudaFuncSetAttribute(tc_gemm_kernel<WT, CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, tc_gemm_kernel<WT, CT>, kBlockThreads,
                                                      kSmemBytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up once through the runtime's entry-point query.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D tensor map: `outer` rows of `inner` elements (1 or 2 bytes) at
// `base`, row stride `inner` elements; a box of box_inner x box_outer. Rows
// past the tensor read as zeros.
bool map_2d(CUtensorMap* map, const void* base, bool bytes1, size_t inner, size_t outer,
            int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * (bytes1 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, bytes1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace tt

// The grid of a step on the current device: its SMs times the blocks of the
// kernel that fit an SM (the least over the four variants). `stream` is
// unused (the wrappers' calling convention). Returns a CUDA error, 0 on
// success.
extern "C" int tt_decode_step_blocks(int* blocks, void* stream) {
  using namespace tt;
  (void)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = blocks_per_sm<bf16, bf16>(&per_sm[0]);
  if (e == cudaSuccess) e = blocks_per_sm<bf16, int8_t>(&per_sm[1]);
  if (e == cudaSuccess) e = blocks_per_sm<int8_t, bf16>(&per_sm[2]);
  if (e == cudaSuccess) e = blocks_per_sm<int8_t, int8_t>(&per_sm[3]);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * *std::min_element(per_sm, per_sm + 4);
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// One launch: rows [row0, row0 + B) of the step's Bt. x: (Bt, C) bf16, the
// residual stream: holds the input embedding on entry and the pre-ln_f
// hidden state on return. xn (Bt, C), attn (Bt, C), ffn (Bt, 4C) are
// scratch. Stacked weights: ln (L, 2, C) bf16, wqkv (L, 3C, C), bqkv (L, 3C),
// wproj (L, C, C), bproj (L, C), wfc (L, 4C, C), bfc (L, 4C), wfc2 (L, C, 4C),
// bfc2 (L, C): bf16 weights and biases, or int8 weights with f32 biases and
// f32 qscales sqkv (L, 3C), sproj (L, C), sfc (L, 4C), sfc2 (L, C) (null for
// bf16 weights). cache_k/cache_v: (L, Bt, T, C), bf16, or int8 with f32
// k_scale/v_scale (L, Bt, H, T) (null for the bf16 cache); read-only.
// k_rows/v_rows: (L, Bt, C) bf16 outputs. Workspace: part (blocks,
// max_pieces, B, 64) f32, max_pieces the most tiles any block's share of a
// product touches; attn_part (B, H, splits, 68) f32 where splits > 1; sync:
// 64 + 4 C/64 + B H unsigned words, zero between calls (the kernel leaves
// them so); trace: null, or (1 + 7 L, blocks, 4) u64 stamps. The plan
// (ops/decode_step.py plan_step): attn_rows the prefix rows of an attention
// split, splits their count; blocks from tt_decode_step_blocks. Returns the
// first CUDA error, 0 on success.
extern "C" int tt_decode_step(void* x, void* xn, void* attn, void* ffn, const void* ln1,
                              const void* wqkv, const void* bqkv, const void* wproj,
                              const void* bproj, const void* ln2, const void* wfc,
                              const void* bfc, const void* wfc2, const void* bfc2,
                              const void* sqkv, const void* sproj, const void* sfc,
                              const void* sfc2, const void* cache_k, const void* cache_v,
                              const void* k_scale, const void* v_scale, void* k_rows,
                              void* v_rows, void* part, void* attn_part, void* sync, void* trace,
                              int L, int Bt, int row0, int B, int T, int C, int pos,
                              int attn_rows, int splits, int max_pieces, int blocks,
                              void* stream) {
  using namespace tt;
  const bool quant_w = sqkv != nullptr;
  const bool quant_c = k_scale != nullptr;
  if (C % kHeadDim != 0 || C / kTM > kWarps || B < 1 || B > kMaxRows ||
      row0 < 0 || row0 + B > Bt || L < 1 || pos < 0 || pos >= T || blocks < 1 ||
      max_pieces < 1 || splits < 1 || !part || !sync ||
      (pos > 0 && (attn_rows < 1 || (splits - 1) * attn_rows >= pos || splits * attn_rows < pos)) ||
      (splits > 1 && !attn_part))
    return (int)cudaErrorInvalidValue;
  if (quant_w && (!sproj || !sfc || !sfc2)) return (int)cudaErrorInvalidValue;
  if (quant_c && !v_scale) return (int)cudaErrorInvalidValue;
  const size_t c = (size_t)C, H = c / kHeadDim;
  StepArgs a;
  // the cache's slot boxes; the weights' tiles, swizzled as the products
  // read them (128-byte rows of bf16, 64-byte rows of int8); the inputs'
  // K steps of every row
  const int slot_rows = quant_c ? stage_rows<int8_t>() : stage_rows<bf16>();
  const int x_rows = (B + 15) & ~15;
  const CUtensorMapSwizzle wsw = quant_w ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const size_t nk[4][2] = {{3 * c, c}, {c, c}, {4 * c, c}, {c, 4 * c}};
  const void* w[4] = {wqkv, wproj, wfc, wfc2};
  bool ok = map_2d(&a.kmap, cache_k, quant_c, c, L * Bt * T, kHeadDim, slot_rows,
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
            map_2d(&a.vmap, cache_v, quant_c, c, L * Bt * T, kHeadDim, slot_rows,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  for (int p = 0; p < 4 && ok; ++p)
    ok = map_2d(&a.wmap[p], w[p], quant_w, nk[p][1], L * nk[p][0], kBK, kTM, wsw);
  ok = ok &&
       map_2d(&a.xmap[0], static_cast<bf16*>(xn) + row0 * c, false, c, B, kBK, x_rows,
              CU_TENSOR_MAP_SWIZZLE_128B) &&
       map_2d(&a.xmap[1], static_cast<bf16*>(attn) + row0 * c, false, c, B, kBK, x_rows,
              CU_TENSOR_MAP_SWIZZLE_128B) &&
       map_2d(&a.xmap[2], static_cast<bf16*>(ffn) + row0 * 4 * c, false, 4 * c, B, kBK, x_rows,
              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.x = static_cast<bf16*>(x) + row0 * c;
  a.xn = static_cast<bf16*>(xn) + row0 * c;
  a.attn = static_cast<bf16*>(attn) + row0 * c;
  a.ffn = static_cast<bf16*>(ffn) + row0 * 4 * c;
  a.ln1 = static_cast<const bf16*>(ln1);
  a.ln2 = static_cast<const bf16*>(ln2);
  a.bqkv = bqkv;
  a.bproj = bproj;
  a.bfc = bfc;
  a.bfc2 = bfc2;
  a.sqkv = static_cast<const float*>(sqkv);
  a.sproj = static_cast<const float*>(sproj);
  a.sfc = static_cast<const float*>(sfc);
  a.sfc2 = static_cast<const float*>(sfc2);
  a.k_scale = quant_c ? static_cast<const float*>(k_scale) + row0 * H * T : nullptr;
  a.v_scale = quant_c ? static_cast<const float*>(v_scale) + row0 * H * T : nullptr;
  a.k_rows = static_cast<bf16*>(k_rows) + row0 * c;
  a.v_rows = static_cast<bf16*>(v_rows) + row0 * c;
  a.part = static_cast<float*>(part);
  a.attn_part = static_cast<float*>(attn_part);
  a.sync = static_cast<unsigned*>(sync);
  a.trace = static_cast<unsigned long long*>(trace);
  a.L = L;
  a.B = B;
  a.Bt = Bt;
  a.row0 = row0;
  a.T = T;
  a.C = C;
  a.pos = pos;
  a.attn_rows = pos > 0 ? attn_rows : 1;
  a.splits = splits;
  a.max_pieces = max_pieces;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (quant_w)
    e = quant_c ? launch_step<int8_t, int8_t>(a, blocks, s) : launch_step<int8_t, bf16>(a, blocks, s);
  else
    e = quant_c ? launch_step<bf16, int8_t>(a, blocks, s) : launch_step<bf16, bf16>(a, blocks, s);
  return (int)e;
}
