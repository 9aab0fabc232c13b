// The two conv chains of the int8 decision probe for Hopper (sm_90a): P1 and P2.
//
// P1 replaces benchmarks/pallas_int8_probe.py:_chain_kernel_bf16 (pallas_call :110), P2
// replaces _chain_kernel_i8 (pallas_call :116). Both run a chain of P convs (the probe's
// 6), each of k 7, dilation 1 and zero "same" padding, C -> C channels, over x [B, C, T]
// bf16, every row its own sequence. Conv p's weights W[p] [C, 7C] are tap-major (column
// j C + ci is tap j of input channel ci, at offset j - 3). Per conv, in f32:
//   P1: y = sum of bf16 x bf16 products + b[p]; cur = bf16(lrelu(y))
//   P2: xi = clip(rint(cur / s[p]), -127, 127) int8; yi = sum of int8 x int8 in int32;
//       y = float(yi) * (s[p] * ws[p][co]) + b[p], without FMA contraction;
//       cur = bf16(lrelu(y))
// with lrelu(v) = v >= 0 ? v : 0.1 v. P2 quantizes the bf16-rounded output of the previous
// conv, with IEEE division and rounding half to even. Every conv reads zeros outside
// [0, T): a conv output at a position outside [0, T) is 0, not lrelu(bias), and 0 in
// int8 too.
//
// Bound on the H100: at K3's stage shapes, s2 [8, 64, 120000] and s3 [8, 32, 240000],
// the 6 convs are 0.330 and 0.165 TFLOP: 0.334 / 0.167 ms at the bf16 tensor-core peak
// and half that at the int8 peak, against 0.25 GB of bf16 input and output (0.073 ms at
// 3.35 TB/s). Both are bound by operations, P2 at s3 only just.
//
// Design: one template, chain_kernel<In, C, NW>, In = __nv_bfloat16 (P1) or int8_t (P2).
// The two share the tile, the halo, the staging and the product loop; only the bytes of
// an operand element and the wgmma instruction differ, so that their time ratio measures
// the number format and not two designs.
//
// The product is wgmma with M = output channels and N = time: wgmma is the only route to
// the card's full tensor-core rate, and int8 wgmma runs at twice the bf16 rate. (With M =
// time and N = C <= 64, K3's wgmma read 2 KB of each operand per 32 tensor clocks, the
// whole shared-memory rate, and lost to mma.sync: csrc/resblock.cu. Here a bf16
// m64n128k16 reads 2 KB of A and 4 KB of B per 64 clocks, 96 bytes a clock of the 128
// that shared memory gives.) A block per (time tile, batch row) has two consumer
// warpgroups, each computing NW = 256 columns of every conv, and one producer warpgroup whose
// first thread streams the weights (setmaxnreg moves registers to the consumers). The
// window is time-major, [row = time step][C] of In, in two buffers ping-ponged between
// convs; a row is RB = C sizeof(In) bytes and its 16-byte chunks are XOR-swizzled with
// the 128-byte line index, which is the wgmma swizzle pattern of the line width (128/64/32
// bytes: B128/B64/B32). With one output phase (PH 1, at C 64), a B column (time t) is one window
// row and the rows are the swizzle width apart, so window rows t - 3 .. t + 3 are
// contiguous bytes: column t of the conv's K = 7C im2col is one run starting at row t -
// 3, and the whole conv is one sequence of 32-byte k-steps whose B descriptor starts at
// window + (t0 - 3) RB + 32 s (a step that crosses a row is a shifted-row descriptor,
// valid with base offset 0: the swizzle acts on absolute address bits). A (the weights)
// is one [64][RB] pre-swizzled tile per tap, K-major, rows = output channels. Both
// operands are K-major, as int8 wgmma requires. At C 32 one phase would leave half of M
// empty; PH = 64 / C = 2 stacks two output phases in M instead: row (r, co) holds W_{m-r}[co] at row
// offset m = 0..7 (zeros elsewhere), and B column u, starting at window row 2u - 3 with
// a stride of two rows (2 RB = the swizzle width), gives output time 2u + r: K = 8C, 7/8
// of it useful, and a warpgroup covers 512 time steps. A is then four [64][2 RB] tiles a
// conv (two row offsets each); it ran s3 in half the time of one phase with half of M
// empty (PERF.md). A zero weight still multiplies the extra row, so the rows no
// conv writes are zeroed: a NaN there would reach a valid output.
//
// A warpgroup's conv is two halves of 128 columns (m64n128): each half's k-steps (7 C
// sizeof(In) / 32 at PH 1) issue back to back with one commit, and half 0's epilogue runs
// while half 1's products do. A short sequence, whose wide blocks would leave most SMs
// idle, takes the narrow block (NW 128, one half a warpgroup) instead: half the tile, about
// half a block's time, and twice the blocks (chain_cols in ops/cuda/chain.py picks it). The producer streams the chain's A tiles, in order, into a
// ring of 11-14 stages (one bulk copy and one full mbarrier each), so the next conv's
// first tiles land during this conv's products; a conv releases its stages once its
// products are done. The epilogue turns the [co][t] accumulators into the next conv's
// [t][co] window with stmatrix .trans (one 16-byte row of the window per lane address,
// so the swizzle is kept): P1 writes bf16(lrelu(acc + b)); P2 that value quantized with
// the next conv's scale. For P2 the wrapper permutes A's output-channel rows so that a
// thread's accumulator rows g and g + 8 are channels 2g and 2g + 1: it packs an int8
// pair into one b16 and one .trans store writes 16 channels x 8 time steps. Outputs at
// positions outside [0, T) are zeroed afterwards, only in blocks at a sequence's ends.
// The last conv writes y [C, T] from its accumulators (PH 1), or through an output tile
// in shared memory that the block copies out along time (PH 2, whose columns are every
// other time step). An interior window arrives by one bulk copy per channel into a
// staging buffer and is transposed by ldmatrix .trans + stmatrix (P2 quantizes between
// the two); windows at a sequence's ends are loaded by the threads. (Two warpgroups on
// separate tiles taking turns on the tensor cores measured slower: a warpgroup's
// epilogue alone does not fill an SM's issue slots. PERF.md.)
//
// P2's quantizer is exact without a division: v -> clip(rint(v / s), -127, 127) is
// monotone in v, so for each scale 254 bf16 thresholds tau_q (the least bf16 v with
// quant(v) >= q) fix it. The wrapper builds them from the plain quantizer itself over all
// bf16 values, on the device. The kernel takes the candidate q0 = clip(rint(v (1/s) -
// 2^-13)): v / s and v (1/s) differ by a few ulp, so q0 is the exact value or one less,
// and one table load decides, q = q0 + (v >= tau[q0 + 1]), tau_128 = NaN. (Two loads
// around an unbiased candidate, and loading only where v (1/s) lies within 2^-14 of a
// half-integer, which branches, each cost more.) P2's activation scales and tables stay
// in device memory.
//
// Built with -DCHAIN_PROFILE, two consumer threads of two blocks of each launch print the
// clock64 counts of their phases (profile_port.py --chain-clocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#ifdef CHAIN_PROFILE
#include <stdio.h>
#endif

namespace {

constexpr int KSIZE = 7, HALF = 3;   // taps of a conv, and its halo a side
constexpr int MAX_CONVS = 8;
constexpr int NH = 128;              // N of a wgmma: the B columns of one half
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int PRODUCER = 128 * CONSUMERS;       // the thread that streams the weights
constexpr int R0 = 4;                // a conv's first row: even, so global positions of pairs are even
constexpr int QTAB = 256;            // a P2 threshold table: q = -127 .. 128
constexpr float QBIAS = 0x1p-13f;    // P2's candidate is taken this far below v / s
constexpr float SLOPE = 0.1f;
constexpr int MAX_SMEM = 227 * 1024;

// NW: B columns a consumer warpgroup computes a conv, two halves (256) or one (128, the
// narrow block of short sequences)
template <typename In, int C, int NW>
struct Geo {
  static constexpr bool I8 = std::is_same<In, int8_t>::value;
  static constexpr int PH = 64 / C;               // output phases stacked in M
  static constexpr int HALVES = NW / NH;
  static constexpr int RB = C * (int)sizeof(In);  // bytes of a window row (one time step)
  static constexpr int LINE = PH * RB;            // bytes between two B columns: the swizzle width
  static constexpr int MODE = LINE == 128 ? 1 : LINE == 64 ? 2 : 3;  // descriptor: B128, B64, B32
  static constexpr int MASK = LINE / 16 - 1;      // swizzle: chunk ^= 128-byte line index & MASK
  static constexpr int OFFS = PH == 1 ? KSIZE : 8;  // window rows in a column's K
  static constexpr int NB = OFFS * RB / LINE;     // A tiles a conv: 7 (one a tap) or 4
  static constexpr int KPB = LINE / 32;           // k-steps of 32 bytes a tile
  static constexpr int TILE = 64 * LINE;          // bytes of an A tile [64][LINE]
  static constexpr int SPAN = PH * NW;            // rows a consumer warpgroup computes a conv
  static constexpr int ROWS = R0 + CONSUMERS * SPAN + HALF;  // rows of a window
  // x's rows as they arrive, [C][SCOLS] bf16 from a time step that is a multiple of 8: in
  // the second window for P1, in a buffer of their own for P2
  static constexpr int SCOLS = (ROWS + 14) / 8 * 8, SPITCH = 2 * SCOLS, STAGE = C * SPITCH;
  static constexpr int XSTAGE = I8 ? STAGE : 0;
  static constexpr int WIN = ((I8 || ROWS * RB > STAGE ? ROWS * RB : STAGE) + 1023) / 1024 * 1024;
  static constexpr int STAGES = TILE >= 8192 ? 11 : 14;
  static constexpr int TABS = I8 ? MAX_CONVS * QTAB * 4 : 0;  // P2's thresholds
  static constexpr int SMEM = 1024 + STAGES * TILE + 2 * WIN + TABS + XSTAGE + 16 * (STAGES + 1);
  using Acc = typename std::conditional<I8, int, float>::type;
  static_assert((C == 32 || C == 64) && (NW == NH || NW == 2 * NH), "C 32 or 64, one or two halves");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

// the first output row of a tile: the last conv is valid on [H + 1, ROWS - H) (the first
// conv reads rows 1 .. ROWS - 1), and an even start keeps output pairs aligned
__host__ __device__ inline int out0(int P) { return (HALF * P + 2) & ~1; }

// byte offset of a row-major [rows][RB] element after the XOR swizzle
__device__ __forceinline__ uint32_t swz(uint32_t byte, uint32_t mask) {
  return byte ^ (((byte >> 7) & mask) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// max(v, 0.1 v): the same value as v >= 0 ? v : 0.1 v for every finite v
__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, SLOPE * v); }

// clip(rint(v / s), -127, 127) for a bf16 v, exact: v (1 / s) - 2^-13 lies below v / s and
// less than 2^-12 below it (for |v / s| < 128 the two differ by under 2.3e-5), so its
// rounding q is the exact one or one less, and one threshold decides: q + (v >=
// tau_q+1), tau_q the least bf16 with quant >= q (tau_128 = NaN). tab points at q = 0.
__device__ __forceinline__ int quant(float v, float inv, const float* tab) {
  const int q = min(max(__float2int_rn(__fmaf_rn(v, inv, -QBIAS)), -127), 127);
  return q + (v >= tab[q + 1]);
}

// Wait for the phase of the given parity to complete. A wait of more than 2^28 polls
// traps, so that a fault turns into a launch error, not a hang.
__device__ __forceinline__ void wait_phase(uint32_t mbar, unsigned parity) {
  unsigned done = 0, polls = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (++polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void arrive(uint32_t mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar) : "memory");
}

// One bulk copy of an A tile into its ring stage, counted on the stage's full barrier.
__device__ __forceinline__ void copy_tile(uint32_t dst, const unsigned char* src, uint32_t bytes, uint32_t full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(full)
      : "memory");
}

// A shared-memory matrix descriptor: K-major, swizzled (mode 1/2/3 = 128/64/32 bytes),
// 8-row groups sbo bytes apart, base offset 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)mode << 62);
}

#define D64                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define OP8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define OP64(c) OP8(c, 0), OP8(c, 8), OP8(c, 16), OP8(c, 24), OP8(c, 32), OP8(c, 40), OP8(c, 48), OP8(c, 56)
#define F_(x) "+f"(x)
#define R_(x) "+r"(x)

// P1's k-step on one half: d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, bf16, f32 sums
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : OP64(F_)
      : "l"(a), "l"(b), "r"(acc));
}

// P2's k-step on one half: d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T, int8, s32 sums (at
// most 7 * 64 * 127^2 in magnitude: exact, and exact in f32)
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D64 ", %64, %65, p;\n}\n"
      : OP64(R_)
      : "l"(a), "l"(b), "r"(acc));
}

// Keeps the compiler from moving accumulator accesses across a wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, transposed: matrix i's fragment row g / column c (register i of
// lane 4g + c/2) goes to column g of the 16-byte row given by lane 8i + c.
__device__ __forceinline__ void stsm4t(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// the generic-proxy stores of a window, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// named barriers: 1 the two consumer warpgroups, 2 + wg one of them
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// One conv as its epilogue sees it.
struct Conv {
  unsigned char* out;   // the next conv's input window; null for the last conv
  __nv_bfloat16* y;     // the last conv's output row block y + b C T (one phase)
  unsigned char* yst;   // the last conv's output tile [C][TT] bf16 in shared memory (two)
  const float* bias;    // [C] of this conv
  const float* ws;      // P2: [C] weight scales of this conv
  const float* tab;     // P2: the next conv's thresholds, at q = 0
  float s_in, inv_next;  // P2: this conv's activation scale, the next conv's reciprocal
  int g0, T, TT, o0;    // row r is global position g0 + r; the last conv keeps rows
                        // [o0, o0 + TT)
};

// The products of conv p for this consumer warpgroup (wg), in halves of 128 columns: each
// of the conv's NB tiles waited for on its stage, half 0's k-steps back to back and one
// commit, then (NW 256) half 1's and one commit. (The caller waits.)
template <typename In, int C, int NW>
__device__ __forceinline__ void products(typename Geo<In, C, NW>::Acc (&d0)[64],
                                         typename Geo<In, C, NW>::Acc (&d1)[64], uint32_t ring, uint32_t full,
                                         uint32_t win, int wg, int p, long long& wait_clk) {
  using G = Geo<In, C, NW>;
  const uint32_t b0 = win + (uint32_t)(R0 - HALF + wg * G::SPAN) * G::RB, b1 = b0 + NH * G::LINE;
  fence_acc(d0);
  fence_acc(d1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < G::NB; ++i) {
    const int t = p * G::NB + i, st = t % G::STAGES;
#ifdef CHAIN_PROFILE
    const long long q0 = clock64();
#endif
    wait_phase(full + 8 * st, (t / G::STAGES) & 1);
    __syncwarp();
#ifdef CHAIN_PROFILE
    wait_clk += clock64() - q0;
#endif
    const uint32_t a0 = ring + st * G::TILE;
#pragma unroll
    for (int k = 0; k < G::KPB; ++k)
      wgmma(d0, desc(a0 + 32 * k, 8 * G::LINE, G::MODE), desc(b0 + 32 * (i * G::KPB + k), 8 * G::LINE, G::MODE),
            i | k);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  if constexpr (G::HALVES == 1) return;
#pragma unroll
  for (int i = 0; i < G::NB; ++i) {
    const uint32_t a0 = ring + ((p * G::NB + i) % G::STAGES) * G::TILE;
#pragma unroll
    for (int k = 0; k < G::KPB; ++k)
      wgmma(d1, desc(a0 + 32 * k, 8 * G::LINE, G::MODE), desc(b1 + 32 * (i * G::KPB + k), 8 * G::LINE, G::MODE),
            i | k);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The epilogue of half H of a conv for this thread's accumulators d: rows 16w + g and 16w
// + g + 8 of M (w the warp in the warpgroup, g = lane / 4), columns 8j + 2 (lane % 4) + e,
// j in [16H, 16H + 16). A warp's 16 rows are phase r = 16w / C, channels c0 = 16w % C on:
// P1 c0 + g, c0 + g + 8; P2 (rows permuted by the wrapper) c0 + 2g, c0 + 2g + 1. Column n
// is window row base + PH n. Outputs at positions outside [0, T) are left to zero_outside.
template <typename In, int C, int NW, int H>
__device__ __forceinline__ void epilogue(const typename Geo<In, C, NW>::Acc (&d)[64], const Conv& a, int wg) {
  using G = Geo<In, C, NW>;
  constexpr int RB = G::RB, MASK = G::MASK, PH = G::PH, J0 = H * NH / 8;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  if (16 * w >= PH * C) return;  // rows of M that hold no channel
  const int c0 = 16 * w % C, base = R0 + wg * G::SPAN + 16 * w / C;
  const int ch0 = G::I8 ? c0 + 2 * g : c0 + g, ch1 = G::I8 ? ch0 + 1 : ch0 + 8;
  const float bias0 = __ldg(a.bias + ch0), bias1 = __ldg(a.bias + ch1);
  float sc0 = 1.f, sc1 = 1.f;
  if constexpr (G::I8) {
    sc0 = __fmul_rn(a.s_in, __ldg(a.ws + ch0));
    sc1 = __fmul_rn(a.s_in, __ldg(a.ws + ch1));
  }
  const int q = lane >> 3, i = lane & 7;  // this lane's row address: matrix q, its row i
  // columns 8j + 2 tig and + 1 of this thread's two channels, as bf16 pairs
  auto pairs = [&](int j, __nv_bfloat162& p0, __nv_bfloat162& p1) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (G::I8)
        v[k] = __fadd_rn(__fmul_rn((float)d[4 * (j - J0) + k], k < 2 ? sc0 : sc1), k < 2 ? bias0 : bias1);
      else
        v[k] = __fadd_rn(d[4 * (j - J0) + k], k < 2 ? bias0 : bias1);
    }
    p0 = __floats2bfloat162_rn(lrelu(v[0]), lrelu(v[1]));
    p1 = __floats2bfloat162_rn(lrelu(v[2]), lrelu(v[3]));
  };
  if (a.out == nullptr) {
    // the last conv, rows [o0, o0 + TT). One phase: straight to y [C, T] inside [0, T), a
    // column pair one aligned 4-byte store where T is even (g0, base and o0 are). Two
    // phases: a thread's columns are every other time step, so they go to the output tile
    // in shared memory, channel-major, which the block then copies out along time.
#pragma unroll
    for (int j = J0; j < J0 + NH / 8; ++j) {
      __nv_bfloat162 p0, p1;
      pairs(j, p0, p1);
      const int row = base + PH * (8 * j + 2 * tig);
      if constexpr (PH == 1) {
        const int gt = a.g0 + row;
        if ((a.T & 1) == 0) {
          if (row >= a.o0 && row < a.o0 + a.TT && gt < a.T) {
            *reinterpret_cast<__nv_bfloat162*>(a.y + (size_t)ch0 * a.T + gt) = p0;
            *reinterpret_cast<__nv_bfloat162*>(a.y + (size_t)ch1 * a.T + gt) = p1;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (row + e >= a.o0 && row + e < a.o0 + a.TT && gt + e < a.T) {
              a.y[(size_t)ch0 * a.T + gt + e] = e ? p0.y : p0.x;
              a.y[(size_t)ch1 * a.T + gt + e] = e ? p1.y : p1.x;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = row + PH * e - a.o0;
          if (col >= 0 && col < a.TT) {
            *reinterpret_cast<__nv_bfloat16*>(a.yst + (ch0 * a.TT + col) * 2) = e ? p0.y : p0.x;
            *reinterpret_cast<__nv_bfloat16*>(a.yst + (ch1 * a.TT + col) * 2) = e ? p1.y : p1.x;
          }
        }
      }
    }
    return;
  }
  const uint32_t out = smem_addr(a.out);
  if constexpr (G::I8) {
    // one b16 = the channel pair of one column; matrices j .. j + 3; a row is 16 channels
#pragma unroll
    for (int j = J0; j < J0 + NH / 8; j += 4) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        __nv_bfloat162 p0, p1;
        pairs(j + m, p0, p1);
        const float2 f0 = __bfloat1622float2(p0), f1 = __bfloat1622float2(p1);
        const uint32_t e0 = __byte_perm(quant(f0.x, a.inv_next, a.tab), quant(f1.x, a.inv_next, a.tab), 0x0040);
        const uint32_t e1 = __byte_perm(quant(f0.y, a.inv_next, a.tab), quant(f1.y, a.inv_next, a.tab), 0x0040);
        r[m] = __byte_perm(e0, e1, 0x5410);
      }
      const uint32_t row = base + PH * (8 * (j + q) + i);
      stsm4t(out + swz(row * RB + c0, MASK), r[0], r[1], r[2], r[3]);
    }
  } else {
    // one b16 = one channel; matrices (j, rows g), (j, rows g + 8), (j + 1, ..); a row is
    // 8 channels
#pragma unroll
    for (int j = J0; j < J0 + NH / 8; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        __nv_bfloat162 p0, p1;
        pairs(j + m, p0, p1);
        r[2 * m] = *reinterpret_cast<uint32_t*>(&p0);
        r[2 * m + 1] = *reinterpret_cast<uint32_t*>(&p1);
      }
      const uint32_t row = base + PH * (8 * (j + (q >> 1)) + i);
      stsm4t(out + swz(row * RB + 2 * (c0 + 8 * (q & 1)), MASK), r[0], r[1], r[2], r[3]);
    }
  }
}

// A conv's outputs at positions outside [0, T) are 0, in both chains: where this block's
// window reaches past either end, the warpgroup zeroes those of its rows, after its
// epilogue's stores. (Chunks of 16 bytes, swizzled: at C 32 with two phases a row is half
// a swizzle line.)
template <typename In, int C, int NW>
__device__ __forceinline__ void zero_outside(unsigned char* out, int g0, int T, int wg) {
  using G = Geo<In, C, NW>;
  constexpr int CHUNKS = G::RB / 16;
  const int lo = R0 + wg * G::SPAN, head = max(0, min(-g0 - lo, G::SPAN)),
            tail = max(0, min(lo + G::SPAN - (T - g0), G::SPAN));
  warpgroup_sync(wg);
  for (int i = threadIdx.x & 127; i < (head + tail) * CHUNKS; i += 128) {
    const int k = i / CHUNKS, row = k < head ? lo + k : lo + G::SPAN - tail + (k - head);
    *reinterpret_cast<uint4*>(out + swz(row * G::RB + 16 * (i % CHUNKS), G::MASK)) = make_uint4(0, 0, 0, 0);
  }
}

// The rows of the second window that no conv writes ([0, R0) and past the computed
// rows), zeroed once: a two-phase column reads one row past each phase's taps with a
// zero weight, and 0 x NaN is NaN.
template <typename In, int C, int NW>
__device__ __forceinline__ void zero_edges(unsigned char* win) {
  using G = Geo<In, C, NW>;
  constexpr int CHUNKS = G::RB / 16, COMPUTED = CONSUMERS * G::SPAN;
  for (int i = threadIdx.x; i < (G::ROWS - COMPUTED) * CHUNKS; i += THREADS) {
    const int k = i / CHUNKS, row = k < R0 ? k : k + COMPUTED;
    *reinterpret_cast<uint4*>(win + swz(row * G::RB + 16 * (i % CHUNKS), G::MASK)) = make_uint4(0, 0, 0, 0);
  }
}

// An interior window (g0 >= 0, g0 + ROWS <= T, T a multiple of 8, x 16-byte aligned)
// arrives by bulk copies, one per channel, of time steps s0 = g0 & ~7 on into the staging
// buffer [C][SCOLS], counted on mbarrier bar. (One thread.)
template <typename In, int C, int NW>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* x, uint32_t stage, int g0, int T, uint32_t bar) {
  using G = Geo<In, C, NW>;
  const int s0 = g0 & ~7;
  const uint32_t bytes = 2 * min(G::SCOLS, T - s0);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(C * bytes) : "memory");
  for (int c = 0; c < C; ++c)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            stage + c * G::SPITCH),
        "l"(x + (size_t)c * T + s0), "r"(bytes), "r"(bar)
        : "memory");
}

// The staged rows into the window, transposed by the tensor cores' load path: an
// ldmatrix .trans of 8 channels x 8 time steps gives each lane a channel pair of one time
// step, which stmatrix writes as is (P1) or quantized with the first conv's scale (P2).
// A task is 32 channels x 8 time steps; staging column k is window row k - (g0 - s0).
template <typename In, int C, int NW>
__device__ __forceinline__ void unstage_rows(const unsigned char* stage, unsigned char* win, int g0, float inv,
                                             const float* tab) {
  using G = Geo<In, C, NW>;
  constexpr int TASKS = (G::SCOLS / 8) * (C / 32);
  const int lane = threadIdx.x & 31, off = g0 & 7;
  const uint32_t dummy = smem_addr(win) + G::ROWS * G::RB;  // a slot in the window's slack
  for (int task = threadIdx.x >> 5; task < TASKS; task += THREADS / 32) {
    const int tb = task / (C / 32), cq = task % (C / 32);
    uint32_t r[4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(stage + (32 * cq + lane) * G::SPITCH + 16 * tb))
                 : "memory");
    if constexpr (G::I8) {
      // lane: time step 8 tb + lane / 4, channels 32 cq + 8m + 2 (lane % 4) + {0, 1}
      const int row = 8 * tb + (lane >> 2) - off;
      if (row >= 0 && row < G::ROWS) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[m]));
          const uint32_t pr = __byte_perm(quant(f.x, inv, tab), quant(f.y, inv, tab), 0x0040);
          *reinterpret_cast<uint16_t*>(win + swz(row * G::RB + 32 * cq + 8 * m + 2 * (lane & 3), G::MASK)) =
              (uint16_t)pr;
        }
      }
    } else {
      const int row = 8 * tb + (lane & 7) - off;
      const uint32_t addr = row >= 0 && row < G::ROWS
                                ? smem_addr(win) + swz(row * G::RB + 2 * (32 * cq + 8 * (lane >> 3)), G::MASK)
                                : dummy;
      asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
                   "r"(r[1]), "r"(r[2]), "r"(r[3])
                   : "memory");
    }
  }
}

// Two channels of one row into a window: bf16 as they are (P1), or quantized with the
// first conv's scale (P2).
template <typename In>
__device__ __forceinline__ void put_pair(unsigned char* win, uint32_t off, __nv_bfloat162 v, float inv,
                                         const float* tab) {
  if constexpr (std::is_same<In, int8_t>::value) {
    char2 q;
    q.x = (signed char)quant(__bfloat162float(v.x), inv, tab);
    q.y = (signed char)quant(__bfloat162float(v.y), inv, tab);
    *reinterpret_cast<char2*>(win + off) = q;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(win + off) = v;
  }
}

// The window's rows [0, ROWS) from x [C, T] at global positions g0 .. g0 + ROWS (0 outside
// [0, T)), by every thread of the block: the path of windows at a sequence's ends (the
// others are staged). With T a multiple of 8, a thread takes one channel pair and 16 time
// steps aligned in global time: four 16-byte loads, then 16 stores of a pair into a row
// (rows past ROWS land in the buffer's slack or are skipped). Otherwise lanes run along
// time with 2-byte loads.
template <typename In, int C, int NW>
__device__ void load_window(const __nv_bfloat16* __restrict__ x, unsigned char* win, int g0, int T, float inv,
                            const float* tab) {
  using G = Geo<In, C, NW>;
  constexpr int RB = G::RB, MASK = G::MASK, NP = C / 2, EB = (int)sizeof(In), W = G::ROWS;
  if ((T & 7) == 0 && aligned16(x)) {
    const int s0 = g0 & ~15, ng = (g0 + W - s0 + 15) >> 4;
    for (int i = threadIdx.x; i < NP * ng; i += THREADS) {
      const int grp = i / NP, cp = i - grp * NP, gs = s0 + 16 * grp;
      alignas(16) __nv_bfloat16 v[2][16];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gt = gs + 8 * hh;
        uint4 u0 = make_uint4(0, 0, 0, 0), u1 = u0;
        if (gt >= 0 && gt < T) {
          u0 = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(2 * cp) * T + gt));
          u1 = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(2 * cp + 1) * T + gt));
        }
        *reinterpret_cast<uint4*>(&v[0][8 * hh]) = u0;
        *reinterpret_cast<uint4*>(&v[1][8 * hh]) = u1;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int row = gs - g0 + e;
        if (row < 0 || row * RB >= G::WIN) continue;
        __nv_bfloat162 p;
        p.x = v[0][e];
        p.y = v[1][e];
        put_pair<In>(win, swz((uint32_t)row * RB + 2 * cp * EB, MASK), p, inv, tab);
      }
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < NP * W; i += THREADS) {
    const int cp = i / W, row = i - cp * W, gt = g0 + row;
    __nv_bfloat162 v;
    v.x = v.y = zero;
    if (gt >= 0 && gt < T) {
      v.x = x[(size_t)(2 * cp) * T + gt];
      v.y = x[(size_t)(2 * cp + 1) * T + gt];
    }
    put_pair<In>(win, swz((uint32_t)row * RB + 2 * cp * EB, MASK), v, inv, tab);
  }
}

// P1 (In = bf16) and P2 (In = int8). x, y: [B, C, T] bf16; w: the chain's NB P A tiles,
// conv after conv, each pre-swizzled [64][LINE] of In; bias, ws: [P, C] f32; s_act: [P]
// f32 and tau: [P, 256] f32 thresholds tau_q at q + 127 (P2). Grid (ceil(T / TT), B); TT
// a multiple of 8, at most ROWS - 3P - out0(P).
template <typename In, int C, int NW>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w, const float* __restrict__ bias,
             const float* __restrict__ ws, const float* __restrict__ s_act, const float* __restrict__ tau,
             __nv_bfloat16* __restrict__ y, int P, int T, int TT) {
  using G = Geo<In, C, NW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* win0 = ring + G::STAGES * G::TILE;
  unsigned char* win1 = win0 + G::WIN;
  float* tabs = reinterpret_cast<float*>(win1 + G::WIN);
  unsigned char* stage = G::I8 ? win1 + G::WIN + G::TABS : win1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(win1 + G::WIN + G::TABS + G::XSTAGE);
  const uint32_t full = smem_addr(bars), empty = full + 8 * G::STAGES, xbar = empty + 8 * G::STAGES,
                 ring_a = smem_addr(ring);
  const int total = G::NB * P, b = blockIdx.y, o0 = out0(P), g0 = blockIdx.x * TT - o0;
  const __nv_bfloat16* xb = x + (size_t)b * C * T;
  const bool staged = g0 >= 0 && g0 + G::ROWS <= T && (T & 7) == 0 && aligned16(x);
  if (threadIdx.x == 0) {
    for (int st = 0; st < G::STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full + 8 * st) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(empty + 8 * st), "r"(4 * CONSUMERS) : "memory");
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(xbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == PRODUCER) {
    if (staged) stage_rows<In, C, NW>(xb, smem_addr(stage), g0, T, xbar);
    for (int t = 0; t < min(total, G::STAGES); ++t)
      copy_tile(ring_a + t * G::TILE, w + (size_t)t * G::TILE, G::TILE, full + 8 * t);
  }
#ifdef CHAIN_PROFILE
  const long long k0 = clock64();
#endif
  float inv0 = 1.f;
  if constexpr (G::I8) {
    for (int i = threadIdx.x; i < P * QTAB; i += THREADS) tabs[i] = __ldg(tau + i);
    inv0 = __frcp_rn(__ldg(s_act));
    __syncthreads();
  }
  if (staged) {
    wait_phase(xbar, 0);
    unstage_rows<In, C, NW>(stage, win0, g0, inv0, tabs + 127);
    __syncthreads();  // P1 staged in the second window
  } else {
    load_window<In, C, NW>(xb, win0, g0, T, inv0, tabs + 127);
  }
  zero_edges<In, C, NW>(win1);
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x >= PRODUCER) {
    // the producer warpgroup: its first thread streams the remaining tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == PRODUCER) {
      for (int t = G::STAGES; t < total; ++t) {
        const int st = t % G::STAGES;
        wait_phase(empty + 8 * st, (t / G::STAGES - 1) & 1);
        copy_tile(ring_a + st * G::TILE, w + (size_t)t * G::TILE, G::TILE, full + 8 * st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const bool edge = g0 < 0 || g0 + G::ROWS > T;  // the window reaches past an end of the sequence
#ifdef CHAIN_PROFILE
  const long long load_clk = clock64() - k0;
  long long wait_clk = 0, prod_clk = 0, epi0_clk = 0, wait1_clk = 0, epi1_clk = 0, sync_clk = 0;
#else
  long long wait_clk = 0;
#endif
  typename G::Acc d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0;
  Conv a;
  a.y = y + (size_t)b * C * T;
  a.yst = G::I8 ? stage : P & 1 ? win1 : win0;  // free during the last conv
  a.ws = nullptr;
  a.tab = nullptr;
  a.s_in = a.inv_next = 1.f;
  a.g0 = g0;
  a.T = T;
  a.TT = TT;
  a.o0 = o0;
  for (int p = 0; p < P; ++p) {
    const bool last = p + 1 == P;
    a.out = last ? nullptr : p & 1 ? win0 : win1;
    a.bias = bias + p * C;
    if constexpr (G::I8) {
      a.ws = ws + p * C;
      a.s_in = __ldg(s_act + p);
      if (!last) {
        a.inv_next = __frcp_rn(__ldg(s_act + p + 1));
        a.tab = tabs + (p + 1) * QTAB + 127;
      }
    }
#ifdef CHAIN_PROFILE
    const long long c0 = clock64();
#endif
    products<In, C, NW>(d0, d1, ring_a, full, smem_addr(p & 1 ? win1 : win0), wg, p, wait_clk);
    // the warp's arrival on the conv's ring stages, once its last commit group is complete
    auto release = [&] {
      __syncwarp();
      if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int i = 0; i < G::NB; ++i) arrive(empty + 8 * ((p * G::NB + i) % G::STAGES));
    };
    // with two halves, half 0's epilogue runs while half 1's products do
    if constexpr (G::HALVES == 2) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(d0);
    if constexpr (G::HALVES == 1) release();
#ifdef CHAIN_PROFILE
    const long long c1 = clock64();
    prod_clk += c1 - c0;
#endif
    epilogue<In, C, NW, 0>(d0, a, wg);
#ifdef CHAIN_PROFILE
    const long long c2 = clock64();
    epi0_clk += c2 - c1;
#endif
    if constexpr (G::HALVES == 2) {
      wgmma_wait<0>();
      fence_acc(d1);
      release();
    }
#ifdef CHAIN_PROFILE
    const long long c3 = clock64();
    wait1_clk += c3 - c2;
#endif
    if constexpr (G::HALVES == 2) epilogue<In, C, NW, 1>(d1, a, wg);
    if (!last) {
      if (edge) zero_outside<In, C, NW>(a.out, g0, T, wg);
      fence_async_smem();
    }
#ifdef CHAIN_PROFILE
    const long long c4 = clock64();
    epi1_clk += c4 - c3;
#endif
    if (!last) consumers_sync();  // the next conv reads what this one wrote, and writes what it read
#ifdef CHAIN_PROFILE
    sync_clk += clock64() - c4;
#endif
  }
#ifdef CHAIN_PROFILE
  const long long s0 = clock64();
#endif
  if constexpr (G::PH == 2) {
    // the output tile to y [C, T], 16 bytes a thread where T allows, coalesced along time
    consumers_sync();
    const int ts = blockIdx.x * TT, n = min(TT, T - ts);
    __nv_bfloat16* yb = a.y + ts;
    const __nv_bfloat16* yst = reinterpret_cast<const __nv_bfloat16*>(a.yst);
    if ((T & 7) == 0 && aligned16(y)) {
      for (int k = threadIdx.x; k < C * (n / 8); k += 128 * CONSUMERS) {
        const int ch = k / (n / 8), c8 = k - ch * (n / 8);
        *reinterpret_cast<uint4*>(yb + (size_t)ch * T + 8 * c8) =
            *reinterpret_cast<const uint4*>(yst + ch * TT + 8 * c8);
      }
    } else {
      for (int k = threadIdx.x; k < C * n; k += 128 * CONSUMERS) {
        const int ch = k / n, t = k - ch * n;
        yb[(size_t)ch * T + t] = yst[ch * TT + t];
      }
    }
  }
#ifdef CHAIN_PROFILE
  if ((threadIdx.x == 0 || threadIdx.x == 128) && blockIdx.y == 0 && (blockIdx.x == 3 || blockIdx.x == 200))
    printf("CHAIN %s C%d N%d tile %d thr %d: load %lld products %lld (ring waits %lld) epilogue0 %lld "
           "wait1 %lld epilogue1 %lld sync %lld store %lld total %lld\n",
           G::I8 ? "int8" : "bf16", C, NW, blockIdx.x, threadIdx.x, load_clk, prod_clk, wait_clk, epi0_clk,
           wait1_clk, epi1_clk, sync_clk, clock64() - s0, clock64() - k0);
#else
  (void)wait_clk;
#endif
}

template <typename In, int C, int NW>
int launch_chain(const void* x, const void* w, const float* bias, const float* ws, const float* s_act,
                 const float* tau, void* y, int B, int T, int P, int TT, cudaStream_t stream) {
  using G = Geo<In, C, NW>;
  if (TT + HALF * P + out0(P) > G::ROWS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<In, C, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<In, C, NW><<<dim3((T + TT - 1) / TT, B), THREADS, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w), bias, ws, s_act, tau,
      static_cast<__nv_bfloat16*>(y), P, T, TT);
  return (int)cudaGetLastError();
}

template <typename In>
int run_chain(const void* x, const void* w, const float* bias, const float* ws, const float* s_act,
              const float* tau, void* y, int B, int C, int T, int P, int TT, int NW, void* stream) {
  if (B < 1 || T < 1 || B > 65535 || P < 1 || P > MAX_CONVS || TT < 8 || (TT & 7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64 && NW == 2 * NH) return launch_chain<In, 64, 2 * NH>(x, w, bias, ws, s_act, tau, y, B, T, P, TT, s);
  if (C == 64 && NW == NH) return launch_chain<In, 64, NH>(x, w, bias, ws, s_act, tau, y, B, T, P, TT, s);
  if (C == 32 && NW == 2 * NH) return launch_chain<In, 32, 2 * NH>(x, w, bias, ws, s_act, tau, y, B, T, P, TT, s);
  if (C == 32 && NW == NH) return launch_chain<In, 32, NH>(x, w, bias, ws, s_act, tau, y, B, T, P, TT, s);
  return (int)cudaErrorInvalidValue;
}

template <typename In, int C, int NW>
void geometry(int* out) {
  using G = Geo<In, C, NW>;
  out[0] = G::ROWS;
  out[1] = G::STAGES;
  out[2] = G::SMEM;
}

}  // namespace

// P1: x, y [B, C, T] bf16; w: the packed bf16 A tiles; bias [P, C] f32; C 64 (one output
// phase in M) or 32 (two); NW 256 or 128 B columns a consumer warpgroup
extern "C" int acad_conv_chain_bf16(const void* x, const void* w, const float* bias, void* y, int B, int C, int T,
                                    int P, int TT, int NW, void* stream) {
  return run_chain<__nv_bfloat16>(x, w, bias, nullptr, nullptr, nullptr, y, B, C, T, P, TT, NW, stream);
}

// P2: x, y [B, C, T] bf16; wq: the packed int8 A tiles (output channels permuted); ws,
// bias [P, C] f32 in channel order; s_act [P] and tau [P, 256] f32 on the device
extern "C" int acad_conv_chain_i8(const void* x, const void* wq, const float* ws, const float* bias,
                                  const float* s_act, const float* tau, void* y, int B, int C, int T, int P, int TT,
                                  int NW, void* stream) {
  return run_chain<int8_t>(x, wq, bias, ws, s_act, tau, y, B, C, T, P, TT, NW, stream);
}

// The block geometry that a launch of chain (0 P1, 1 P2) at C and NW uses: out[0] the
// window's rows, out[1] the ring's stages, out[2] the dynamic shared memory it sets.
extern "C" int acad_conv_chain_geometry(int int8, int C, int NW, int* out) {
  const int key = (int8 ? 4 : 0) + (C == 64 ? 2 : 0) + (NW == NH ? 1 : 0);
  if ((C != 32 && C != 64) || (NW != NH && NW != 2 * NH)) return (int)cudaErrorInvalidValue;
  switch (key) {
    case 0: geometry<__nv_bfloat16, 32, 2 * NH>(out); break;
    case 1: geometry<__nv_bfloat16, 32, NH>(out); break;
    case 2: geometry<__nv_bfloat16, 64, 2 * NH>(out); break;
    case 3: geometry<__nv_bfloat16, 64, NH>(out); break;
    case 4: geometry<int8_t, 32, 2 * NH>(out); break;
    case 5: geometry<int8_t, 32, NH>(out); break;
    case 6: geometry<int8_t, 64, 2 * NH>(out); break;
    default: geometry<int8_t, 64, NH>(out); break;
  }
  return 0;
}
