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
// Design: one template, chain_kernel<In, C>, In = __nv_bfloat16 (P1) or int8_t (P2). The
// two share the tile, the halo, the operand staging and the product loop; only the bytes
// of an operand element and the mma instruction differ, so that their time ratio
// measures the number format and not two designs. A block of 8 warps per (time tile,
// batch row) holds a window of W = TT + 2H rows (H = 3P, the chain's receptive halo) in
// two time-major buffers [row = time step][C] of In, ping-ponged between convs. A row is
// RB = C sizeof(In) bytes, its 16-byte chunks XOR-swizzled with the 128-byte line index
// (K3's scheme, csrc/resblock.cu), so 8 consecutive rows fall in distinct banks and a
// fragment of 16 rows x 32 bytes is one ldmatrix.x4 whatever the element type: the byte
// layout of an m16n8k16 bf16 fragment and of an m16n8k32 s8 fragment is the same. A tap
// is a whole-row offset. Conv p computes the rows still valid after it, [3(p+1), W -
// 3(p+1)), as 7 accumulating products out[t][co] += in[t + j - 3][ci] W_j[co][ci] with M =
// time (a warp owns at most 3 m-tiles of 16 rows, so W <= 384), N = all C output
// channels, K = 32 bytes of input channels an instruction: mma.sync m16n8k16 bf16 with f32
// sums (P1) or m16n8k32 s8 with s32 sums (P2), so P2 issues half P1's mma and ldmatrix
// instructions for the same work. The wrapper packs each tap as one pre-swizzled
// [C_out][C_in] tile; one thread streams the chain's 7P tiles, in order, into a 4-stage
// ring with one bulk copy (cp.async.bulk) each and full/empty mbarriers, two taps ahead,
// so the next conv's first taps land while this conv's last products run. The epilogue
// writes the next conv's input into the other window: P1 bf16(lrelu(acc + b)), P2 that
// value quantized with the next conv's scale. The last conv writes bf16 to device memory
// from its accumulators. P2's activation scales stay in device memory and are read by the
// kernel: nothing goes back to the host.
//
// wgmma is left out: K3 measured it 16% slower at N = C <= 64 (PERF.md, PR 4).
//
// Built with -DCHAIN_PROFILE, two blocks of each launch print the clock64 counts of
// their phases (profile_port.py --chain-clocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#ifdef CHAIN_PROFILE
#include <stdio.h>
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KSIZE = 7, HALF = 3;  // taps of a conv, and its halo a side
constexpr int MAX_CONVS = 8;
constexpr int MT_MAX = 3;           // m-tiles of 16 rows a warp owns at most
constexpr int MAX_ROWS = 16 * MT_MAX * WARPS;
constexpr int PAD_ROWS = 16;        // rows past the window that a ragged m-tile reads
constexpr int STAGES = 4;           // ring stages, one tap tile each
constexpr int AHEAD = 2;            // taps in flight ahead of the one being multiplied
// the thread that streams the taps: the first lane of the last warp, which never has
// more rows than another warp
constexpr int PRODUCER = THREADS - 32;
constexpr float SLOPE = 0.1f;
constexpr int MAX_SMEM = 227 * 1024;
static_assert(AHEAD <= STAGES - 1, "a stage is refilled only after its last tap was released");

template <typename In, int C>
struct Geo {
  static constexpr bool I8 = std::is_same<In, int8_t>::value;
  static constexpr int RB = C * (int)sizeof(In);  // bytes of a row: one time step, or one C_out of a tap
  static constexpr int KT = RB / 32;              // k-tiles of 32 bytes (16 bf16 or 32 int8 channels)
  static constexpr int NT = C / 8;                // n-tiles of 8 output channels
  static constexpr int MASK = RB / 16 - 1;        // swizzle: chunk index ^= 128-byte line index & MASK
  static constexpr int TILE = C * RB;             // bytes of one tap tile [C_out][C_in]
  using Acc = typename std::conditional<I8, int, float>::type;
  static_assert(KT >= 1 && NT % 2 == 0, "C: 32 or 64");
};

// bytes of one window buffer and of a block's dynamic shared memory: 1024 bytes of
// alignment slack, the ring, two windows of W + PAD_ROWS rows, the mbarriers
__host__ __device__ inline int window_bytes(int W, int RB) { return ((W + PAD_ROWS) * RB + 1023) / 1024 * 1024; }
__host__ __device__ inline int smem_bytes(int W, int RB, int C) {
  return 1024 + STAGES * C * RB + 2 * window_bytes(W, RB) + 16 * STAGES;
}

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

// clip(rint(v / s), -127, 127): IEEE division, rounding half to even. (A multiply by
// 1 / s with this division only where the product lies within 2^-14 of a half-integer
// gives the same bits, and measured slower: PERF.md, PR 13.)
__device__ __forceinline__ int quant(float v, float s) {
  return min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
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

// The stream of tap tiles: tap t of the chain (conv t / 7, tap t % 7) goes to stage
// t % STAGES. Addresses are shared-memory addresses.
struct Pipe {
  uint32_t ring, full, empty;  // [STAGES] tiles, "tile landed", "tile consumed by all warps"
  const unsigned char* w;      // packed tap tiles in global memory
  int total;                   // taps of the chain
  int tap;                     // the next tap this thread multiplies
#ifdef CHAIN_PROFILE
  long long wait_clk, tap_clk, epi_clk;
#endif
};

// One bulk copy of tap t into its stage, once every warp has released the tap that
// was there before.
template <int TILE>
__device__ __forceinline__ void produce(const Pipe& p, int t) {
  if (t >= p.total) return;
  const int st = t % STAGES;
  if (t >= STAGES) wait_phase(p.empty + 8 * st, (t / STAGES - 1) & 1);
  const uint32_t full = p.full + 8 * st;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full), "r"((uint32_t)TILE)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          p.ring + st * TILE),
      "l"(p.w + (size_t)t * TILE), "r"((uint32_t)TILE), "r"(full)
      : "memory");
}

template <int TILE>
__device__ __forceinline__ Pipe start_pipe(unsigned char* ring, uint64_t* bars, const void* w, int total) {
  Pipe p;
  p.ring = smem_addr(ring);
  p.full = smem_addr(bars);
  p.empty = p.full + 8 * STAGES;
  p.w = static_cast<const unsigned char*>(w);
  p.total = total;
  p.tap = 0;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(p.full + 8 * st) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(p.empty + 8 * st), "r"(WARPS) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == PRODUCER)
    for (int t = 0; t < AHEAD; ++t) produce<TILE>(p, t);
  return p;
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// P1's product: 16 rows x 16 bf16 channels by 16 x 8, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// P2's product: 16 rows x 32 int8 channels by 32 x 8, s32 sums (at most 7 * 64 * 127^2
// in magnitude: no overflow)
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv of the chain as its epilogue sees it.
struct Conv {
  uint32_t in;          // shared address of the input window
  unsigned char* out;   // the next conv's input window; null for the last conv
  __nv_bfloat16* y;     // the last conv's output row block y + b C T
  const float* bias;    // [C] of this conv
  const float* ws;      // P2: [C] weight scales of this conv
  float s_in, s_next;   // P2: this conv's activation scale and the next conv's
  int olo, ohi;         // output rows [olo, ohi) of the window
  int t0, T;            // row r is global position t0 + r; outputs outside [0, T) are 0
};

// The m-tiles of the rows [olo, ohi) are split evenly over the 8 warps, at most MT
// each: the first nmt % 8 warps take one more. Sets this warp's count and first row.
__device__ __forceinline__ void split_rows(int olo, int ohi, int& cnt, int& row0) {
  const int warp = threadIdx.x >> 5;
  const int nmt = (ohi - olo + 15) >> 4, per = nmt / WARPS, rem = nmt % WARPS;
  cnt = per + (warp < rem);
  row0 = olo + (warp * per + min(warp, rem)) * 16;
}

// This lane's row of each B ldmatrix of a tap tile: output channel np 16 + 8 (lane / 16)
// + lane % 8, 16-byte chunk 2 kt + (lane / 8) % 2.
template <int C, int RB, int MASK>
__device__ __forceinline__ void b_rows(uint32_t (&brow)[C / 16], uint32_t (&bxor)[C / 16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < C / 16; ++np) {
    const uint32_t rb = (np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * RB;
    brow[np] = rb;
    bxor[np] = ((rb >> 7) & MASK) ^ ((lane >> 3) & 1);
  }
}

// One tap on the tensor cores: acc[i] += in[arow0 + 16 i + ..][ci] W[co][ci] for the tap
// tile of pipe.tap, then the tap is released. A fragments (16 rows x 32 bytes of the
// window) and B fragments (16 output channels x 32 bytes of the tile) are one ldmatrix.x4
// each. Every warp walks every tap, with or without rows of its own.
template <typename In, int C, int MT>
__device__ __forceinline__ void tap_mma(Pipe& pipe, uint32_t in, int arow0, int cnt, const uint32_t (&brow)[C / 16],
                                        const uint32_t (&bxor)[C / 16],
                                        typename Geo<In, C>::Acc (&acc)[MT][C / 8][4]) {
  using G = Geo<In, C>;
  constexpr int RB = G::RB, KT = G::KT, NT = G::NT, MASK = G::MASK;
  const int lane = threadIdx.x & 31;
  const int t = pipe.tap;
  if (threadIdx.x == PRODUCER) produce<G::TILE>(pipe, t + AHEAD);
  // the A fragments first: they depend on the window alone, so they are in flight
  // while the tap's weights are waited for. This lane's row of each A ldmatrix: window
  // row + lane % 16, chunk 2 kt + lane / 16
  uint32_t af[MT][KT][4];
  if (cnt > 0) {
    const uint32_t arow = (uint32_t)(arow0 + (lane & 15)) * RB;
    const uint32_t axor = ((arow >> 7) & MASK) ^ (lane >> 4);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < cnt) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) ldsm4(af[i][kt], in + arow + i * 16 * RB + (((2 * kt) ^ axor) << 4));
      }
    }
  }
#ifdef CHAIN_PROFILE
  const long long q0 = clock64();
#endif
  wait_phase(pipe.full + 8 * (t % STAGES), (t / STAGES) & 1);
#ifdef CHAIN_PROFILE
  pipe.wait_clk += clock64() - q0;
#endif
  if (cnt > 0) {
    const uint32_t wt = pipe.ring + (t % STAGES) * G::TILE;
    uint32_t b[2][NT / 2][4];  // the next k-tile's B fragments load during this one's products
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) ldsm4(b[0][np], wt + brow[np] + (bxor[np] << 4));
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldsm4(b[(kt + 1) & 1][np], wt + brow[np] + (((2 * kt + 2) ^ bxor[np]) << 4));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < cnt) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma(acc[i][n], af[i][kt], b[kt & 1][n >> 1][(n & 1) * 2], b[kt & 1][n >> 1][(n & 1) * 2 + 1]);
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) arrive(pipe.empty + 8 * (t % STAGES));  // this warp is done with the stage
  pipe.tap = t + 1;
}

// The epilogue of a conv for the rows a thread holds: rows gid, gid + 8 of each of its
// m-tiles, channels 8 n + 2 tig (+1).
template <typename In, int C, int MT>
__device__ __forceinline__ void epilogue(const typename Geo<In, C>::Acc (&acc)[MT][C / 8][4], const Conv& a,
                                         int cnt, int row0) {
  using G = Geo<In, C>;
  constexpr int RB = G::RB, NT = G::NT, MASK = G::MASK;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float2 bv[NT], sc[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    bv[n] = __ldg(reinterpret_cast<const float2*>(a.bias + 8 * n + 2 * tig));
    if constexpr (G::I8) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(a.ws + 8 * n + 2 * tig));
      sc[n] = make_float2(__fmul_rn(a.s_in, w.x), __fmul_rn(a.s_in, w.y));
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= cnt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * i + gid + 8 * h;
      if (row >= a.ohi) continue;
      const int gt = a.t0 + row;
      const bool inside = gt >= 0 && gt < a.T;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float y0, y1;
        if constexpr (G::I8) {
          y0 = __fadd_rn(__fmul_rn((float)acc[i][n][2 * h], sc[n].x), bv[n].x);
          y1 = __fadd_rn(__fmul_rn((float)acc[i][n][2 * h + 1], sc[n].y), bv[n].y);
        } else {
          y0 = __fadd_rn(acc[i][n][2 * h], bv[n].x);
          y1 = __fadd_rn(acc[i][n][2 * h + 1], bv[n].y);
        }
        __nv_bfloat162 v = __floats2bfloat162_rn(lrelu(y0), lrelu(y1));
        if (!inside) v = __floats2bfloat162_rn(0.f, 0.f);
        const int c = 8 * n + 2 * tig;
        if (a.out == nullptr) {
          if (inside) {
            a.y[(size_t)c * a.T + gt] = v.x;
            a.y[(size_t)(c + 1) * a.T + gt] = v.y;
          }
        } else if constexpr (G::I8) {
          const float2 f = __bfloat1622float2(v);
          char2 q;
          q.x = (signed char)quant(f.x, a.s_next);
          q.y = (signed char)quant(f.y, a.s_next);
          *reinterpret_cast<char2*>(a.out + swz((uint32_t)row * RB + c, MASK)) = q;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.out + swz((uint32_t)row * RB + 2 * c, MASK)) = v;
        }
      }
    }
  }
}

template <typename In, int C, int MT>
__device__ __forceinline__ void conv_tc(Pipe& pipe, const Conv& a) {
  using G = Geo<In, C>;
  int cnt, row0;
  split_rows(a.olo, a.ohi, cnt, row0);
  uint32_t brow[C / 16], bxor[C / 16];
  b_rows<C, G::RB, G::MASK>(brow, bxor);
  typename G::Acc acc[MT][C / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0;
#ifdef CHAIN_PROFILE
  const long long c0 = clock64();
#endif
  for (int j = 0; j < KSIZE; ++j) tap_mma<In, C, MT>(pipe, a.in, row0 + j - HALF, cnt, brow, bxor, acc);
#ifdef CHAIN_PROFILE
  const long long c1 = clock64();
  pipe.tap_clk += c1 - c0;
#endif
  if (cnt > 0) epilogue<In, C, MT>(acc, a, cnt, row0);
#ifdef CHAIN_PROFILE
  pipe.epi_clk += clock64() - c1;
#endif
}

// MT = the fewest m-tiles a warp so that 8 warps cover the conv's rows (at most 3: the
// wrapper keeps windows at 384 rows or fewer).
template <typename In, int C>
__device__ __forceinline__ void conv_rows(Pipe& pipe, const Conv& a) {
  const int mt = (a.ohi - a.olo + 16 * WARPS - 1) / (16 * WARPS);
  if (mt <= 1)
    conv_tc<In, C, 1>(pipe, a);
  else if (mt == 2)
    conv_tc<In, C, 2>(pipe, a);
  else if (mt == 3)
    conv_tc<In, C, 3>(pipe, a);
  else
    __trap();
}

// Two channels of one row into a window: bf16 as they are (P1), or quantized with the
// first conv's scale s (P2).
template <typename In>
__device__ __forceinline__ void put_pair(unsigned char* win, uint32_t off, __nv_bfloat162 v, float s) {
  if constexpr (std::is_same<In, int8_t>::value) {
    const float2 f = __bfloat1622float2(v);
    char2 q;
    q.x = (signed char)quant(f.x, s);
    q.y = (signed char)quant(f.y, s);
    *reinterpret_cast<char2*>(win + off) = q;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(win + off) = v;
  }
}

// The window's rows [0, W) from x [C, T] at global positions t0 .. t0 + W (0 outside
// [0, T)). With T a multiple of 8, a thread takes one channel pair and 16 time steps
// aligned in global time: four 16-byte loads, then 16 stores of a pair into a row (up to
// 15 rows past W are written too, inside the padded buffer). Otherwise lanes run along
// time with 2-byte loads.
template <typename In, int C>
__device__ void load_window(const __nv_bfloat16* __restrict__ x, unsigned char* win, int W, int t0, int T, float s) {
  using G = Geo<In, C>;
  constexpr int RB = G::RB, MASK = G::MASK, NP = C / 2, EB = (int)sizeof(In);
  if ((T & 7) == 0 && aligned16(x)) {
    const int g0 = t0 & ~15, ng = (t0 + W - g0 + 15) >> 4;
    for (int i = threadIdx.x; i < NP * ng; i += THREADS) {
      const int grp = i / NP, cp = i - grp * NP, gs = g0 + 16 * grp;
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
        const int row = gs - t0 + e;
        if (row < 0) continue;
        __nv_bfloat162 p;
        p.x = v[0][e];
        p.y = v[1][e];
        put_pair<In>(win, swz((uint32_t)row * RB + 2 * cp * EB, MASK), p, s);
      }
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < NP * W; i += THREADS) {
    const int cp = i / W, row = i - cp * W, gt = t0 + row;
    __nv_bfloat162 v;
    v.x = v.y = zero;
    if (gt >= 0 && gt < T) {
      v.x = x[(size_t)(2 * cp) * T + gt];
      v.y = x[(size_t)(2 * cp + 1) * T + gt];
    }
    put_pair<In>(win, swz((uint32_t)row * RB + 2 * cp * EB, MASK), v, s);
  }
}

// P1 (In = bf16) and P2 (In = int8). x, y: [B, C, T] bf16; w: the 7 P tap tiles, conv
// after conv, each pre-swizzled [C_out][C_in] of In; bias, ws: [P, C] f32; s_act: [P]
// f32 (P2). Grid (ceil(T / TT), B); TT + 6 P <= 384.
template <typename In, int C>
__global__ void __launch_bounds__(THREADS, C == 64 ? 1 : 2)
chain_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w, const float* __restrict__ bias,
             const float* __restrict__ ws, const float* __restrict__ s_act, __nv_bfloat16* __restrict__ y, int P,
             int T, int TT) {
  using G = Geo<In, C>;
  extern __shared__ unsigned char smem_raw[];
  const int H = HALF * P, W = TT + 2 * H, buf = window_bytes(W, G::RB);
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* win0 = ring + STAGES * G::TILE;
  unsigned char* win1 = win0 + buf;
  uint64_t* bars = reinterpret_cast<uint64_t*>(win1 + buf);
  Pipe pipe = start_pipe<G::TILE>(ring, bars, w, KSIZE * P);
  const int b = blockIdx.y, t0 = blockIdx.x * TT - H;
#ifdef CHAIN_PROFILE
  pipe.wait_clk = pipe.tap_clk = pipe.epi_clk = 0;
  const long long k0 = clock64();
#endif
  load_window<In, C>(x + (size_t)b * C * T, win0, W, t0, T, G::I8 ? __ldg(s_act) : 1.f);
#ifdef CHAIN_PROFILE
  const long long load_clk = clock64() - k0;
#endif
  __syncthreads();
  Conv a;
  a.y = y + (size_t)b * C * T;
  a.ws = nullptr;
  a.s_in = a.s_next = 1.f;
  a.t0 = t0;
  a.T = T;
  a.olo = 0;
  a.ohi = W;
  for (int p = 0; p < P; ++p) {
    a.olo += HALF;
    a.ohi -= HALF;
    a.in = smem_addr(p & 1 ? win1 : win0);
    a.out = p + 1 == P ? nullptr : p & 1 ? win0 : win1;
    a.bias = bias + p * C;
    if constexpr (G::I8) {
      a.ws = ws + p * C;
      a.s_in = __ldg(s_act + p);
      a.s_next = p + 1 < P ? __ldg(s_act + p + 1) : 1.f;
    }
    conv_rows<In, C>(pipe, a);
    __syncthreads();  // the next conv reads what this one wrote, and writes what it read
  }
#ifdef CHAIN_PROFILE
  if ((threadIdx.x == 0 || threadIdx.x == 224) && blockIdx.y == 0 && (blockIdx.x == 3 || blockIdx.x == 200))
    printf("CHAIN %s C%d tile %d thr %d: load %lld taps %lld (full-wait %lld) epilogue %lld total %lld\n",
           G::I8 ? "int8" : "bf16", C, blockIdx.x, threadIdx.x, load_clk, pipe.tap_clk, pipe.wait_clk,
           pipe.epi_clk, clock64() - k0);
#endif
}

template <typename In, int C>
int launch_chain(const void* x, const void* w, const float* bias, const float* ws, const float* s_act, void* y,
                 int B, int T, int P, int TT, cudaStream_t stream) {
  const int smem = smem_bytes(TT + 2 * HALF * P, Geo<In, C>::RB, C);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<In, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<In, C><<<dim3((T + TT - 1) / TT, B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, bias, ws, s_act, static_cast<__nv_bfloat16*>(y), P, T, TT);
  return (int)cudaGetLastError();
}

template <typename In>
int run_chain(const void* x, const void* w, const float* bias, const float* ws, const float* s_act, void* y,
              int B, int C, int T, int P, int TT, void* stream) {
  if (B < 1 || T < 1 || B > 65535 || P < 1 || P > MAX_CONVS || TT < 1 || TT + 2 * HALF * P > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64) return launch_chain<In, 64>(x, w, bias, ws, s_act, y, B, T, P, TT, s);
  if (C == 32) return launch_chain<In, 32>(x, w, bias, ws, s_act, y, B, T, P, TT, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// P1: x, y [B, C, T] bf16; w: 7 P bf16 tap tiles; bias [P, C] f32; C 32 or 64
extern "C" int acad_conv_chain_bf16(const void* x, const void* w, const float* bias, void* y, int B, int C, int T,
                                    int P, int TT, void* stream) {
  return run_chain<__nv_bfloat16>(x, w, bias, nullptr, nullptr, y, B, C, T, P, TT, stream);
}

// P2: x, y [B, C, T] bf16; wq: 7 P int8 tap tiles; ws, bias [P, C] f32; s_act [P] f32 on the device
extern "C" int acad_conv_chain_i8(const void* x, const void* wq, const float* ws, const float* bias,
                                  const float* s_act, void* y, int B, int C, int T, int P, int TT, void* stream) {
  return run_chain<int8_t>(x, wq, bias, ws, s_act, y, B, C, T, P, TT, stream);
}
