// HiFi-GAN resblock towers for Hopper (sm_90a): K3 and K4.
//
// K3 tower_kernel replaces academicodec_tpu/ops/pallas/resblock.py:_tower_kernel
// (resblock_tower): the mean of G residual chains over one generator stage,
// with an optional lrelu -> conv_post -> tanh epilogue. K4 gn_tower_kernel
// replaces _gn_tower_kernel (resblock_tower_gn, pass 1): every chain of an
// encoder stage from the same input, each chain's output written, plus
// per-tile partial moments sum_t r_g and sum_t r_g r_h; moments_reduce_kernel
// sums the tiles in a fixed order (no atomics, so tokens do not vary from run
// to run). Pass 2 is gn_affine_kernel (the chained GroupNorm affines A_g, K on
// [B, C] scalars) and gn_apply_kernel (out = (K + sum_g A_g r_g) / G, one pass).
//
// A ResBlock1 chain is pairs (lrelu -> dilated conv -> lrelu -> unit conv) with
// a residual add per pair; a ResBlock2 chain is lrelu -> conv + residual. Conv
// outputs at global positions outside [0, T) are exactly 0, not the bias,
// which is what zero "same" padding of the unfused convs gives.
//
// Rounding points follow the Pallas kernel: lrelu in f32 rounded to the
// storage type S; the first conv of a pair rounded to S; the residual add in
// f32 rounded to S; the chain sum and mean in f32; the post conv reads
// lrelu(mean) rounded to S. Products accumulate in f32: on the bf16 tensor
// cores for bf16 storage with C in {16, 32, 64}, in f32 FMAs otherwise (no
// TF32, so the f32 variant matches the CPU's plain version).
//
// Bound on the H100: at the flagship generator stage 2 ([8, 64, 120000], 3
// chains of 6 convs, sum of taps 126) the convs are 0.99 TFLOP, 1.0 ms at the
// bf16 tensor-core peak, against 0.25 GB moved: bound by operations. K4 at
// the encoder's stage 0 (the same shape and taps) is 0.99 TFLOP against
// 0.49 GB (its three chain outputs are written): bound by operations too.
// So the product loop must hold little but tensor-core instructions and
// the 16-byte shared loads that feed them.
//
// Design of the tensor-core path (tower_kernel, gn_tower_kernel): one block of
// 8 warps per (time tile, batch row), one resident block per SM at C 64 and two
// below, holds a window of TT + 2H time steps (H = the deepest chain's
// receptive halo, plus the post conv's) in three TIME-MAJOR buffers [row = time
// step][C] bf16: the chain's running value, its lrelu, and the first conv's
// lrelu'd output. A row is 2C bytes and its 16-byte chunks are XOR-swizzled
// with the 128-byte line index (the 128/64/32 byte swizzle patterns of wgmma
// and TMA for C 64/32/16), so 8 consecutive rows fall in distinct banks. A
// dilated tap is then a whole-row offset, always 16-byte aligned: every operand
// fragment is one ldmatrix. Each conv is k accumulating products out[t][co] +=
// in[t + shift_j][ci] W_j[co][ci] with M = time (a warp owns 16 MT consecutive
// rows, MT <= 4), N = all C output channels (mma.sync m16n8k16, f32
// accumulate), so the accumulators hold adjacent output channels and the
// epilogue writes 4-byte pairs into a row. A tap's A fragments are loaded
// before its weights are waited for, the next k-tile's B fragments during this
// one's products. The wrapper packs each tap as one contiguous, pre-swizzled
// [C_out][C_in] tile; one thread streams the taps of the whole tower, in order,
// into a 4-stage ring with one bulk copy (cp.async.bulk) per tap and full/empty
// mbarriers, two taps ahead, so the next conv's first taps land while this
// conv's last products run. The lrelu of a residual sum is written by the
// epilogue that produces the sum (no separate pass), the last conv of a chain
// adds into K3's f32 chain sum or copies into K4's per-chain centre tiles, and
// each chain starts at its own halo (a k 3 chain recomputes 12 halo rows a
// side, not 60). K4 takes its moments from the centre tiles it still holds.
//
// Why mma.sync and not wgmma: with M = time and N = C <= 64 a warpgroup
// product reads 2 KB of each operand per 32 tensor-core clocks, the whole
// shared-memory rate, and measured slower at every shape (A from registers
// and A by descriptor; a shifted-row descriptor needs base offset 0, the
// swizzle acts on absolute address bits). M = output channels with N = time
// up to 176 runs the product loop 12% faster at C 64 only, for a second code
// path with a transposing epilogue (times in PERF.md).
//
// K3's prologue (the `pre` branch of _tower_kernel, resblock.py:114-131,
// 165-187): the tower's input is x0 = convT(lrelu(x)) of the stage's input x
// [B, C_in, T_in], stride u, computed phase-major so that x0 never goes to
// device memory: x0[u q + r] = sum over phase r's taps (m, j) of z[q - m]
// K_j. TT and the halo are multiples of u, so a window starts on a phase
// boundary. Shared memory at C 64 holds no fourth window, so each chain
// recomputes x0 before its first conv: its input window [W/u + span][C_in]
// lies in the y1 buffer (free until then) as C_in / C swizzled [rows][C]
// slices, and each phase is a product with M = W/u rows, N = C and K = taps x
// C_in, its (tap, slice) [C][C] tiles streamed through the ring ahead of the
// chain's own taps by the same tap loop (tap_mma), which keeps the register
// budget of the chain convs. The FMA path computes x0 per element from x in
// device memory (pre_window).
//
// K4 with lengths [B] (the JAX package's length-masked encode, which it runs
// unfused): row b's valid limit is lengths[b] instead of T, so its frames
// past it are loaded as 0, every conv output there is 0 and the chains write
// exact zeros; the moments add those zeros in the fixed tile order, so they
// equal the moments of the row at its exact length bit for bit; the affines
// count lengths[b] frames and gn_apply writes 0 past them.
//
// Built with -DTOWER_PROFILE, two blocks of tower_kernel print the clock64
// counts of their phases (profile_port.py --tower-clocks).
//
// The FMA path (tower_fma_kernel, gn_tower_fma_kernel; f32, or channel counts
// the tensor-core path does not take) keeps a channel-major window [C][ld]
// and gives each lane 8 channels x 8 columns. It is the exactness reference
// on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#ifdef TOWER_PROFILE
#include <stdio.h>
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CO_T = 8;            // output channels per thread
constexpr int T_T = 8;             // columns per thread, 32 apart
constexpr int STRIP = 32 * T_T;    // columns per warp unit
constexpr int MAX_CHAINS = 4;
constexpr int MAX_CONVS = 8;
constexpr int MAX_U = 8;         // stride of K3's convT prologue
constexpr int MAX_PRE_TAPS = 8;  // taps of one phase of the prologue
constexpr float SLOPE = 0.1f;

struct Tower {
  int tc;        // the tensor-core path (bf16, C in {16, 32, 64}, pre-swizzled tap tiles)
  int G;         // chains
  int resblock;  // 1: pairs with a residual add per pair; 2: one conv per add
  int k[MAX_CHAINS];
  int n_convs[MAX_CHAINS];
  int dil[MAX_CHAINS][MAX_CONVS];  // per conv, in call order
  // K3's prologue x0 = convT(lrelu(x)) with stride pre_u (0: none), phase-major:
  // x0[u q + r] = sum_i z[q - pre_m[r][i]] K[pre_j[r][i]] + b over the pre_n[r]
  // taps of phase r; m_hi = max m. pre_cin input channels.
  int pre_u, pre_cin, pre_mhi, pre_span;
  int pre_n[MAX_U];
  int pre_m[MAX_U][MAX_PRE_TAPS];
  int pre_j[MAX_U][MAX_PRE_TAPS];
};

template <typename S> __device__ __forceinline__ float to_f(S v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename S> __device__ __forceinline__ float round_to(float v) {
  return to_f<S>(from_f<S>(v));
}

// max(v, 0.1 v): the same value as v >= 0 ? v : 0.1 v for every finite v
__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, SLOPE * v); }

__device__ __forceinline__ void load_w8(const float* p, float w[CO_T]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load_w8(const __nv_bfloat16* p, float w[CO_T]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

enum { OUT_LRELU = 0, OUT_RESIDUAL = 1 };

// ------------------------------------------------------------ FMA path

// Epilogue of one conv output (channel co, window column t, f32 sum acc):
// y = acc + bias, 0 where the global position t0 + t is outside [0, T).
// OUT_LRELU: out = S(lrelu(S(y))). OUT_RESIDUAL: out = S(out + y), in place.
template <typename S, int MODE>
__device__ __forceinline__ void store_out(S* out, int ld, int co, int t, float acc,
                                          const float* __restrict__ bias, int t0, int T) {
  const int gt = t0 + t;
  const float y = (gt >= 0 && gt < T) ? acc + __ldg(bias + co) : 0.f;
  S* dst = out + co * ld + t;
  if (MODE == OUT_LRELU) {
    *dst = from_f<S>(lrelu(round_to<S>(y)));
  } else {
    *dst = from_f<S>(to_f<S>(*dst) + y);
  }
}

// conv(in) at window columns [olo, ohi) with f32 FMAs; weights [C_in][k][C_out].
template <typename S, int MODE>
__device__ void conv_pass(const S* __restrict__ in, S* __restrict__ out,
                          const S* __restrict__ w, const float* __restrict__ bias,
                          int C, int ld, int k, int d, int olo, int ohi, int t0, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = C / CO_T;
  const int strips = ohi > olo ? (ohi - olo + STRIP - 1) / STRIP : 0;
  const int half = (k - 1) / 2;
  for (int u = warp; u < groups * strips; u += WARPS) {
    const int co0 = (u % groups) * CO_T;
    const int tb = olo + (u / groups) * STRIP + lane;
    const int nvalid = tb < ohi ? min(T_T, (ohi - tb + 31) / 32) : 0;
    float acc[CO_T][T_T];
#pragma unroll
    for (int o = 0; o < CO_T; ++o)
#pragma unroll
      for (int m = 0; m < T_T; ++m) acc[o][m] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const S* row = in + ci * ld;
      const S* wr = w + (size_t)ci * k * C + co0;
      for (int j = 0; j < k; ++j) {
        float wv[CO_T];
        load_w8(wr + (size_t)j * C, wv);
        const S* src = row + tb + (j - half) * d;
        float a[T_T];
#pragma unroll
        for (int m = 0; m < T_T; ++m) a[m] = m < nvalid ? to_f<S>(src[32 * m]) : 0.f;
#pragma unroll
        for (int o = 0; o < CO_T; ++o)
#pragma unroll
          for (int m = 0; m < T_T; ++m) acc[o][m] = fmaf(wv[o], a[m], acc[o][m]);
      }
    }
#pragma unroll
    for (int m = 0; m < T_T; ++m) {
      if (m >= nvalid) break;
#pragma unroll
      for (int o = 0; o < CO_T; ++o)
        store_out<S, MODE>(out, ld, co0 + o, tb + 32 * m, acc[o][m], bias, t0, T);
    }
  }
}

template <typename S>
__device__ void lrelu_pass(const S* src, S* dst, int C, int ld, int lo, int hi) {
  const int n = hi - lo;
  if (n <= 0) return;
  for (int i = threadIdx.x; i < C * n; i += THREADS) {
    const int c = i / n, t = lo + i % n;
    dst[c * ld + t] = from_f<S>(lrelu(to_f<S>(src[c * ld + t])));
  }
}

// cur = x at global columns t0 .. t0 + W (0 outside [0, Tv)), a = S(lrelu(cur));
// x rows are T long, Tv <= T of them valid
template <typename S>
__device__ void load_window(const S* __restrict__ x, S* cur, S* a, int C, int ld, int W,
                            int t0, int T, int Tv) {
  for (int i = threadIdx.x; i < C * W; i += THREADS) {
    const int c = i / W, col = i % W, gt = t0 + col;
    const S v = (gt >= 0 && gt < Tv) ? x[(size_t)c * T + gt] : from_f<S>(0.f);
    cur[c * ld + col] = v;
    a[c * ld + col] = from_f<S>(lrelu(to_f<S>(v)));
  }
}

// K3's prologue on the FMA path: cur = S(convT(S(lrelu(x))) + b) at global
// columns t0 .. t0 + W (0 outside [0, T)), a = S(lrelu(cur)). x: [C_in, T_in];
// wpre: [k][C][C_in]. t0 is a multiple of u, so column col is phase col % u.
template <typename S>
__device__ void pre_window(const S* __restrict__ x, const S* __restrict__ wpre,
                           const float* __restrict__ bpre, const Tower& tw, S* cur, S* a, int C,
                           int ld, int W, int t0, int T, int T_in) {
  const int u = tw.pre_u, cin = tw.pre_cin;
  for (int i = threadIdx.x; i < C * W; i += THREADS) {
    const int c = i / W, col = i % W, gt = t0 + col;
    float y = 0.f;
    if (gt >= 0 && gt < T) {
      const int q = gt / u, r = gt - q * u;
      float acc = 0.f;
      for (int e = 0; e < tw.pre_n[r]; ++e) {
        const int s = q - tw.pre_m[r][e];
        if (s < 0 || s >= T_in) continue;
        const S* wr = wpre + ((size_t)tw.pre_j[r][e] * C + c) * cin;
        for (int ci = 0; ci < cin; ++ci)
          acc = fmaf(to_f<S>(wr[ci]), round_to<S>(lrelu(to_f<S>(x[(size_t)ci * T_in + s]))), acc);
      }
      y = acc + __ldg(bpre + c);
    }
    const S v = from_f<S>(y);
    cur[c * ld + col] = v;
    a[c * ld + col] = from_f<S>(lrelu(to_f<S>(v)));
  }
}

// Runs chain g on a window already loaded into cur/a. w and bias point at the
// chain's first conv. Leaves the chain output in cur, valid at [lo, hi).
template <typename S>
__device__ void run_chain(const Tower& tw, int g, const S* w, const float* bias, S* cur, S* a,
                          S* y1, int C, int ld, int W, int t0, int T, int& lo, int& hi) {
  const int k = tw.k[g], half = (k - 1) / 2, n = tw.n_convs[g];
  const size_t wstride = (size_t)C * C * k;
  lo = 0;
  hi = W;
  if (tw.resblock == 1) {
    for (int p = 0; p < n; p += 2) {
      int d = tw.dil[g][p], r = half * d;
      conv_pass<S, OUT_LRELU>(a, y1, w + p * wstride, bias + p * C, C, ld, k, d, lo + r, hi - r,
                              t0, T);
      lo += r;
      hi -= r;
      __syncthreads();
      d = tw.dil[g][p + 1];
      r = half * d;
      conv_pass<S, OUT_RESIDUAL>(y1, cur, w + (p + 1) * wstride, bias + (p + 1) * C, C, ld, k, d,
                                 lo + r, hi - r, t0, T);
      lo += r;
      hi -= r;
      __syncthreads();
      if (p + 2 < n) {
        lrelu_pass(cur, a, C, ld, lo, hi);
        __syncthreads();
      }
    }
  } else {
    for (int p = 0; p < n; ++p) {
      const int d = tw.dil[g][p], r = half * d;
      conv_pass<S, OUT_RESIDUAL>(a, cur, w + p * wstride, bias + p * C, C, ld, k, d, lo + r,
                                 hi - r, t0, T);
      lo += r;
      hi -= r;
      __syncthreads();
      if (p + 1 < n) {
        lrelu_pass(cur, a, C, ld, lo, hi);
        __syncthreads();
      }
    }
  }
}

// shared row stride of the FMA path's window of W columns
__host__ __device__ __forceinline__ int row_stride(int W) { return (W + 7) / 8 * 8; }

// K3, FMA path. x, y: [B, C, T] (y: [B, C_post, T] with a post conv). H >= Hc + (kp-1)/2,
// Hc the deepest chain's halo. With the prologue x is [B, C_in, T_in], T = u T_in, and
// TT and H are multiples of u. Grid (ceil(T / TT), B).
template <typename S>
__global__ void __launch_bounds__(THREADS)
tower_fma_kernel(const S* __restrict__ x, const S* __restrict__ w, const float* __restrict__ bias,
             const S* __restrict__ wpost, const float* __restrict__ bpost,
             const S* __restrict__ wpre, const float* __restrict__ bpre, S* __restrict__ y,
             Tower tw, int C, int T, int T_in, int TT, int H, int Hc, int C_post, int kp,
             int post_tanh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = TT + 2 * H, ld = row_stride(W);
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* a = cur + C * ld;
  S* y1 = a + C * ld;
  const int P = H - Hc, aw = TT + 2 * P;  // acc covers window columns [Hc, Hc + aw)
  float* acc = reinterpret_cast<float*>(y1 + C * ld);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int t0 = tile * TT - H;
  const S* xb = x + (size_t)b * (tw.pre_u ? (size_t)tw.pre_cin * T_in : (size_t)C * T);
  const S* wg = w;
  const float* bg = bias;
  for (int g = 0; g < tw.G; ++g) {
    if (tw.pre_u)
      pre_window(xb, wpre, bpre, tw, cur, a, C, ld, W, t0, T, T_in);
    else
      load_window(xb, cur, a, C, ld, W, t0, T, T);
    __syncthreads();
    int lo, hi;
    run_chain(tw, g, wg, bg, cur, a, y1, C, ld, W, t0, T, lo, hi);
    for (int i = threadIdx.x; i < C * aw; i += THREADS) {
      const float v = to_f<S>(cur[(i / aw) * ld + Hc + i % aw]);
      acc[i] = g == 0 ? v : acc[i] + v;
    }
    __syncthreads();
    wg += (size_t)tw.n_convs[g] * C * C * tw.k[g];
    bg += tw.n_convs[g] * C;
  }
  const float n_chains = (float)tw.G;
  if (wpost == nullptr) {
    for (int i = threadIdx.x; i < C * TT; i += THREADS) {
      const int c = i / TT, j = i % TT, gt = tile * TT + j;
      if (gt < T) y[((size_t)b * C + c) * T + gt] = from_f<S>(acc[c * aw + P + j] / n_chains);
    }
    return;
  }
  for (int i = threadIdx.x; i < C * aw; i += THREADS)
    a[(i / aw) * ld + Hc + i % aw] = from_f<S>(lrelu(acc[i] / n_chains));
  __syncthreads();
  const int hp = (kp - 1) / 2;
  for (int i = threadIdx.x; i < C_post * TT; i += THREADS) {
    const int o = i / TT, j = i % TT, gt = tile * TT + j;
    if (gt >= T) continue;
    float s = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const S* row = a + ci * ld + H + j - hp;
      const S* wr = wpost + ((size_t)o * C + ci) * kp;
      for (int jj = 0; jj < kp; ++jj) s = fmaf(to_f<S>(wr[jj]), to_f<S>(row[jj]), s);
    }
    s += bpost[o];
    if (post_tanh) s = tanhf(s);
    y[((size_t)b * C_post + o) * T + gt] = from_f<S>(s);
  }
}

// The valid length of batch row b: lengths[b] clamped to [0, T], or T without lengths.
__device__ __forceinline__ int valid_length(const int* lengths, int b, int T) {
  return lengths == nullptr ? T : min(max(__ldg(lengths + b), 0), T);
}

// K4 pass 1, FMA path. outs: [G, B, C, T]; part: [B, nT, C, n_mom] with the moments of
// the stored (rounded) values in the order m_0..m_{G-1}, q_00, q_01, ..., q_11, ...
// With lengths [B], row b is computed as if it were lengths[b] long: its frames past
// that are read as 0 and written as 0, and add exact zeros to the moments.
template <typename S>
__global__ void __launch_bounds__(THREADS)
gn_tower_fma_kernel(const S* __restrict__ x, const S* __restrict__ w, const float* __restrict__ bias,
                S* outs, float* __restrict__ part, const int* __restrict__ lengths, Tower tw, int B,
                int C, int T, int TT, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = TT + 2 * H, ld = row_stride(W);
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* a = cur + C * ld;
  S* y1 = a + C * ld;
  const int b = blockIdx.y, tile = blockIdx.x, nT = gridDim.x;
  const int t0 = tile * TT - H;
  const int width = min(TT, T - tile * TT);  // centre columns inside [0, T)
  const int Tv = valid_length(lengths, b, T);
  const S* xb = x + (size_t)b * C * T;
  const S* wg = w;
  const float* bg = bias;
  for (int g = 0; g < tw.G; ++g) {
    load_window(xb, cur, a, C, ld, W, t0, T, Tv);
    __syncthreads();
    int lo, hi;
    run_chain(tw, g, wg, bg, cur, a, y1, C, ld, W, t0, Tv, lo, hi);
    S* og = outs + ((size_t)g * B + b) * C * T + (size_t)tile * TT;
    for (int i = threadIdx.x; i < C * TT; i += THREADS) {
      const int c = i / TT, j = i % TT;
      if (j < width) og[(size_t)c * T + j] = cur[c * ld + H + j];
    }
    __syncthreads();
    wg += (size_t)tw.n_convs[g] * C * C * tw.k[g];
    bg += tw.n_convs[g] * C;
  }
  // partial moments of this tile, read back from what this block wrote
  const int G = tw.G, n_mom = G + G * (G + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < C * n_mom; item += WARPS) {
    const int c = item / n_mom, m = item % n_mom;
    int g = m, h = -1;
    if (m >= G) {
      int r = m - G;
      g = 0;
      while (r >= G - g) {
        r -= G - g;
        ++g;
      }
      h = g + r;
    }
    const S* rg = outs + (((size_t)g * B + b) * C + c) * T + (size_t)tile * TT;
    const S* rh = h >= 0 ? outs + (((size_t)h * B + b) * C + c) * T + (size_t)tile * TT : rg;
    float s = 0.f;
    for (int j = lane; j < width; j += 32) {
      const float v = to_f<S>(rg[j]);
      s += h >= 0 ? v * to_f<S>(rh[j]) : v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[(((size_t)b * nT + tile) * C + c) * n_mom + m] = s;
  }
}

// ------------------------------------------------------------ tensor-core path

constexpr int STAGES = 4;     // ring stages, one tap tile each
constexpr int AHEAD = 2;      // taps in flight ahead of the one being multiplied
constexpr int MT_MAX = 4;     // 16-row m-tiles a warp owns at most (3 from C 32 up, see conv_rows)
// the thread that streams the taps: the first lane of the last warp, which
// never has more rows than another warp, so its waits for a free stage fall
// into its slack
constexpr int PRODUCER = THREADS - 32;
static_assert(AHEAD <= STAGES - 1, "a stage is refilled only after its last tap was released");

template <int C>
struct Tc {
  static constexpr int RB = 2 * C;         // bytes of one row (one time step, or one C_out of a tap)
  static constexpr int KT = C / 16;        // k-tiles (16 input channels)
  static constexpr int NT = C / 8;         // n-tiles (8 output channels) = 16-byte chunks of a row
  static constexpr int MASK = RB / 16 - 1; // swizzle: chunk index ^= 128-byte line index & MASK
  static constexpr int TILE = C * RB;      // bytes of one tap tile [C_out][C_in]
};

// byte offset of a row-major [rows][RB] element after the XOR swizzle
__device__ __forceinline__ uint32_t swz(uint32_t byte, uint32_t mask) {
  return byte ^ (((byte >> 7) & mask) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of the given parity to complete. A wait of more than
// 2^28 polls traps, so that a fault turns into a launch error, not a hang.
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

// The stream of tap tiles: tap t of the tower (chains, convs and taps in call
// order) goes to stage t % STAGES. All fields are shared-memory addresses.
struct Pipe {
  uint32_t ring, full, empty;  // [STAGES] tiles, "tile landed", "tile consumed by all warps"
  const unsigned char* w;      // packed tap tiles in global memory
  int total;                   // taps of the whole tower
  int tap;                     // the next tap this thread multiplies
#ifdef TOWER_PROFILE
  long long wait_clk, epi_clk;
#endif
};

// One bulk copy of tap t into its stage, once every warp has released the
// tap that was there before.
template <int C>
__device__ __forceinline__ void produce(const Pipe& p, int t) {
  if (t >= p.total) return;
  const int st = t % STAGES;
  if (t >= STAGES) wait_phase(p.empty + 8 * st, (t / STAGES - 1) & 1);
  const uint32_t full = p.full + 8 * st;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full),
               "r"((uint32_t)Tc<C>::TILE)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          p.ring + st * Tc<C>::TILE),
      "l"(p.w + (size_t)t * Tc<C>::TILE), "r"((uint32_t)Tc<C>::TILE), "r"(full)
      : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// what the epilogue of a conv does with y = acc + bias (0 outside [0, T))
enum {
  M_FIRST,    // out = S(lrelu(S(y)))
  M_RES,      // out = S(out + y); lr = S(lrelu(out))
  M_SUM_SET,  // v = S(out + y); sum = v        (last conv of K3's first chain)
  M_SUM_ADD,  // v = S(out + y); sum += v       (last conv of K3's other chains)
  M_KEEP,     // v = S(out + y); keep = v       (last conv of a K4 chain)
};

struct ConvArgs {
  uint32_t in;          // shared address of the input window
  unsigned char* out;   // M_FIRST: the output window; else the running value, read and written
  unsigned char* lr;    // M_RES: the window that takes lrelu of the new running value
  float* sum;           // M_SUM_*: f32 chain sum, row stride C + 1
  unsigned char* keep;  // M_KEEP: centre tiles of every chain, swizzled rows
  const float* bias;
  int mode, k, d;
  int olo, ohi;         // output rows [olo, ohi) of the window
  int row_off;          // sum row = row - row_off; keep row = row - row_off
  int t0, T;            // row r is global position t0 + r; outputs outside [0, T) are 0
};

__device__ __forceinline__ __nv_bfloat162 lrelu2(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(lrelu(f.x), lrelu(f.y));
}

// The epilogue of a conv for the rows a thread holds: rows gid, gid + 8 of
// each of its m-tiles, channels 8 n + 2 tig (+1). All reads of a row come
// before its writes, so that they are in flight together.
template <int C, int MT, int MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][C / 8][4], const ConvArgs& a, int cnt,
                                         int row0) {
  constexpr int RB = Tc<C>::RB, NT = Tc<C>::NT, MASK = Tc<C>::MASK;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float2 bv[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) bv[n] = __ldg(reinterpret_cast<const float2*>(a.bias + 8 * n + 2 * tig));
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= cnt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * i + gid + 8 * h;
      if (row >= a.ohi) continue;
      const int gt = a.t0 + row;
      const bool inside = gt >= 0 && gt < a.T;
      const uint32_t rb = (uint32_t)row * RB + tig * 4;
      const uint32_t rx = (rb >> 7) & MASK;
      __nv_bfloat162 v[NT];
      if (MODE != M_FIRST) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          v[n] = *reinterpret_cast<const __nv_bfloat162*>(a.out + rb + ((n ^ rx) << 4));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float y0 = inside ? acc[i][n][2 * h] + bv[n].x : 0.f;
        const float y1 = inside ? acc[i][n][2 * h + 1] + bv[n].y : 0.f;
        if (MODE == M_FIRST) {
          v[n] = lrelu2(__floats2bfloat162_rn(y0, y1));
        } else {
          const float2 c = __bfloat1622float2(v[n]);
          v[n] = __floats2bfloat162_rn(c.x + y0, c.y + y1);
        }
      }
      if (MODE == M_FIRST || MODE == M_RES) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(a.out + rb + ((n ^ rx) << 4)) = v[n];
      }
      if (MODE == M_RES) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(a.lr + rb + ((n ^ rx) << 4)) = lrelu2(v[n]);
      } else if (MODE == M_KEEP) {
        const uint32_t kb = (uint32_t)(row - a.row_off) * RB + tig * 4;
        const uint32_t kx = (kb >> 7) & MASK;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(a.keep + kb + ((n ^ kx) << 4)) = v[n];
      } else if (MODE == M_SUM_SET || MODE == M_SUM_ADD) {
        float* ps = a.sum + (row - a.row_off) * (C + 1) + 2 * tig;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 f = __bfloat1622float2(v[n]);
          if (MODE == M_SUM_SET) {
            ps[8 * n] = f.x;
            ps[8 * n + 1] = f.y;
          } else {
            ps[8 * n] += f.x;
            ps[8 * n + 1] += f.y;
          }
        }
      }
    }
  }
}

// A window buffer holds 16 rows past the window: a ragged last m-tile reads
// them (whatever they hold) for rows it never stores.
//
// The m-tiles of the rows [olo, ohi) of a product are split evenly over the 8
// warps, at most MT each (the caller picks MT): the first nmt % 8 warps take
// one more. Sets this warp's m-tile count and first row.
__device__ __forceinline__ void split_rows(int olo, int ohi, int& cnt, int& row0) {
  const int warp = threadIdx.x >> 5;
  const int nmt = (ohi - olo + 15) >> 4, per = nmt / WARPS, rem = nmt % WARPS;
  cnt = per + (warp < rem);
  row0 = olo + (warp * per + min(warp, rem)) * 16;
}

// This lane's row of each B ldmatrix of a tap tile: output channel np 16 + 8
// (lane / 16) + lane % 8, input-channel chunk 2 kt + (lane / 8) % 2.
template <int C>
__device__ __forceinline__ void b_rows(uint32_t (&brow)[C / 16], uint32_t (&bxor)[C / 16]) {
  constexpr int RB = Tc<C>::RB, MASK = Tc<C>::MASK;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < C / 16; ++np) {
    const uint32_t rb = (np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * RB;
    brow[np] = rb;
    bxor[np] = ((rb >> 7) & MASK) ^ ((lane >> 3) & 1);
  }
}

// One tap of a product on the tensor cores: acc[i] += in[arow0 + 16 i + ..][ci]
// W[co][ci] for the tap tile of pipe.tap, then the tap is released. A
// fragments (16 rows x 16 input channels of the window at shared address in)
// and B fragments (16 output x 16 input channels of the tile) are one
// ldmatrix.x4 each. Every warp walks every tap, with or without rows of its own.
template <int C, int MT>
__device__ __forceinline__ void tap_mma(Pipe& pipe, uint32_t in, int arow0, int cnt,
                                        const uint32_t (&brow)[C / 16], const uint32_t (&bxor)[C / 16],
                                        float (&acc)[MT][C / 8][4]) {
  using G = Tc<C>;
  constexpr int RB = G::RB, KT = G::KT, NT = G::NT, MASK = G::MASK;
  const int lane = threadIdx.x & 31;
  const int t = pipe.tap;
  if (threadIdx.x == PRODUCER) produce<C>(pipe, t + AHEAD);
#ifdef TOWER_PROFILE
  long long q1 = clock64();
#endif
  // every A fragment of the tap first: they depend on the window alone, so
  // they are in flight while the tap's weights are waited for. This lane's
  // row of each A ldmatrix: window row + lane % 16, chunk 2 kt + lane / 16
  uint32_t af[MT][KT][4];
  if (cnt > 0) {
    const uint32_t arow = (uint32_t)(arow0 + (lane & 15)) * RB;
    const uint32_t axor = ((arow >> 7) & MASK) ^ (lane >> 4);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < cnt) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          ldsm4(af[i][kt], in + arow + i * 16 * RB + (((2 * kt) ^ axor) << 4));
      }
    }
  }
  wait_phase(pipe.full + 8 * (t % STAGES), (t / STAGES) & 1);
#ifdef TOWER_PROFILE
  pipe.wait_clk += clock64() - q1;
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
            mma_bf16(acc[i][n], af[i][kt], b[kt & 1][n >> 1][(n & 1) * 2],
                     b[kt & 1][n >> 1][(n & 1) * 2 + 1]);
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) arrive(pipe.empty + 8 * (t % STAGES));  // this warp is done with the stage
  pipe.tap = t + 1;
}

template <int C, int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][C / 8][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.f;
}

// One conv on the tensor cores: out[t][co] = sum_j sum_ci in[t + (j - half) d][ci] W_j[co][ci]
// over the rows [olo, ohi), then its epilogue.
template <int C, int MT>
__device__ __forceinline__ void conv_tc(Pipe& pipe, const ConvArgs& a) {
  int cnt, row0;
  split_rows(a.olo, a.ohi, cnt, row0);
  const int half = (a.k - 1) / 2;
  uint32_t brow[C / 16], bxor[C / 16];
  b_rows<C>(brow, bxor);
  float acc[MT][C / 8][4];
  zero_acc<C, MT>(acc);
  for (int j = 0; j < a.k; ++j) tap_mma<C, MT>(pipe, a.in, row0 + (j - half) * a.d, cnt, brow, bxor, acc);

  if (cnt == 0) return;
#ifdef TOWER_PROFILE
  long long e0 = clock64();
#endif
  switch (a.mode) {
    case M_FIRST: epilogue<C, MT, M_FIRST>(acc, a, cnt, row0); break;
    case M_RES: epilogue<C, MT, M_RES>(acc, a, cnt, row0); break;
    case M_SUM_SET: epilogue<C, MT, M_SUM_SET>(acc, a, cnt, row0); break;
    case M_SUM_ADD: epilogue<C, MT, M_SUM_ADD>(acc, a, cnt, row0); break;
    default: epilogue<C, MT, M_KEEP>(acc, a, cnt, row0); break;
  }
#ifdef TOWER_PROFILE
  pipe.epi_clk += clock64() - e0;
#endif
}

// K3's prologue on the tensor cores, one phase r: x0[u q + r][co] = sum over the
// phase's taps (m, j) and input-channel slices h of z_h[q + m_hi - m][ci]
// K_j[h C + ci][co] + b, for the window's nq = W / u rows q. The input window
// z = S(lrelu(x)) lies in n_half = C_in / C slices of [rows][C] bf16, each a
// swizzled time-major buffer of zh bytes at zin + h zh, its row 0 at input
// position q0 - m_hi; each (tap, slice) is one [C][C] tile of the ring. The
// epilogue writes cur = S(y) (0 outside [0, T)) and a = S(lrelu(cur)).
template <int C, int MT>
__device__ __forceinline__ void pre_phase_tc(Pipe& pipe, const Tower& tw, int r, uint32_t zin, int zh,
                                             const float* __restrict__ bpre, unsigned char* cur,
                                             unsigned char* lr, int nq, int t0, int T) {
  constexpr int RB = Tc<C>::RB, NT = Tc<C>::NT, MASK = Tc<C>::MASK;
  int cnt, row0;
  split_rows(0, nq, cnt, row0);
  uint32_t brow[C / 16], bxor[C / 16];
  b_rows<C>(brow, bxor);
  float acc[MT][C / 8][4];
  zero_acc<C, MT>(acc);
  const int n_half = tw.pre_cin / C;
  for (int e = 0; e < tw.pre_n[r]; ++e)
    for (int h = 0; h < n_half; ++h)
      tap_mma<C, MT>(pipe, zin + h * zh, row0 + tw.pre_mhi - tw.pre_m[r][e], cnt, brow, bxor, acc);
  if (cnt == 0) return;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3, u = tw.pre_u;
  float2 bv[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) bv[n] = __ldg(reinterpret_cast<const float2*>(bpre + 8 * n + 2 * tig));
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= cnt) break;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = row0 + 16 * i + gid + 8 * hh;
      if (q >= nq) continue;
      const int row = u * q + r, gt = t0 + row;
      const bool inside = gt >= 0 && gt < T;
      const uint32_t rb = (uint32_t)row * RB + tig * 4;
      const uint32_t rx = (rb >> 7) & MASK;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float y0 = inside ? acc[i][n][2 * hh] + bv[n].x : 0.f;
        const float y1 = inside ? acc[i][n][2 * hh + 1] + bv[n].y : 0.f;
        const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
        *reinterpret_cast<__nv_bfloat162*>(cur + rb + ((n ^ rx) << 4)) = v;
        *reinterpret_cast<__nv_bfloat162*>(lr + rb + ((n ^ rx) << 4)) = lrelu2(v);
      }
    }
  }
}

// MT = the fewest m-tiles a warp so that 8 warps cover the conv's rows. From C 32
// up a fourth m-tile would push a tap's fragments out of the registers (255 a
// thread at C 64; 128 at C 32, where two blocks share an SM), so the wrapper
// keeps those windows at 384 rows or fewer (512 at C 16).
template <int C>
__device__ __forceinline__ void conv_rows(Pipe& pipe, const ConvArgs& a) {
  constexpr int MT_TOP = C >= 32 ? 3 : MT_MAX;
  const int mt = (a.ohi - a.olo + 16 * WARPS - 1) / (16 * WARPS);
  if (mt > MT_TOP) __trap();
  if (mt <= 1) {
    conv_tc<C, 1>(pipe, a);
  } else if (mt == 2) {
    conv_tc<C, 2>(pipe, a);
  } else if (mt == 3) {
    conv_tc<C, 3>(pipe, a);
  } else {
    if constexpr (MT_TOP == MT_MAX) conv_tc<C, MT_MAX>(pipe, a);
  }
}

// The prologue's phase products have W / u <= 256 rows (the wrapper's tile
// geometry), so MT <= 2.
template <int C>
__device__ __forceinline__ void pre_rows(Pipe& pipe, const Tower& tw, int r, uint32_t zin, int zh,
                                         const float* __restrict__ bpre, unsigned char* cur,
                                         unsigned char* lr, int nq, int t0, int T) {
  const int mt = (nq + 16 * WARPS - 1) / (16 * WARPS);
  if (mt > 2) __trap();
  if (mt <= 1)
    pre_phase_tc<C, 1>(pipe, tw, r, zin, zh, bpre, cur, lr, nq, t0, T);
  else
    pre_phase_tc<C, 2>(pipe, tw, r, zin, zh, bpre, cur, lr, nq, t0, T);
}

// The shared memory of a tensor-core block, from a 1024-byte aligned base:
// the ring, three windows of buf bytes each (a, cur, y1), then the kernel's own
// area (K3: the f32 chain sum; K4: the centre tiles of all chains but the
// last), then the mbarriers.
struct Smem {
  unsigned char *ring, *cur, *a, *y1, *extra;
  uint64_t* bars;
};

template <int C>
__device__ __forceinline__ Smem carve(unsigned char* raw, int buf, int extra_bytes) {
  Smem s;
  s.ring = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  s.a = s.ring + STAGES * Tc<C>::TILE;
  s.cur = s.a + buf;
  s.y1 = s.cur + buf;
  s.extra = s.y1 + buf;
  s.bars = reinterpret_cast<uint64_t*>(s.extra + (extra_bytes + 15) / 16 * 16);
  return s;
}

template <int C>
__device__ __forceinline__ Pipe start_pipe(const Smem& s, const Tower& tw, const void* w) {
  Pipe p;
  p.ring = smem_addr(s.ring);
  p.full = smem_addr(s.bars);
  p.empty = p.full + 8 * STAGES;
  p.w = static_cast<const unsigned char*>(w);
  // the tap tiles of the whole tower in call order: per chain the prologue's
  // (phase, tap, input slice) tiles, then every conv's taps
  int pre_tiles = 0;
  for (int r = 0; r < tw.pre_u; ++r) pre_tiles += tw.pre_n[r] * (tw.pre_cin / C);
  p.total = 0;
  for (int g = 0; g < tw.G; ++g) p.total += pre_tiles + tw.k[g] * tw.n_convs[g];
  p.tap = 0;
#ifdef TOWER_PROFILE
  p.wait_clk = p.epi_clk = 0;
#endif
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(p.full + 8 * st) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(p.empty + 8 * st), "r"(WARPS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == PRODUCER)
    for (int t = 0; t < AHEAD; ++t) produce<C>(p, t);
  return p;
}

__device__ __forceinline__ int chain_halo(const Tower& tw, int g) {
  int h = 0;
  for (int i = 0; i < tw.n_convs[g]; ++i) h += (tw.k[g] - 1) / 2 * tw.dil[g][i];
  return h;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cur = x at window rows [lo, hi) (0 outside [0, Tv)), a = lrelu(cur); x rows
// are T long, Tv <= T of them valid. With T a multiple of 8, a thread takes one
// channel pair and 16 time steps aligned in global time: four 16-byte loads
// (two full sectors), then 16 4-byte stores, a warp's lanes side by side in one
// row. Rows up to 15 outside [lo, hi) are written too (inside the padded
// buffer; nothing reads them). Otherwise lanes run along time with 2-byte loads.
template <int C>
__device__ void load_window_tc(const __nv_bfloat16* __restrict__ x, unsigned char* cur,
                               unsigned char* a, int lo, int hi, int t0, int T, int Tv) {
  constexpr int RB = Tc<C>::RB, MASK = Tc<C>::MASK, NP = C / 2;
  if ((T & 7) == 0 && aligned16(x)) {
    const int g0 = (t0 + lo) & ~15, ng = (t0 + hi - g0 + 15) >> 4;
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
        if (gs + e >= Tv) p.x = p.y = __float2bfloat16(0.f);
        const uint32_t off = swz((uint32_t)row * RB + cp * 4, MASK);
        *reinterpret_cast<__nv_bfloat162*>(cur + off) = p;
        *reinterpret_cast<__nv_bfloat162*>(a + off) = lrelu2(p);
      }
    }
    return;
  }
  const int n = hi - lo;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < NP * n; i += THREADS) {
    const int cp = i / n, row = lo + i - cp * n, gt = t0 + row;
    __nv_bfloat162 v;
    v.x = v.y = zero;
    if (gt >= 0 && gt < Tv) {
      v.x = x[(size_t)(2 * cp) * T + gt];
      v.y = x[(size_t)(2 * cp + 1) * T + gt];
    }
    const uint32_t off = swz((uint32_t)row * RB + cp * 4, MASK);
    *reinterpret_cast<__nv_bfloat162*>(cur + off) = v;
    *reinterpret_cast<__nv_bfloat162*>(a + off) = lrelu2(v);
  }
}

// K3's prologue input: z = S(lrelu(x)) at input positions s0 .. s0 + rows (0
// outside [0, T_in)) into C_in / C slices of [rows][C] (swizzled, zh bytes
// apart) from zin. x: [C_in, T_in]. With T_in a multiple of 8, a thread takes
// one channel pair and 16 input positions aligned in global time, as
// load_window_tc does; otherwise lanes run along time with 2-byte loads.
template <int C>
__device__ void load_pre_window_tc(const __nv_bfloat16* __restrict__ x, unsigned char* zin, int zh,
                                   int rows, int s0, int T_in, int cin) {
  constexpr int RB = Tc<C>::RB, MASK = Tc<C>::MASK;
  if ((T_in & 7) == 0 && aligned16(x)) {
    const int NP = cin / 2, g0 = s0 & ~15, ng = (s0 + rows - g0 + 15) >> 4;
    for (int i = threadIdx.x; i < NP * ng; i += THREADS) {
      const int grp = i / NP, cp = i - grp * NP, gs = g0 + 16 * grp;
      alignas(16) __nv_bfloat16 v[2][16];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gt = gs + 8 * hh;
        uint4 u0 = make_uint4(0, 0, 0, 0), u1 = u0;
        if (gt >= 0 && gt < T_in) {
          u0 = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(2 * cp) * T_in + gt));
          u1 = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(2 * cp + 1) * T_in + gt));
        }
        *reinterpret_cast<uint4*>(&v[0][8 * hh]) = u0;
        *reinterpret_cast<uint4*>(&v[1][8 * hh]) = u1;
      }
      const int h = 2 * cp / C, c = 2 * cp - h * C;
      unsigned char* slice = zin + h * zh;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int row = gs - s0 + e;
        if (row < 0 || row >= rows) continue;
        __nv_bfloat162 p;
        p.x = v[0][e];
        p.y = v[1][e];
        *reinterpret_cast<__nv_bfloat162*>(slice + swz((uint32_t)row * RB + c * 2, MASK)) = lrelu2(p);
      }
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < (cin / 2) * rows; i += THREADS) {
    const int cp = i / rows, row = i - cp * rows, s = s0 + row;
    __nv_bfloat162 v;
    v.x = v.y = zero;
    if (s >= 0 && s < T_in) {
      v.x = x[(size_t)(2 * cp) * T_in + s];
      v.y = x[(size_t)(2 * cp + 1) * T_in + s];
    }
    const int h = 2 * cp / C, c = 2 * cp - h * C;
    *reinterpret_cast<__nv_bfloat162*>(zin + h * zh + swz((uint32_t)row * RB + c * 2, MASK)) = lrelu2(v);
  }
}

// Runs chain g from window rows [lo, W - lo) already loaded into cur/a. The
// last conv leaves the chain's output rows [lo + halo, W - lo - halo) in the
// f32 sum (final_mode M_SUM_*) or, with M_KEEP, in keep, or where keep is null in
// the window its last conv does not read (returned). Ends on a block barrier.
template <int C>
__device__ unsigned char* run_chain_tc(Pipe& pipe, const Tower& tw, int g, const float* bias, const Smem& s,
                             int lo, int W, int t0, int T, int final_mode, int row_off,
                             unsigned char* keep) {
  const int k = tw.k[g], half = (k - 1) / 2, n = tw.n_convs[g];
  int hi = W - lo;
  ConvArgs a;
  a.sum = reinterpret_cast<float*>(s.extra);
  a.keep = keep;
  a.k = k;
  a.t0 = t0;
  a.T = T;
  a.row_off = row_off;
  const int step = tw.resblock == 1 ? 2 : 1;
  unsigned char *in = s.a, *other = s.y1;
  for (int p = 0; p < n; p += step) {
    if (tw.resblock == 1) {
      a.d = tw.dil[g][p];
      lo += half * a.d;
      hi -= half * a.d;
      a.in = smem_addr(s.a);
      a.out = s.y1;
      a.bias = bias + p * C;
      a.mode = M_FIRST;
      a.olo = lo;
      a.ohi = hi;
      conv_rows<C>(pipe, a);
      __syncthreads();
      in = s.y1;
      other = s.a;
    }
    const int q = p + step - 1;
    a.d = tw.dil[g][q];
    lo += half * a.d;
    hi -= half * a.d;
    a.in = smem_addr(in);
    a.out = s.cur;
    a.lr = other;
    a.bias = bias + q * C;
    a.mode = q + 1 < n ? M_RES : final_mode;
    if (keep == nullptr) a.keep = other;
    a.olo = lo;
    a.ohi = hi;
    conv_rows<C>(pipe, a);
    __syncthreads();
    if (q + 1 < n && tw.resblock != 1) {  // the next conv reads the lrelu this one wrote
      unsigned char* t = in;
      in = other;
      other = t;
    }
  }
  return other;
}

// K3 on the tensor cores. x, y: [B, C, T] bf16 (y: [B, C_post, T] with a post
// conv). H >= Hc + (kp-1)/2, Hc the deepest chain's halo. w: every tap of the
// tower as a pre-swizzled [C_out][C_in] tile, in call order. With the prologue x
// is [B, C_in, T_in], T = u T_in, TT and H are multiples of u, and each chain
// first recomputes its window x0 = convT(lrelu(x)) from the input window, which
// lies in the y1 buffer until the chain's first conv. PRE: the prologue is
// compiled in (tw.pre_u > 0); the kernel without it keeps the chains' code as
// it was. Grid (ceil(T / TT), B).
template <int C, bool PRE>
__global__ void __launch_bounds__(THREADS, C == 64 ? 1 : 2)
tower_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
             const float* __restrict__ bias, const __nv_bfloat16* __restrict__ wpost,
             const float* __restrict__ bpost, const float* __restrict__ bpre,
             __nv_bfloat16* __restrict__ y, Tower tw, int T, int T_in, int TT, int H, int Hc, int buf,
             int C_post, int kp, int post_tanh) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int RB = Tc<C>::RB, MASK = Tc<C>::MASK, LDS = C + 1;
  const int W = TT + 2 * H, P = H - Hc, aw = TT + 2 * P;  // the sum covers window rows [Hc, Hc + aw)
  const Smem s = carve<C>(smem_raw, buf, aw * LDS * 4);
  Pipe pipe = start_pipe<C>(s, tw, w);
  float* sum = reinterpret_cast<float*>(s.extra);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int t0 = tile * TT - H;
  const __nv_bfloat16* xb = x + (size_t)b * (PRE ? (size_t)tw.pre_cin * T_in : (size_t)C * T);
  const float* bg = bias;
#ifdef TOWER_PROFILE
  long long tl = 0, tc = 0, c0 = clock64(), cs = c0;
#endif
  for (int g = 0; g < tw.G; ++g) {
    const int lo = Hc - chain_halo(tw, g);
    if constexpr (PRE) {
      const int u = tw.pre_u, nq = W / u, rows = ((nq + 15) & ~15) + tw.pre_span;
      const int zh = (rows * RB + 1023) / 1024 * 1024;
      load_pre_window_tc<C>(xb, s.y1, zh, rows, t0 / u - tw.pre_mhi, T_in, tw.pre_cin);
      __syncthreads();
      for (int r = 0; r < u; ++r) pre_rows<C>(pipe, tw, r, smem_addr(s.y1), zh, bpre, s.cur, s.a, nq, t0, T);
    } else {
      load_window_tc<C>(xb, s.cur, s.a, lo, W - lo, t0, T, T);
    }
    __syncthreads();
#ifdef TOWER_PROFILE
    long long c1 = clock64();
    tl += c1 - c0;
#endif
    run_chain_tc<C>(pipe, tw, g, bg, s, lo, W, t0, T, g == 0 ? M_SUM_SET : M_SUM_ADD, Hc, nullptr);
#ifdef TOWER_PROFILE
    c0 = clock64();
    tc += c0 - c1;
#endif
    bg += tw.n_convs[g] * C;
  }
#ifdef TOWER_PROFILE
  if ((threadIdx.x == 0 || threadIdx.x == 224) && blockIdx.y == 0 && (blockIdx.x == 3 || blockIdx.x == 200))
    printf("PROFILE C%d tile %d thr %d: load %lld chains %lld total %lld | full-wait %lld epilogue %lld taps %d\n",
           C, blockIdx.x, threadIdx.x, tl, tc, clock64() - cs, pipe.wait_clk, pipe.epi_clk, pipe.tap);
#endif
  const float n_chains = (float)tw.G;
  if (wpost == nullptr) {
    __nv_bfloat16* yb = y + (size_t)b * C * T + (size_t)tile * TT;
    if ((T & 7) == 0 && aligned16(y)) {  // a thread: one channel, 8 time steps, one 16-byte store
      for (int i = threadIdx.x; i < C * (TT / 8); i += THREADS) {
        const int grp = i / C, c = i - grp * C, j = 8 * grp;
        if (tile * TT + j >= T) break;
        alignas(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(sum[(P + j + e) * LDS + c] / n_chains);
        *reinterpret_cast<uint4*>(yb + (size_t)c * T + j) = *reinterpret_cast<const uint4*>(o);
      }
      return;
    }
    for (int i = threadIdx.x; i < C * TT; i += THREADS) {
      const int c = i / TT, j = i - c * TT;
      if (tile * TT + j < T) yb[(size_t)c * T + j] = __float2bfloat16(sum[(P + j) * LDS + c] / n_chains);
    }
    return;
  }
  // a = S(lrelu(mean)) over rows [Hc, Hc + aw), then the post conv in f32 FMAs
  for (int i = threadIdx.x; i < (C / 2) * aw; i += THREADS) {
    const int r = i / (C / 2), cp = i - r * (C / 2);
    const float* ps = sum + r * LDS + 2 * cp;
    *reinterpret_cast<__nv_bfloat162*>(s.a + swz((uint32_t)(Hc + r) * RB + cp * 4, MASK)) =
        __floats2bfloat162_rn(lrelu(ps[0] / n_chains), lrelu(ps[1] / n_chains));
  }
  __syncthreads();
  const int hp = (kp - 1) / 2;
  for (int i = threadIdx.x; i < C_post * TT; i += THREADS) {
    const int o = i / TT, j = i - o * TT, gt = tile * TT + j;
    if (gt >= T) continue;
    float acc = 0.f;
    for (int jj = 0; jj < kp; ++jj) {
      const uint32_t rb = (uint32_t)(H + j - hp + jj) * RB;
      const __nv_bfloat16* wr = wpost + (size_t)o * C * kp + jj;
      for (int cp = 0; cp < C / 2; ++cp) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(s.a + swz(rb + cp * 4, MASK)));
        acc = fmaf(__bfloat162float(__ldg(wr + (2 * cp) * kp)), v.x, acc);
        acc = fmaf(__bfloat162float(__ldg(wr + (2 * cp + 1) * kp)), v.y, acc);
      }
    }
    acc += bpost[o];
    if (post_tanh) acc = tanhf(acc);
    y[((size_t)b * C_post + o) * T + gt] = __float2bfloat16(acc);
  }
}

// K4 pass 1 on the tensor cores. outs: [G, B, C, T]; part: [B, nT, C, n_mom],
// the moments of the stored (rounded) values of this tile in the order
// m_0..m_{G-1}, q_00, q_01, ..., q_11, ...; every chain's centre tile stays in
// shared memory until the moments are taken. scratch (over the first two
// windows) holds the per-slice partial moments: 2 buf >= 2048 n_mom bytes.
template <int C>
__global__ void __launch_bounds__(THREADS, C == 64 ? 1 : 2)
gn_tower_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ outs,
                float* __restrict__ part, const int* __restrict__ lengths, Tower tw, int B, int T,
                int TT, int H, int buf) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int RB = Tc<C>::RB, MASK = Tc<C>::MASK;
  const int W = TT + 2 * H, G = tw.G;
  const Smem s = carve<C>(smem_raw, buf, (G - 1) * TT * RB);
  Pipe pipe = start_pipe<C>(s, tw, w);
  const int b = blockIdx.y, tile = blockIdx.x, nT = gridDim.x;
  const int t0 = tile * TT - H;
  const int width = min(TT, T - tile * TT);  // centre rows inside [0, T)
  const int Tv = valid_length(lengths, b, T);  // rows past it are read and written as 0
  const __nv_bfloat16* xb = x + (size_t)b * C * T;
  const float* bg = bias;
  // chain g's centre tile: rows g TT + j of the extra area; the last chain's
  // stays where its last conv can put it, rows H + j of a window free by then
  const unsigned char* last = nullptr;
  for (int g = 0; g < G; ++g) {
    const int lo = H - chain_halo(tw, g);
    load_window_tc<C>(xb, s.cur, s.a, lo, W - lo, t0, T, Tv);
    __syncthreads();
    last = run_chain_tc<C>(pipe, tw, g, bg, s, lo, W, t0, Tv, M_KEEP, g + 1 < G ? H - g * TT : 0,
                           g + 1 < G ? s.extra : nullptr);
    bg += tw.n_convs[g] * C;
  }
  for (int g = 0; g < G; ++g) {
    __nv_bfloat16* og = outs + ((size_t)g * B + b) * C * T + (size_t)tile * TT;
    const uint32_t base = g + 1 < G ? (uint32_t)(g * TT) * RB : (uint32_t)H * RB;
    const unsigned char* kp = g + 1 < G ? s.extra : last;
    if ((T & 7) == 0 && aligned16(outs)) {  // a thread: one channel, 8 time steps, one 16-byte store
      for (int i = threadIdx.x; i < C * (width / 8); i += THREADS) {
        const int grp = i / C, c = i - grp * C, j = 8 * grp;
        alignas(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = *reinterpret_cast<const __nv_bfloat16*>(kp + swz(base + (j + e) * RB + c * 2, MASK));
        *reinterpret_cast<uint4*>(og + (size_t)c * T + j) = *reinterpret_cast<const uint4*>(o);
      }
      continue;
    }
    for (int i = threadIdx.x; i < C * width; i += THREADS) {
      const int c = i / width, j = i - c * width;
      og[(size_t)c * T + j] =
          *reinterpret_cast<const __nv_bfloat16*>(kp + swz(base + j * RB + c * 2, MASK));
    }
  }
  // partial moments: thread (channel pair, time slice) sums its rows in order,
  // then the slices are summed in order
  constexpr int NP = C / 2, SLICES = THREADS / NP;
  const int n_mom = G + G * (G + 1) / 2;
  const int cp = threadIdx.x % NP, sl = threadIdx.x / NP;
  float2 m[MAX_CHAINS], q[MAX_CHAINS * (MAX_CHAINS + 1) / 2];
#pragma unroll
  for (int g = 0; g < MAX_CHAINS; ++g) m[g] = make_float2(0.f, 0.f);
#pragma unroll
  for (int e = 0; e < MAX_CHAINS * (MAX_CHAINS + 1) / 2; ++e) q[e] = make_float2(0.f, 0.f);
  for (int j = sl; j < width; j += SLICES) {
    float2 v[MAX_CHAINS];
#pragma unroll
    for (int g = 0; g < MAX_CHAINS; ++g)
      v[g] = g < G ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                         g + 1 < G ? s.extra + swz((uint32_t)(g * TT + j) * RB + cp * 4, MASK)
                                   : last + swz((uint32_t)(H + j) * RB + cp * 4, MASK)))
                   : make_float2(0.f, 0.f);
    int e = 0;
#pragma unroll
    for (int g = 0; g < MAX_CHAINS; ++g) {
      m[g].x += v[g].x;
      m[g].y += v[g].y;
#pragma unroll
      for (int h = g; h < MAX_CHAINS; ++h, ++e) {
        q[e].x += v[g].x * v[h].x;
        q[e].y += v[g].y * v[h].y;
      }
    }
  }
  __syncthreads();  // every read of the centre tiles is done: the scratch may lie over them
  float* scratch = reinterpret_cast<float*>(s.a);  // [SLICES][C][n_mom], over the first two windows
  {
    float* dst = scratch + ((size_t)sl * C + 2 * cp) * n_mom;
    int e = 0, col = G;
#pragma unroll
    for (int g = 0; g < MAX_CHAINS; ++g) {
      if (g < G) {
        dst[g] = m[g].x;
        dst[n_mom + g] = m[g].y;
      }
#pragma unroll
      for (int h = g; h < MAX_CHAINS; ++h, ++e) {
        if (g < G && h < G) {
          dst[col] = q[e].x;
          dst[n_mom + col] = q[e].y;
          ++col;
        }
      }
    }
  }
  __syncthreads();
  for (int item = threadIdx.x; item < C * n_mom; item += THREADS) {
    float t = 0.f;
    for (int i = 0; i < SLICES; ++i) t += scratch[(size_t)i * C * n_mom + item];
    part[((size_t)b * nT + tile) * C * n_mom + item] = t;
  }
}

// ------------------------------------------------------------ K4 passes after the towers

// mom[b, r] = sum over tiles, in tile order, of part[b, tile, r]; r < C * n_mom
__global__ void moments_reduce_kernel(const float* __restrict__ part, float* __restrict__ mom,
                                      int B, int nT, int CM) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * CM) return;
  const int b = i / CM, r = i % CM;
  float s = 0.f;
  for (int tile = 0; tile < nT; ++tile) s += part[((size_t)b * nT + tile) * CM + r];
  mom[i] = s;
}

// K4 pass 2a: the chained GroupNorm affines from the moments. With xs_g =
// GN_g(xs_{g-1} + r_g) and xs_g = K + sum_h A_h r_h, per batch row and
// channel: mean and variance of xs_{g-1} + r_g over a group follow from
// m_h = sum_t r_h and q_hl = sum_t r_h r_l. One block per batch row, one
// thread per channel, every operation a separately rounded f32 operation in
// the order of the plain version (gn_affines). mom: [B, C, n_mom]; scales,
// biases: [G, C] f32; A: [G, B, C]; K: [B, C]. The statistics of row b are over
// its valid length (lengths[b] clamped to [0, T], or T). Shared memory: 2 C floats.
__global__ void gn_affine_kernel(const float* __restrict__ mom, const float* __restrict__ scales,
                                 const float* __restrict__ biases, const int* __restrict__ lengths,
                                 float* __restrict__ A_out, float* __restrict__ K_out, int B, int C,
                                 int G, int gsize, int T, float eps) {
  extern __shared__ float sh[];
  float *sS = sh, *sQ = sh + C;
  const int b = blockIdx.x, c = threadIdx.x;
  const float Tf = (float)valid_length(lengths, b, T), N = (float)gsize * Tf;
  const bool live = c < C;
  const int n_mom = G + G * (G + 1) / 2;
  float m[MAX_CHAINS], q[MAX_CHAINS][MAX_CHAINS], A[MAX_CHAINS], K = 0.f;
#pragma unroll
  for (int g = 0; g < MAX_CHAINS; ++g) {
    A[g] = 0.f;
    m[g] = 0.f;
#pragma unroll
    for (int h = 0; h < MAX_CHAINS; ++h) q[g][h] = 0.f;
  }
  if (live) {
    const float* mp = mom + ((size_t)b * C + c) * n_mom;
    int col = G;
#pragma unroll
    for (int g = 0; g < MAX_CHAINS; ++g) {
      if (g < G) m[g] = mp[g];
#pragma unroll
      for (int h = g; h < MAX_CHAINS; ++h)
        if (g < G && h < G) q[g][h] = q[h][g] = mp[col++];
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_CHAINS; ++g) {
    if (g >= G) break;
    A[g] = __fadd_rn(A[g], 1.f);
    float S = __fmul_rn(K, Tf);
    float Q = __fmul_rn(__fmul_rn(K, K), Tf);
#pragma unroll
    for (int h = 0; h < MAX_CHAINS; ++h)
      if (h < G) S = __fadd_rn(S, __fmul_rn(A[h], m[h]));
#pragma unroll
    for (int h = 0; h < MAX_CHAINS; ++h) {
      if (h >= G) break;
      Q = __fadd_rn(Q, __fmul_rn(__fmul_rn(__fmul_rn(2.f, K), A[h]), m[h]));
#pragma unroll
      for (int l = 0; l < MAX_CHAINS; ++l)
        if (l < G) Q = __fadd_rn(Q, __fmul_rn(__fmul_rn(A[h], A[l]), q[h][l]));
    }
    __syncthreads();
    if (live) {
      sS[c] = S;
      sQ[c] = Q;
    }
    __syncthreads();
    if (live) {
      const int c0 = c / gsize * gsize;
      float gs = 0.f, gq = 0.f;
      for (int i = 0; i < gsize; ++i) {
        gs = __fadd_rn(gs, sS[c0 + i]);
        gq = __fadd_rn(gq, sQ[c0 + i]);
      }
      const float mu = __fdiv_rn(gs, N);
      const float var = __fadd_rn(__fdiv_rn(gq, N), -__fmul_rn(mu, mu));
      const float a = __fmul_rn(scales[g * C + c], __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
      const float bb = __fadd_rn(biases[g * C + c], -__fmul_rn(mu, a));
#pragma unroll
      for (int h = 0; h < MAX_CHAINS; ++h) A[h] = __fmul_rn(a, A[h]);
      K = __fadd_rn(__fmul_rn(a, K), bb);
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < MAX_CHAINS; ++g)
      if (g < G) A_out[((size_t)g * B + b) * C + c] = A[g];
    K_out[(size_t)b * C + c] = K;
  }
}

// K4 pass 2b: y[b, c, t] = K / G + sum_g (A_g / G) r_g[b, c, t] in f32, rounded
// once to S; 0 at t past row b's valid length (lengths[b] clamped to [0, T], or
// T). rs: [G, B, C, T]. Grid (B C, ceil(T / (256 V))), V = 16 / sizeof(S)
// elements per 16-byte load when T % V == 0, else one.
template <typename S, int V>
__global__ void gn_apply_kernel(const S* __restrict__ rs, const float* __restrict__ A,
                                const float* __restrict__ K, const int* __restrict__ lengths,
                                S* __restrict__ y, int C, int BC, int T, int G) {
  const int bc = blockIdx.x;
  const size_t t = ((size_t)blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (t >= (size_t)T) return;
  const int Tv = valid_length(lengths, bc / C, T);
  const float inv = 1.f / (float)G;
  float out[V];
  const float k = __fmul_rn(K[bc], inv);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = k;
  for (int g = 0; g < G; ++g) {
    const float ag = __fmul_rn(A[(size_t)g * BC + bc], inv);
    const S* src = rs + ((size_t)g * BC + bc) * T + t;
    alignas(16) S v[V];
    if constexpr (V == 1)
      v[0] = src[0];
    else
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = __fadd_rn(out[e], __fmul_rn(ag, to_f<S>(v[e])));
  }
  alignas(16) S o[V];
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = t + e < (size_t)Tv ? from_f<S>(out[e]) : from_f<S>(0.f);
  S* dst = y + (size_t)bc * T + t;
  if constexpr (V == 1)
    dst[0] = o[0];
  else
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

// ------------------------------------------------------------ host side

// spec: tc, G, resblock, k[MAX_CHAINS], n_convs[MAX_CHAINS], dil[MAX_CHAINS][MAX_CONVS],
// then the prologue: u, C_in, m_hi, span, n[MAX_U], m[MAX_U][MAX_PRE_TAPS], j[MAX_U][MAX_PRE_TAPS]
Tower make_tower(const int* spec) {
  Tower tw;
  tw.tc = spec[0];
  tw.G = spec[1];
  tw.resblock = spec[2];
  const int* p = spec + 3;
  for (int g = 0; g < MAX_CHAINS; ++g) tw.k[g] = *p++;
  for (int g = 0; g < MAX_CHAINS; ++g) tw.n_convs[g] = *p++;
  for (int g = 0; g < MAX_CHAINS; ++g)
    for (int i = 0; i < MAX_CONVS; ++i) tw.dil[g][i] = *p++;
  tw.pre_u = *p++;
  tw.pre_cin = *p++;
  tw.pre_mhi = *p++;
  tw.pre_span = *p++;
  for (int r = 0; r < MAX_U; ++r) tw.pre_n[r] = *p++;
  for (int r = 0; r < MAX_U; ++r)
    for (int e = 0; e < MAX_PRE_TAPS; ++e) tw.pre_m[r][e] = *p++;
  for (int r = 0; r < MAX_U; ++r)
    for (int e = 0; e < MAX_PRE_TAPS; ++e) tw.pre_j[r][e] = *p++;
  return tw;
}

template <typename S>
int run_tower_fma(const void* x, const void* w, const float* bias, const void* wpost,
                  const float* bpost, const void* wpre, const float* bpre, void* y, const Tower& tw,
                  int B, int C, int T, int T_in, int TT, int H, int Hc, int C_post, int kp,
                  int post_tanh, cudaStream_t stream) {
  const int ld = row_stride(TT + 2 * H), aw = TT + 2 * (H - Hc);
  const size_t smem = 3 * (size_t)C * ld * sizeof(S) + (size_t)C * aw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tower_fma_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  tower_fma_kernel<S><<<grid, THREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), bias, static_cast<const S*>(wpost),
      bpost, static_cast<const S*>(wpre), bpre, static_cast<S*>(y), tw, C, T, T_in, TT, H, Hc,
      C_post, kp, post_tanh);
  return (int)cudaGetLastError();
}

template <int C, bool PRE>
int launch_tower_tc(const void* x, const void* w, const float* bias, const void* wpost,
                 const float* bpost, const float* bpre, void* y, const Tower& tw, int B, int T,
                 int T_in, int TT, int H, int Hc, int buf, int smem, int C_post, int kp,
                 int post_tanh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tower_kernel<C, PRE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  tower_kernel<C, PRE><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, bias, static_cast<const __nv_bfloat16*>(wpost),
      bpost, bpre, static_cast<__nv_bfloat16*>(y), tw, T, T_in, TT, H, Hc, buf, C_post, kp,
      post_tanh);
  return (int)cudaGetLastError();
}

template <int C>
int run_tower_tc(const void* x, const void* w, const float* bias, const void* wpost,
                 const float* bpost, const float* bpre, void* y, const Tower& tw, int B, int T,
                 int T_in, int TT, int H, int Hc, int buf, int smem, int C_post, int kp,
                 int post_tanh, cudaStream_t stream) {
  return tw.pre_u ? launch_tower_tc<C, true>(x, w, bias, wpost, bpost, bpre, y, tw, B, T, T_in, TT, H, Hc, buf,
                                             smem, C_post, kp, post_tanh, stream)
                  : launch_tower_tc<C, false>(x, w, bias, wpost, bpost, bpre, y, tw, B, T, T_in, TT, H, Hc, buf,
                                              smem, C_post, kp, post_tanh, stream);
}

template <typename S>
int run_gn_tower_fma(const void* x, const void* w, const float* bias, void* outs, float* part,
                     const int* lengths, const Tower& tw, int B, int C, int T, int TT, int H,
                     cudaStream_t stream) {
  const int ld = row_stride(TT + 2 * H);
  const size_t smem = 3 * (size_t)C * ld * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(gn_tower_fma_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gn_tower_fma_kernel<S><<<dim3((T + TT - 1) / TT, B), THREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), bias, static_cast<S*>(outs), part,
      lengths, tw, B, C, T, TT, H);
  return (int)cudaGetLastError();
}

template <int C>
int run_gn_tower_tc(const void* x, const void* w, const float* bias, void* outs, float* part,
                    const int* lengths, const Tower& tw, int B, int T, int TT, int H, int buf,
                    int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gn_tower_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gn_tower_kernel<C><<<dim3((T + TT - 1) / TT, B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, bias, static_cast<__nv_bfloat16*>(outs), part,
      lengths, tw, B, T, TT, H, buf);
  return (int)cudaGetLastError();
}

template <typename S>
int run_gn_apply(const void* rs, const float* A, const float* K, const int* lengths, void* y, int B,
                 int C, int T, int G, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(S);
  if (T % V == 0)
    gn_apply_kernel<S, V><<<dim3(B * C, (T / V + 255) / 256), 256, 0, stream>>>(
        static_cast<const S*>(rs), A, K, lengths, static_cast<S*>(y), C, B * C, T, G);
  else
    gn_apply_kernel<S, 1><<<dim3(B * C, (T + 255) / 256), 256, 0, stream>>>(
        static_cast<const S*>(rs), A, K, lengths, static_cast<S*>(y), C, B * C, T, G);
  return (int)cudaGetLastError();
}

}  // namespace

// buf and smem (bytes of one window and of the block's dynamic shared memory)
// are read by the tensor-core path only (spec[0] = 1), which takes bf16 and C
// in {16, 32, 64}; the FMA path sizes its own shared memory. With a prologue
// (spec's u > 0) x is [B, C_in, T_in], T = u T_in; wpre ([k][C][C_in]) is read by
// the FMA path only, the tensor-core path takes its tiles from w.
extern "C" int acad_resblock_tower(const void* x, const void* w, const float* bias,
                                   const void* wpost, const float* bpost, const void* wpre,
                                   const float* bpre, void* y, const int* spec, int B, int C, int T,
                                   int T_in, int TT, int H, int Hc, int buf, int smem, int C_post,
                                   int kp, int post_tanh, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tower tw = make_tower(spec);
  if (tw.pre_u < 0 || tw.pre_u > MAX_U) return (int)cudaErrorInvalidValue;
  if (tw.tc) {
    if (!bf16 || (tw.pre_u && tw.pre_cin % C)) return (int)cudaErrorInvalidValue;
    if (C == 64)
      return run_tower_tc<64>(x, w, bias, wpost, bpost, bpre, y, tw, B, T, T_in, TT, H, Hc, buf, smem,
                              C_post, kp, post_tanh, s);
    if (C == 32)
      return run_tower_tc<32>(x, w, bias, wpost, bpost, bpre, y, tw, B, T, T_in, TT, H, Hc, buf, smem,
                              C_post, kp, post_tanh, s);
    if (C == 16)
      return run_tower_tc<16>(x, w, bias, wpost, bpost, bpre, y, tw, B, T, T_in, TT, H, Hc, buf, smem,
                              C_post, kp, post_tanh, s);
    return (int)cudaErrorInvalidValue;
  }
  if (bf16)
    return run_tower_fma<__nv_bfloat16>(x, w, bias, wpost, bpost, wpre, bpre, y, tw, B, C, T, T_in, TT,
                                        H, Hc, C_post, kp, post_tanh, s);
  return run_tower_fma<float>(x, w, bias, wpost, bpost, wpre, bpre, y, tw, B, C, T, T_in, TT, H, Hc,
                              C_post, kp, post_tanh, s);
}

// K4 pass 1 and the reduction of its per-tile moments over the tiles; lengths
// [B] int32 or null; mom null: the per-tile partials in part only
extern "C" int acad_resblock_tower_gn(const void* x, const void* w, const float* bias,
                                      void* outs, float* part, float* mom, const int* lengths,
                                      const int* spec, int B, int C, int T, int TT, int H, int buf,
                                      int smem, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tower tw = make_tower(spec);
  if (tw.pre_u) return (int)cudaErrorInvalidValue;
  int rc;
  if (tw.tc) {
    if (!bf16) return (int)cudaErrorInvalidValue;
    if (C == 64)
      rc = run_gn_tower_tc<64>(x, w, bias, outs, part, lengths, tw, B, T, TT, H, buf, smem, s);
    else if (C == 32)
      rc = run_gn_tower_tc<32>(x, w, bias, outs, part, lengths, tw, B, T, TT, H, buf, smem, s);
    else if (C == 16)
      rc = run_gn_tower_tc<16>(x, w, bias, outs, part, lengths, tw, B, T, TT, H, buf, smem, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (bf16) {
    rc = run_gn_tower_fma<__nv_bfloat16>(x, w, bias, outs, part, lengths, tw, B, C, T, TT, H, s);
  } else {
    rc = run_gn_tower_fma<float>(x, w, bias, outs, part, lengths, tw, B, C, T, TT, H, s);
  }
  if (rc != 0 || mom == nullptr) return rc;
  const int G = tw.G, CM = C * (G + G * (G + 1) / 2), nT = (T + TT - 1) / TT;
  moments_reduce_kernel<<<(B * CM + 255) / 256, 256, 0, s>>>(part, mom, B, nT, CM);
  return (int)cudaGetLastError();
}

// K4's moments reduction alone: mom [B, CM] = sum over part [B, nT, CM] in tile
// order. Time shards that each hold whole tiles of one sequence gather their
// per-tile partials in the sequence's tile order and reduce them here, so that
// the moments are the bits of one launch over the whole sequence.
extern "C" int acad_moments_reduce(const float* part, float* mom, int B, int nT, int CM, void* stream) {
  if (B < 0 || nT < 0 || CM < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || CM == 0) return 0;
  moments_reduce_kernel<<<(B * CM + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(part, mom, B, nT,
                                                                                                 CM);
  return (int)cudaGetLastError();
}

// K4 pass 2a: mom [B, C, n_mom], scales/biases [G, C] f32, lengths [B] int32 or null
// -> A [G, B, C], K [B, C]
extern "C" int acad_gn_affine(const float* mom, const float* scales, const float* biases,
                              const int* lengths, float* A, float* K, int B, int C, int G,
                              int num_groups, int T, float eps, void* stream) {
  if (G < 1 || G > MAX_CHAINS || C < 1 || C > 1024 || num_groups < 1 || C % num_groups)
    return (int)cudaErrorInvalidValue;
  const int gsize = C / num_groups, threads = (C + 31) / 32 * 32;
  gn_affine_kernel<<<B, threads, 2 * C * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      mom, scales, biases, lengths, A, K, B, C, G, gsize, T, eps);
  return (int)cudaGetLastError();
}

// K4 pass 2b: rs [G, B, C, T], A [G, B, C], K [B, C], lengths [B] int32 or null -> y [B, C, T]
extern "C" int acad_gn_apply(const void* rs, const float* A, const float* K, const int* lengths,
                             void* y, int B, int C, int T, int G, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return run_gn_apply<__nv_bfloat16>(rs, A, K, lengths, y, B, C, T, G, s);
  return run_gn_apply<float>(rs, A, K, lengths, y, B, C, T, G, s);
}
