// HiFi-GAN resblock towers for Hopper (sm_90a): K3 and K4.
//
// K3 tower_kernel replaces academicodec_tpu/ops/pallas/resblock.py:_tower_kernel
// (resblock_tower): the mean of G residual chains over one generator stage,
// with an optional lrelu -> conv_post -> tanh epilogue. K4 gn_tower_kernel
// replaces _gn_tower_kernel (resblock_tower_gn, pass 1): every chain of an
// encoder stage from the same input, each chain's output written, plus
// per-tile partial moments sum_t r_g and sum_t r_g r_h; moments_reduce_kernel
// sums the tiles in a fixed order (no atomics, so tokens do not vary from run
// to run). Pass 2, the GroupNorm algebra on [B, C] scalars, stays in PyTorch.
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
// cores (mma.sync m16n8k16) for bf16 storage with C % 16 == 0, in f32 FMAs
// otherwise (no TF32, so the f32 variant matches the CPU's plain version).
//
// Bound on the H100: at the flagship generator stage 2 ([8, 64, 120000], 3
// chains of 6 convs, sum of taps 126) the convs are 0.99 TFLOP, 1.0 ms at the
// bf16 tensor-core peak, against 0.25 GB moved: bound by operations. K4 at
// the encoder's stage 0 (the same shape and taps) is 0.99 TFLOP against
// 0.49 GB (its three chain outputs are written): bound by operations too.
//
// Design (simple and right first): one block per (time tile, batch row). The
// block holds a window of TT + 2H columns of all C channels in shared memory
// (H = the deepest chain's receptive halo, plus the post conv's), runs each
// chain through three [C, ld] buffers (the chain's running value, the lrelu'd
// conv input, the first conv's lrelu'd output) and only computes the columns
// that are still valid after each conv: the valid region shrinks by
// (k-1)/2 * d per side per conv. Each conv is k shifted [C x C] x [C x cols]
// products. On the tensor cores a warp owns up to 64 output channels x 32-128
// columns; its A fragments (weights, packed in fragment order by the
// wrapper) are 16-byte loads from global memory, L1/L2 resident (one bf16
// stage is ~1 MB), its B fragments 16-bit shared loads. The FMA path gives
// each lane 8 channels x 8 columns. K3 keeps an f32 accumulator of the chain
// sum over the centre. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CO_T = 8;            // output channels per thread
constexpr int T_T = 8;             // columns per thread, 32 apart
constexpr int STRIP = 32 * T_T;    // columns per warp unit
constexpr int MAX_CHAINS = 4;
constexpr int MAX_CONVS = 8;
constexpr float SLOPE = 0.1f;

struct Tower {
  int mma;       // bf16 tensor-core convs, fragment-order weights
  int G;         // chains
  int resblock;  // 1: pairs with a residual add per pair; 2: one conv per add
  int k[MAX_CHAINS];
  int n_convs[MAX_CHAINS];
  int dil[MAX_CHAINS][MAX_CONVS];  // per conv, in call order
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

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// conv(in) at window columns [olo, ohi) on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulate): per tap j, out[co, t] +=
// W_j[co, ci] in[ci, t + (j - half) d]. Weights come packed in A-fragment
// order [k][C/16][C/16][lane][8] (one 16-byte load per thread per
// fragment). A warp unit is MT m-tiles (16 channels) x NT n-tiles (8 columns)
// with MT * NT = 16. B fragments pair rows ci, ci + 1 of one column from
// two 16-bit shared loads; the row stride ld = 8 (mod 64) keeps them
// conflict-free. Columns past ohi are computed from clamped reads and
// never stored. KT > 0 fixes C = 16 KT at compile time, so that the k-tile
// loop unrolls and the next tile's loads overlap this tile's products.
template <int MODE, int MT, int KT>
__device__ void conv_pass_mma(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out,
                              const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                              int C, int ld, int W, int k, int d, int olo, int ohi, int t0,
                              int T) {
  constexpr int NT = 16 / MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m_tiles = KT > 0 ? KT : C / 16, groups = m_tiles / MT;
  const int cols = ohi > olo ? (ohi - olo + NT * 8 - 1) / (NT * 8) : 0;
  const int half = (k - 1) / 2;
  const unsigned short* in16 = reinterpret_cast<const unsigned short*>(in);
  const uint4* wf = reinterpret_cast<const uint4*>(w);
  for (int u = warp; u < groups * cols; u += WARPS) {
    const int mt0 = (u % groups) * MT;
    const int n0 = olo + (u / groups) * (NT * 8);
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.f;
    for (int j = 0; j < k; ++j) {
      int col[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) col[n] = min(n0 + n * 8 + gid + (j - half) * d, W - 1);
#pragma unroll
      for (int kt = 0; kt < m_tiles; ++kt) {
        const unsigned short* r0 = in16 + (kt * 16 + tig * 2) * ld;
        uint32_t b[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const unsigned short* p = r0 + col[n];
          b[n][0] = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
          b[n][1] = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint4 a = __ldg(wf + ((size_t)(j * m_tiles + mt0 + i) * m_tiles + kt) * 32 + lane);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], a, b[n][0], b[n][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = n0 + n * 8 + tig * 2 + (r & 1);
          if (t < ohi)
            store_out<__nv_bfloat16, MODE>(out, ld, (mt0 + i) * 16 + gid + (r >> 1) * 8, t,
                                           acc[i][n][r], bias, t0, T);
        }
  }
}

// One conv of a chain: the tensor-core path for bf16 with C % 16 == 0 (the
// wrapper then packs fragment-order weights), f32 FMAs otherwise.
template <typename S, int MODE>
__device__ void conv(const S* in, S* out, const S* w, const float* bias, bool mma, int C, int ld,
                     int W, int k, int d, int olo, int ohi, int t0, int T) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    if (mma) {
      if (C == 64)
        conv_pass_mma<MODE, 4, 4>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      else if (C == 32)
        conv_pass_mma<MODE, 2, 2>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      else if (C == 16)
        conv_pass_mma<MODE, 1, 1>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      else if (C % 64 == 0)
        conv_pass_mma<MODE, 4, 0>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      else if (C % 32 == 0)
        conv_pass_mma<MODE, 2, 0>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      else
        conv_pass_mma<MODE, 1, 0>(in, out, w, bias, C, ld, W, k, d, olo, ohi, t0, T);
      return;
    }
  }
  conv_pass<S, MODE>(in, out, w, bias, C, ld, k, d, olo, ohi, t0, T);
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

// cur = x at global columns t0 .. t0 + W (0 outside [0, T)), a = S(lrelu(cur))
template <typename S>
__device__ void load_window(const S* __restrict__ x, S* cur, S* a, int C, int ld, int W,
                            int t0, int T) {
  for (int i = threadIdx.x; i < C * W; i += THREADS) {
    const int c = i / W, col = i % W, gt = t0 + col;
    const S v = (gt >= 0 && gt < T) ? x[(size_t)c * T + gt] : from_f<S>(0.f);
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
      conv<S, OUT_LRELU>(a, y1, w + p * wstride, bias + p * C, tw.mma, C, ld, W, k, d,
                         lo + r, hi - r, t0, T);
      lo += r;
      hi -= r;
      __syncthreads();
      d = tw.dil[g][p + 1];
      r = half * d;
      conv<S, OUT_RESIDUAL>(y1, cur, w + (p + 1) * wstride, bias + (p + 1) * C, tw.mma, C, ld,
                            W, k, d, lo + r, hi - r, t0, T);
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
      conv<S, OUT_RESIDUAL>(a, cur, w + p * wstride, bias + p * C, tw.mma, C, ld, W, k, d,
                            lo + r, hi - r, t0, T);
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

// shared row stride of a window of W columns: 8 (mod 64) elements for the
// tensor-core path's conflict-free 16-bit B-fragment loads
__host__ __device__ __forceinline__ int row_stride(int W, int mma) {
  return mma ? (W + 63) / 64 * 64 + 8 : (W + 7) / 8 * 8;
}

// K3. x, y: [B, C, T] (y: [B, C_post, T] with a post conv). H = Hc + (kp-1)/2,
// Hc the deepest chain's halo. Grid (ceil(T / TT), B).
template <typename S>
__global__ void __launch_bounds__(THREADS)
tower_kernel(const S* __restrict__ x, const S* __restrict__ w, const float* __restrict__ bias,
             const S* __restrict__ wpost, const float* __restrict__ bpost, S* __restrict__ y,
             Tower tw, int C, int T, int TT, int H, int Hc, int C_post, int kp, int post_tanh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = TT + 2 * H, ld = row_stride(W, tw.mma);
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* a = cur + C * ld;
  S* y1 = a + C * ld;
  const int P = H - Hc, aw = TT + 2 * P;  // acc covers window columns [Hc, Hc + aw)
  float* acc = reinterpret_cast<float*>(y1 + C * ld);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int t0 = tile * TT - H;
  const S* xb = x + (size_t)b * C * T;
  const S* wg = w;
  const float* bg = bias;
  for (int g = 0; g < tw.G; ++g) {
    load_window(xb, cur, a, C, ld, W, t0, T);
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

// K4 pass 1. outs: [G, B, C, T]; part: [B, nT, C, n_mom] with the moments of
// the stored (rounded) values in the order m_0..m_{G-1}, q_00, q_01, ..., q_11, ...
template <typename S>
__global__ void __launch_bounds__(THREADS)
gn_tower_kernel(const S* __restrict__ x, const S* __restrict__ w, const float* __restrict__ bias,
                S* outs, float* __restrict__ part, Tower tw, int B, int C, int T, int TT, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = TT + 2 * H, ld = row_stride(W, tw.mma);
  S* cur = reinterpret_cast<S*>(smem_raw);
  S* a = cur + C * ld;
  S* y1 = a + C * ld;
  const int b = blockIdx.y, tile = blockIdx.x, nT = gridDim.x;
  const int t0 = tile * TT - H;
  const int width = min(TT, T - tile * TT);  // centre columns inside [0, T)
  const S* xb = x + (size_t)b * C * T;
  const S* wg = w;
  const float* bg = bias;
  for (int g = 0; g < tw.G; ++g) {
    load_window(xb, cur, a, C, ld, W, t0, T);
    __syncthreads();
    int lo, hi;
    run_chain(tw, g, wg, bg, cur, a, y1, C, ld, W, t0, T, lo, hi);
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

// spec: mma, G, resblock, k[MAX_CHAINS], n_convs[MAX_CHAINS], dil[MAX_CHAINS][MAX_CONVS]
Tower make_tower(const int* spec) {
  Tower tw;
  tw.mma = spec[0];
  tw.G = spec[1];
  tw.resblock = spec[2];
  for (int g = 0; g < MAX_CHAINS; ++g) {
    tw.k[g] = spec[3 + g];
    tw.n_convs[g] = spec[3 + MAX_CHAINS + g];
    for (int i = 0; i < MAX_CONVS; ++i) tw.dil[g][i] = spec[3 + 2 * MAX_CHAINS + g * MAX_CONVS + i];
  }
  return tw;
}

template <typename S>
int run_tower(const void* x, const void* w, const float* bias, const void* wpost,
              const float* bpost, void* y, const int* spec, int B, int C, int T, int TT, int H,
              int Hc, int C_post, int kp, int post_tanh, cudaStream_t stream) {
  const int ld = row_stride(TT + 2 * H, spec[0]), aw = TT + 2 * (H - Hc);
  const size_t smem = 3 * (size_t)C * ld * sizeof(S) + (size_t)C * aw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tower_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  tower_kernel<S><<<grid, THREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), bias, static_cast<const S*>(wpost),
      bpost, static_cast<S*>(y), make_tower(spec), C, T, TT, H, Hc, C_post, kp, post_tanh);
  return (int)cudaGetLastError();
}

template <typename S>
int run_gn_tower(const void* x, const void* w, const float* bias, void* outs, float* part,
                 float* mom, const int* spec, int B, int C, int T, int TT, int H,
                 cudaStream_t stream) {
  const int ld = row_stride(TT + 2 * H, spec[0]);
  const size_t smem = 3 * (size_t)C * ld * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(gn_tower_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nT = (T + TT - 1) / TT;
  const Tower tw = make_tower(spec);
  gn_tower_kernel<S><<<dim3(nT, B), THREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), bias, static_cast<S*>(outs), part, tw,
      B, C, T, TT, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int CM = C * (tw.G + tw.G * (tw.G + 1) / 2);
  moments_reduce_kernel<<<(B * CM + 255) / 256, 256, 0, stream>>>(part, mom, B, nT, CM);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int acad_resblock_tower(const void* x, const void* w, const float* bias,
                                   const void* wpost, const float* bpost, void* y,
                                   const int* spec, int B, int C, int T, int TT, int H, int Hc,
                                   int C_post, int kp, int post_tanh, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_tower<__nv_bfloat16>(x, w, bias, wpost, bpost, y, spec, B, C, T, TT, H, Hc,
                                    C_post, kp, post_tanh, s);
  return run_tower<float>(x, w, bias, wpost, bpost, y, spec, B, C, T, TT, H, Hc, C_post, kp,
                          post_tanh, s);
}

extern "C" int acad_resblock_tower_gn(const void* x, const void* w, const float* bias,
                                      void* outs, float* part, float* mom, const int* spec,
                                      int B, int C, int T, int TT, int H, int bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_gn_tower<__nv_bfloat16>(x, w, bias, outs, part, mom, spec, B, C, T, TT, H, s);
  return run_gn_tower<float>(x, w, bias, outs, part, mom, spec, B, C, T, TT, H, s);
}
