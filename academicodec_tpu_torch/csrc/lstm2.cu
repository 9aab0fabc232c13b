// Fused 2-layer LSTM recurrence for Hopper (sm_90a): one persistent,
// weight-resident launch per call.
//
// Replaces the TPU kernel academicodec_tpu/ops/pallas/lstm.py:_lstm2_kernel
// (lstm2_fused). Input: the layer-1 input projection x_proj [T, B, 4H] f32
// (biases included), recurrent weights W_hh1, W_ih2, W_hh2 [4H, H] and the
// layer-2 bias b2 [4H] f32. Gate order i, f, g, o; carries f32; output y
// [T, B, H] holds layer 2's hidden states.
//
// The weight type W picks the function: bf16 rounds h to bf16 before each
// product (the Pallas kernel's numerics), f32 keeps it (the f32 scan path).
// Products accumulate in f32.
//
// Bound on the H100: at T 1000, B 8, H 512 the recurrent products are 50.3
// GFLOP (0.051 ms at the bf16 tensor-core peak) and ~80 MB move, but the
// real limit is the chain of T dependent steps: per step, one exchange of
// h between all blocks (a grid barrier plus an L2 round trip).
//
// Design: one cooperative launch runs all T + 1 steps. Block b owns JB hidden
// units (JB a multiple of 4, at most one block per SM) with all four gate
// rows of each, so the cell update stays in the block:
//  * the block's rows of W_hh1, W_ih2 and W_hh2 are loaded once into shared
//    memory (48 KB in bf16 at H 512, JB 4) and stay there for all steps; bf16
//    weights are stored in mma.sync A-fragment order, one 16-byte load per
//    thread per fragment;
//  * step s computes layer 1 at step s and layer 2 at step s - 1, so every
//    product reads hidden states finished before the last grid barrier:
//    h1[s-1] and h2[s-2], kept in global memory rounded to W, ping-ponged
//    and read through L2 (ld.global.cg). All 128 SMs read the same 16 KB at
//    every step, so the layout decides the step time: bf16 h is stored in
//    B-fragment order, one contiguous 8-byte load per lane per k-tile (a
//    [B][H] layout needs two 4-byte loads per k-tile that each touch 8
//    half-used sectors, and spent most of the step waiting on them);
//  * the products run on the tensor cores in bf16 (mma.sync m16n8k16: 16 gate
//    rows x 8 batch rows per fragment, no shuffle reductions) and in FMAs in
//    f32; 4 warps split layer 1's depth H and 8 warps layer 2's depth 2H
//    ([W_ih2 | W_hh2] against [h1; h2]), and the cell threads sum the warps'
//    partials from shared memory in a fixed order;
//  * c1 and c2 stay in shared memory; the next step's x_proj slice is
//    prefetched with cp.async before the barrier;
//  * one grid barrier per step: a monotone arrival counter in global memory,
//    a release add on arrival, an acquire load on the spin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 12;            // 4 on layer 1's product, 8 on layer 2's
constexpr int THREADS = WARPS * 32;
constexpr int P1_WARPS = WARPS / 3;

// k-tiles whose h loads a warp issues together before their products (an
// f32 k-tile is 16 floats of h per lane, a bf16 one 4 bytes)
template <typename W> struct Kind;
template <> struct Kind<__nv_bfloat16> { static constexpr int KG = 8; };
template <> struct Kind<float> { static constexpr int KG = 2; };

template <typename Y> __device__ __forceinline__ Y from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The cell update is on every step's critical path: exp and divide by the
// SFU approximations (relative error ~1e-7, far inside both dtypes'
// tolerances), arguments clamped where the results are already saturated.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-fmaxf(x, -80.f)));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * fminf(x, 40.f)) + 1.f);
}

// gates[4] -> new (h, c); c updated in place
__device__ __forceinline__ float cell(const float* gates, float* c) {
  const float i = sigmoid(gates[0]), f = sigmoid(gates[1]);
  const float g = tanh_fast(gates[2]), o = sigmoid(gates[3]);
  const float c_new = f * *c + i * g;
  *c = c_new;
  return o * tanh_fast(c_new);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives and waits until the counter reaches
// target = (barriers passed so far + 1) * gridDim.x. Writes made by any thread
// of a block before it arrives are visible to every block after the wait.
// A wait of more than 2^26 polls (seconds; each poll is an L2 round trip)
// traps, so that a fault turns into a launch error instead of a hung card.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    unsigned polls = 0;
    while (load_acquire(counter) < target) {
      if (++polls == (1u << 26)) __trap();
    }
  }
  __syncthreads();
}

// Element (batch b, unit k) of an h exchange buffer [Bp][Hp]. bf16: B-fragment
// order [b / 8][k / 16][lane = (b % 8) * 4 + (k % 8) / 2][k % 16 / 8][k % 2],
// so that the fragment of n-tile nt, k-tile kt is the uint2 at
// (nt * KT + kt) * 32 + lane. f32: row-major.
template <typename W>
__device__ __forceinline__ size_t h_index(int b, int k, int Hp) {
  if constexpr (sizeof(W) == 2) {
    const int kk = k & 15;
    return ((((size_t)(b >> 3) * (Hp >> 4) + (k >> 4)) * 32 + (b & 7) * 4 + ((kk & 7) >> 1)) * 2 +
            (kk >> 3)) * 2 + (kk & 1);
  } else {
    return (size_t)b * Hp + k;
  }
}

// Shared-memory layout of one block; the wrapper's lstm2_smem_bytes mirrors it.
struct Layout {
  int R, Hp, Bp, KT, NT, MT, ldw;
  size_t wbytes, red, xs, c1, c2, b2, total;  // byte offsets (red .. b2) and size
  __host__ __device__ Layout(int jb, int B, int H, bool bf16) {
    R = 4 * jb;
    Hp = (H + 15) / 16 * 16;
    Bp = (B + 7) / 8 * 8;
    KT = Hp / 16;
    NT = Bp / 8;
    MT = R / 16;
    ldw = Hp + 4;  // f32 rows: float4 reads of 8 rows hit distinct banks
    wbytes = bf16 ? (size_t)3 * R * Hp * 2 : (size_t)3 * R * ldw * 4;
    red = wbytes;
    xs = red + (size_t)WARPS * R * Bp * 4;
    c1 = xs + (size_t)R * Bp * 4;
    c2 = c1 + (size_t)jb * Bp * 4;
    b2 = c2 + (size_t)jb * Bp * 4;
    total = b2 + (size_t)R * 4;
  }
};

// Weights of this block's rows into shared memory, once. Local row
// lr = gate * jb + unit of matrix m (0 W_hh1, 1 W_ih2, 2 W_hh2); rows of units
// past H and columns past H are zero.
template <typename W>
__device__ __forceinline__ void load_weights(void* wsm, const W* w0, const W* w1, const W* w2,
                                             const Layout& L, int j0, int jb, int H);

template <>
__device__ __forceinline__ void load_weights<__nv_bfloat16>(void* wsm, const __nv_bfloat16* w0,
                                                            const __nv_bfloat16* w1,
                                                            const __nv_bfloat16* w2, const Layout& L,
                                                            int j0, int jb, int H) {
  // A fragment of m-tile mt, k-tile kt: uint4 per lane; register r holds rows
  // g (r even) / g + 8 (r odd) at columns 2t, 2t + 1 (+ 8 for r >= 2)
  uint32_t* frag = static_cast<uint32_t*>(wsm);
  const int words = 3 * L.MT * L.KT * 32 * 4;
  for (int i = threadIdx.x; i < words; i += THREADS) {
    const int r = i & 3, lane = (i >> 2) & 31, rest = i >> 7;
    const int kt = rest % L.KT, mt = (rest / L.KT) % L.MT, m = rest / (L.KT * L.MT);
    const int lr = mt * 16 + (lane >> 2) + 8 * (r & 1);
    const int k = kt * 16 + (lane & 3) * 2 + 8 * (r >> 1);
    const int gate = lr / jb, j = j0 + lr % jb;
    uint32_t word = 0;
    if (j < H) {
      const __nv_bfloat16* row = (m == 0 ? w0 : m == 1 ? w1 : w2) + (size_t)(gate * H + j) * H;
      const uint32_t lo = k < H ? __bfloat16_as_ushort(row[k]) : 0u;
      const uint32_t hi = k + 1 < H ? __bfloat16_as_ushort(row[k + 1]) : 0u;
      word = lo | (hi << 16);
    }
    frag[i] = word;
  }
}

template <>
__device__ __forceinline__ void load_weights<float>(void* wsm, const float* w0, const float* w1,
                                                    const float* w2, const Layout& L, int j0, int jb,
                                                    int H) {
  float* w = static_cast<float*>(wsm);  // [3][R][ldw]
  const int n = 3 * L.R * L.Hp;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int k = i % L.Hp, lr = (i / L.Hp) % L.R, m = i / (L.Hp * L.R);
    const int gate = lr / jb, j = j0 + lr % jb;
    const float* wm = m == 0 ? w0 : m == 1 ? w1 : w2;
    w[(m * L.R + lr) * L.ldw + k] = (j < H && k < H) ? wm[(size_t)(gate * H + j) * H + k] : 0.f;
  }
}

// acc (the C fragment of rows mt*16 + g (+8), batch columns nt*8 + 2t (+1))
// += this warp's k-tiles [lo, hi) of product p. Product 0 is W_hh1 h1prev over
// KT k-tiles; product 1 is [W_ih2 | W_hh2] [h1prev; h2prev] over 2 KT.
template <typename W>
__device__ __forceinline__ void warp_product(float acc[4], const void* wsm, const W* h1prev,
                                             const W* h2prev, const Layout& L, int p, int mt, int nt,
                                             int lo, int hi) {
  constexpr int KG = Kind<W>::KG;
  const int lane = threadIdx.x & 31;
  for (int kb = lo; kb < hi; kb += KG) {
    if constexpr (sizeof(W) == 2) {
      const uint4* frag = static_cast<const uint4*>(wsm);
      uint4 a[KG];
      uint32_t b[KG][2];
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int kt = kb + u;
        if (kt < hi) {
          const int m = p == 0 ? 0 : (kt < L.KT ? 1 : 2);
          const int kk = m == 2 ? kt - L.KT : kt;
          const uint2* hs = reinterpret_cast<const uint2*>(m == 2 ? h2prev : h1prev);
          const uint2 v = __ldcg(hs + ((size_t)nt * L.KT + kk) * 32 + lane);
          b[u][0] = v.x;
          b[u][1] = v.y;
          a[u] = frag[((m * L.MT + mt) * L.KT + kk) * 32 + lane];
        }
      }
      float acc2[4] = {0.f, 0.f, 0.f, 0.f};  // odd k-tiles: two chains of dependent mmas
#pragma unroll
      for (int u = 0; u < KG; ++u)
        if (kb + u < hi) mma_bf16(u & 1 ? acc2 : acc, a[u], b[u][0], b[u][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += acc2[e];
    } else {
      const int g = lane >> 2, t = lane & 3;
      const float* w = static_cast<const float*>(wsm);
      float4 hv[KG][2][4];
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int kt = kb + u;
        if (kt < hi) {
          const int m = p == 0 ? 0 : (kt < L.KT ? 1 : 2);
          const int kk = m == 2 ? kt - L.KT : kt;
          const float* hs = reinterpret_cast<const float*>(m == 2 ? h2prev : h1prev);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4* hp = reinterpret_cast<const float4*>(
                hs + (size_t)(nt * 8 + 2 * t + c) * L.Hp + kk * 16);
#pragma unroll
            for (int q = 0; q < 4; ++q) hv[u][c][q] = __ldcg(hp + q);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int kt = kb + u;
        if (kt < hi) {
          const int m = p == 0 ? 0 : (kt < L.KT ? 1 : 2);
          const int kk = m == 2 ? kt - L.KT : kt;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float4* wr = reinterpret_cast<const float4*>(
                w + (size_t)(m * L.R + mt * 16 + g + 8 * r) * L.ldw + kk * 16);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 wv = wr[q];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float4 h = hv[u][c][q];
                float& s = acc[2 * r + c];
                s = fmaf(wv.x, h.x, s);
                s = fmaf(wv.y, h.y, s);
                s = fmaf(wv.z, h.z, s);
                s = fmaf(wv.w, h.w, s);
              }
            }
          }
        }
      }
    }
  }
}

// x_proj[s] of this block's rows into xs [4 jb][Bp], by cp.async from the
// threads past warp 0 (thread 0 arrives at the barrier without waiting on them).
__device__ __forceinline__ void prefetch_x(float* xs, const float* __restrict__ xproj, int s, int B,
                                           int H, int jb, int j0, int Bp) {
  for (int i = threadIdx.x - 32; i < 4 * jb * B; i += THREADS - 32) {
    if (i < 0) continue;
    const int lr = i / B, b = i % B, j = j0 + lr % jb;
    if (j < H) cp_async4(xs + lr * Bp + b, xproj + ((size_t)s * B + b) * 4 * H + (lr / jb) * H + j);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename W, typename Y>
__global__ void __launch_bounds__(THREADS, 1)
lstm2_kernel(const float* __restrict__ xproj, const W* __restrict__ whh1, const W* __restrict__ wih2,
             const W* __restrict__ whh2, const float* __restrict__ b2, W* hbuf,
             unsigned* barrier, Y* __restrict__ y, int T, int B, int H, int jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(jb, B, H, sizeof(W) == 2);
  void* wsm = smem;
  float* red = reinterpret_cast<float*>(smem + L.red);  // [WARPS][R][Bp] partial products
  float* xs = reinterpret_cast<float*>(smem + L.xs);    // [R][Bp] x_proj of the next layer-1 step
  float* c1 = reinterpret_cast<float*>(smem + L.c1);    // [jb][Bp]
  float* c2 = reinterpret_cast<float*>(smem + L.c2);    // [jb][Bp]
  float* b2s = reinterpret_cast<float*>(smem + L.b2);   // [R] b2 of this block's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * jb;
  const size_t hsize = (size_t)L.Bp * L.Hp;
  W* h1buf = hbuf;              // [2][Bp][Hp] h1, rounded to W
  W* h2buf = hbuf + 2 * hsize;  // [2][Bp][Hp] h2, rounded to W

  load_weights<W>(wsm, whh1, wih2, whh2, L, j0, jb, H);
  for (int i = tid; i < 2 * jb * L.Bp; i += THREADS) c1[i] = 0.f;  // c1 and c2 are adjacent
  for (int i = tid; i < L.R; i += THREADS) {
    const int j = j0 + i % jb;
    b2s[i] = j < H ? b2[(i / jb) * H + j] : 0.f;
  }
  if (T > 0) prefetch_x(xs, xproj, 0, B, H, jb, j0, L.Bp);

  // this warp's product and k-tile range
  const int p = warp < P1_WARPS ? 0 : 1;
  const int wi = p == 0 ? warp : warp - P1_WARPS;
  const int nw = p == 0 ? P1_WARPS : WARPS - P1_WARPS;
  const int nkt = p == 0 ? L.KT : 2 * L.KT;
  const int per = (nkt + nw - 1) / nw;
  const int lo = min(nkt, wi * per), hi = min(nkt, lo + per);
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();

  for (int s = 0; s <= T; ++s) {
    const bool do1 = s < T, do2 = s >= 1;
    const W* h1prev = h1buf + ((s + 1) & 1) * hsize;  // h1[s-1]
    W* h1next = h1buf + (s & 1) * hsize;              // h1[s]
    const W* h2prev = h2buf + (s & 1) * hsize;        // h2[s-2]
    W* h2next = h2buf + ((s + 1) & 1) * hsize;        // h2[s-1]

    if (p == 0 ? do1 : do2) {
      for (int nt = 0; nt < L.NT; ++nt) {
        for (int mt = 0; mt < L.MT; ++mt) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          warp_product<W>(acc, wsm, h1prev, h2prev, L, p, mt, nt, lo, hi);
          float* rw = red + ((size_t)warp * L.R + mt * 16 + g) * L.Bp + nt * 8 + 2 * t;
          rw[0] = acc[0];
          rw[1] = acc[1];
          rw[8 * L.Bp] = acc[2];
          rw[8 * L.Bp + 1] = acc[3];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int i = tid; i < 2 * B * jb; i += THREADS) {
      const int layer = i / (B * jb), b = (i / jb) % B, u = i % jb, j = j0 + u;
      if (j >= H || (layer == 0 ? !do1 : !do2)) continue;
      float gates[4];
      if (layer == 0) {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int lr = gi * jb + u;
          float sum = 0.f;
          for (int w = 0; w < P1_WARPS; ++w) sum += red[((size_t)w * L.R + lr) * L.Bp + b];
          gates[gi] = xs[lr * L.Bp + b] + sum;
        }
        __stcg(h1next + h_index<W>(b, j, L.Hp), from_f<W>(cell(gates, c1 + u * L.Bp + b)));
      } else {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int lr = gi * jb + u;
          float sum = 0.f;
          for (int w = P1_WARPS; w < WARPS; ++w) sum += red[((size_t)w * L.R + lr) * L.Bp + b];
          gates[gi] = sum + b2s[lr];
        }
        const float h = cell(gates, c2 + u * L.Bp + b);
        __stcg(h2next + h_index<W>(b, j, L.Hp), from_f<W>(h));
        y[((size_t)(s - 1) * B + b) * H + j] = from_f<Y>(h);
      }
    }
    if (s == T) break;
    __syncthreads();  // xs consumed before it is refilled
    if (s + 1 < T) prefetch_x(xs, xproj, s + 1, B, H, jb, j0, L.Bp);
    grid_barrier(barrier, (unsigned)(s + 1) * gridDim.x);
  }
}

// The same grid and block shape doing nothing but barriers: the per-step
// floor of lstm2_kernel's exchange.
__global__ void __launch_bounds__(THREADS, 1) grid_barrier_kernel(unsigned* barrier, int iters) {
  for (int i = 0; i < iters; ++i) grid_barrier(barrier, (unsigned)(i + 1) * gridDim.x);
}

// Refuse a grid whose blocks cannot all be resident at once.
cudaError_t check_resident(const void* fn, int blocks, int smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err != cudaSuccess) return err;
  return (long)per_sm * sms < blocks ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename W, typename Y>
int run(const float* xproj, const void* whh1, const void* wih2, const void* whh2, const float* b2,
        void* hbuf, unsigned* barrier, void* y, int T, int B, int H, int jb, int blocks, int smem,
        cudaStream_t stream) {
  const Layout L(jb, B, H, sizeof(W) == 2);
  if (jb % 4 != 0 || (long)blocks * jb < H || L.total > (size_t)smem) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(lstm2_kernel<W, Y>);
  cudaError_t err = check_resident(fn, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  const W* w1 = static_cast<const W*>(whh1);
  const W* w2 = static_cast<const W*>(wih2);
  const W* w3 = static_cast<const W*>(whh2);
  W* hb = static_cast<W*>(hbuf);
  Y* yp = static_cast<Y*>(y);
  void* args[] = {&xproj, &w1, &w2, &w3, &b2, &hb, &barrier, &yp, &T, &B, &H, &jb};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, (size_t)smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int acad_lstm2(const float* xproj, const void* whh1, const void* wih2, const void* whh2,
                          const float* b2, void* hbuf, unsigned* barrier, void* y, int T, int B,
                          int H, int jb, int blocks, int smem, int w_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w_bf16 && !y_bf16)
    return run<float, float>(xproj, whh1, wih2, whh2, b2, hbuf, barrier, y, T, B, H, jb, blocks,
                             smem, s);
  if (w_bf16 && y_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(xproj, whh1, wih2, whh2, b2, hbuf, barrier, y, T, B,
                                             H, jb, blocks, smem, s);
  if (w_bf16)
    return run<__nv_bfloat16, float>(xproj, whh1, wih2, whh2, b2, hbuf, barrier, y, T, B, H, jb,
                                     blocks, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int acad_grid_barrier(unsigned* barrier, int iters, int blocks, int smem, void* stream) {
  const void* fn = reinterpret_cast<const void*>(grid_barrier_kernel);
  cudaError_t err = check_resident(fn, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&barrier, &iters};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
