// Fused 2-layer LSTM recurrence for Hopper (sm_90a).
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
// real limit is the chain of T dependent steps.
//
// Design (simple and right first): one launch per step s = 0..T. Layer 1
// computes step s and layer 2 step s-1, so every launch reads only hidden
// states that the previous launch finished. Each block owns JB hidden units
// with all four of their gate rows, so the cell update stays in the block;
// each warp computes 8 gate rows of one matrix against all batch rows, with
// h staged in shared memory. h is ping-ponged and c updated in place in
// global memory. The T + 1 launches are enqueued by the host loop below in
// one call. Keeping the 6 MiB of bf16 weights resident across a persistent
// multi-block kernel is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int JB = 4;               // hidden units per block
constexpr int ROWS = 2 * JB;        // gate rows per warp task: 2 gates x JB units
constexpr int NB = 8;               // batch rows per pass
constexpr int WARPS = 6;            // 3 matrices x 2 gate pairs
constexpr int THREADS = WARPS * 32;

template <typename W> __device__ __forceinline__ float to_f(W v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename W> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename Y> __device__ __forceinline__ Y from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// gates[4] -> new (h, c); c updated in place
__device__ __forceinline__ float cell(const float* gates, float* c) {
  const float i = sigmoid(gates[0]), f = sigmoid(gates[1]);
  const float g = tanhf(gates[2]), o = sigmoid(gates[3]);
  const float c_new = f * *c + i * g;
  *c = c_new;
  return o * tanhf(c_new);
}

template <typename W, typename Y>
__global__ void __launch_bounds__(THREADS)
lstm2_step_kernel(const float* __restrict__ xproj, const W* __restrict__ whh1,
                  const W* __restrict__ wih2, const W* __restrict__ whh2,
                  const float* __restrict__ b2, float* __restrict__ h1buf,
                  float* __restrict__ c1, float* __restrict__ h2buf,
                  float* __restrict__ c2, Y* __restrict__ y, int s, int T, int B,
                  int H) {
  extern __shared__ float smem[];
  float* hp1 = smem;          // [B][H] h1[s-1], rounded to W
  float* hp2 = hp1 + B * H;   // [B][H] h2[s-2], rounded to W
  float* part = hp2 + B * H;  // [3 matrices][4 gates][JB][B] products

  const bool do1 = s < T, do2 = s >= 1;
  const float* h1prev = h1buf + ((s + 1) & 1) * B * H;  // h1[s-1]
  float* h1next = h1buf + (s & 1) * B * H;              // h1[s]
  const float* h2prev = h2buf + (s & 1) * B * H;        // h2[s-2]
  float* h2next = h2buf + ((s + 1) & 1) * B * H;        // h2[s-1]

  for (int i = threadIdx.x; i < B * H; i += THREADS) {
    hp1[i] = round_to<W>(h1prev[i]);
    hp2[i] = round_to<W>(h2prev[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * JB;
  const int m = warp >> 1;         // 0: W_hh1 h1, 1: W_ih2 h1, 2: W_hh2 h2
  const int g0 = (warp & 1) * 2;   // this warp's gates g0, g0 + 1
  if (m == 0 ? do1 : do2) {
    const W* wm = m == 0 ? whh1 : (m == 1 ? wih2 : whh2);
    const float* hv = m == 2 ? hp2 : hp1;
    const W* wrow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = min(j0 + r % JB, H - 1);  // rows past H are computed, never stored
      wrow[r] = wm + (size_t)((g0 + r / JB) * H + j) * H;
    }
    for (int b0 = 0; b0 < B; b0 += NB) {
      const int nb = min(NB, B - b0);
      float acc[ROWS][NB];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
      for (int kk = lane; kk < H; kk += 32) {
        float w[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) w[r] = to_f<W>(wrow[r][kk]);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const float h = hv[(b0 + b) * H + kk];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r][b] = fmaf(w[r], h, acc[r][b]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float v = acc[r][b];
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0 && b < nb)
            part[((m * 4 + g0 + r / JB) * JB + r % JB) * B + b0 + b] = v;
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 2 * B * JB; i += THREADS) {
    const int layer = i / (B * JB), b = (i / JB) % B, jj = i % JB, j = j0 + jj;
    if (j >= H) continue;
    float gates[4];
    if (layer == 0) {
      if (!do1) continue;
      const float* xp = xproj + ((size_t)s * B + b) * 4 * H;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[g] = xp[g * H + j] + part[((0 * 4 + g) * JB + jj) * B + b];
      h1next[b * H + j] = cell(gates, c1 + b * H + j);
    } else {
      if (!do2) continue;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[g] = (part[((1 * 4 + g) * JB + jj) * B + b] +
                    part[((2 * 4 + g) * JB + jj) * B + b]) + b2[g * H + j];
      const float h = cell(gates, c2 + b * H + j);
      h2next[b * H + j] = h;
      y[((size_t)(s - 1) * B + b) * H + j] = from_f<Y>(h);
    }
  }
}

template <typename W, typename Y>
int run(const float* xproj, const void* whh1, const void* wih2, const void* whh2,
        const float* b2, float* scratch, void* y, int T, int B, int H,
        cudaStream_t stream) {
  const size_t smem = (size_t)(2 * B * H + 3 * 4 * JB * B) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_step_kernel<W, Y>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // scratch: h1 ping-pong [2][B][H], h2 ping-pong [2][B][H], c1 [B][H], c2 [B][H]
  err = cudaMemsetAsync(scratch, 0, (size_t)6 * B * H * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  float* h1buf = scratch;
  float* h2buf = scratch + 2 * B * H;
  float* c1 = scratch + 4 * B * H;
  float* c2 = scratch + 5 * B * H;
  const int blocks = (H + JB - 1) / JB;
  for (int s = 0; s <= T; ++s) {
    lstm2_step_kernel<W, Y><<<blocks, THREADS, smem, stream>>>(
        xproj, static_cast<const W*>(whh1), static_cast<const W*>(wih2),
        static_cast<const W*>(whh2), b2, h1buf, c1, h2buf, c2, static_cast<Y*>(y),
        s, T, B, H);
    if (s == 0 && (err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int acad_lstm2(const float* xproj, const void* whh1, const void* wih2,
                          const void* whh2, const float* b2, float* scratch, void* y,
                          int T, int B, int H, int w_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w_bf16 && !y_bf16)
    return run<float, float>(xproj, whh1, wih2, whh2, b2, scratch, y, T, B, H, s);
  if (w_bf16 && y_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(xproj, whh1, wih2, whh2, b2, scratch, y,
                                             T, B, H, s);
  if (w_bf16)
    return run<__nv_bfloat16, float>(xproj, whh1, wih2, whh2, b2, scratch, y, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}
