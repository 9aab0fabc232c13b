// The Snake epilogue of a bias-free conv, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs no Snake-activated model. It
// serves the Descript Audio Codec's towers (nn/dac.py), where every conv but
// two runs without its bias and everything from that conv to the next one is
// this one launch: per element of a conv output h (channel c)
//
//   s = h + bias[c] (+ residual)      the ResidualUnit's sum, where one ends
//   y = s + sin(alpha[c] * s)^2 / (alpha[c] + 1e-9)
//
// in f32, the I/O in the tensor's dtype (bf16, f16 or f32). It writes y, and s
// only where a later residual add reads it. The reciprocal is IEEE
// (correctly rounded), as torch's; y is one fused multiply-add, s + inv * sin^2.
//
// Bound on the H100: bytes. 4-8 bytes an element in bf16 (h and y, plus the
// residual and s where there are) against ~8 f32 operations, so the design
// only has to keep the loads and stores streaming at 16 bytes a thread and
// the instruction count low:
//  * sin is the hardware __sinf after the argument is reduced to [-pi/2, pi/2]
//    (sin^2 has period pi; two FMAs against pi in two parts, so the reduction
//    is exact to ~1e-10 for |alpha s| < 1e5); __sinf's absolute error there is
//    ~4e-7. No fast math on unreduced arguments: the activations of
//    random-weight towers reach hundreds;
//  * channels-last [B, C, 1, T] (frames_kernel): each thread owns one vector
//    of V = 16 / sizeof(T) channels for the whole launch, so it reads alpha and
//    bias and computes the reciprocal once, then walks the frames of one batch
//    row (blockIdx.y) with a grid stride. Rows may be strided (a view of the
//    first T frames of a longer conv output), and y may have Ty >= T frames a
//    row, the frames past T written as zeros: the zero padding a dilated conv
//    run as its phases reads (nn/conv.py conv_phases), so that no pad or crop
//    copies the activation;
//  * channels-first [B, C, T] (rows_kernel): one channel a row, its scalars
//    held per block, V elements a thread where T allows (one element else).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INV_PI = 0.318309886183790672f;
constexpr float PI_HI = 3.14159274101257324f;     // float(pi)
constexpr float PI_LO = -8.74227765734758577e-8f;  // pi - PI_HI
constexpr float ALPHA_EPS = 1e-9f;
constexpr int THREADS = 256;

__device__ __forceinline__ float snake(float s, float alpha, float inv) {
  const float a = alpha * s;
  const float k = rintf(a * INV_PI);
  const float r = fmaf(-k, PI_LO, fmaf(-k, PI_HI, a));  // a - k pi, in [-pi/2, pi/2]
  const float sn = __sinf(r);                            // sin(r)^2 = sin(a)^2
  return fmaf(inv, sn * sn, s);
}

// V elements at p: 16 bytes for V > 1, else one
template <typename T, int V> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[8]) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

template <> struct Vec<__half, 8> {
  static __device__ __forceinline__ void load(const __half* p, float v[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p, const float v[8]) {
    uint4 a;
    __half2* h = reinterpret_cast<__half2*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float v[1]) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float v[1]) { *p = v[0]; }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

template <> struct Vec<__half, 1> {
  static __device__ __forceinline__ void load(const __half* p, float v[1]) { v[0] = __half2float(*p); }
  static __device__ __forceinline__ void store(__half* p, const float v[1]) { *p = __float2half_rn(v[0]); }
};

// Channels-last: x [B, T frames (row stride xb), C] -> y [B, Ty frames (yb), C], s [B, T (sb), C].
// blockDim.x = CV * R: thread (cv, fr) owns channels cv*V .. cv*V+V-1 and frames
// fr + R * (blockIdx.x + gridDim.x * i) of row blockIdx.y.
template <typename T, int V>
__global__ void __launch_bounds__(512) snake_frames_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ bias,
    const float* __restrict__ alpha, T* __restrict__ y, T* __restrict__ s, int C, int Tn, int Ty,
    long long xb, long long rb, long long yb, long long sb) {
  const int CV = C / V, R = blockDim.x / CV;
  const int cv = threadIdx.x % CV, fr = threadIdx.x / CV, c0 = cv * V;
  const long long b = blockIdx.y;
  float al[V], inv[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    al[j] = __ldg(alpha + c0 + j);
    inv[j] = 1.0f / (al[j] + ALPHA_EPS);
    bi[j] = bias ? __ldg(bias + c0 + j) : 0.f;
  }
  const T* xr = x + b * xb + c0;
  const T* rr = res ? res + b * rb + c0 : nullptr;
  T* yr = y + b * yb + c0;
  T* sr = s ? s + b * sb + c0 : nullptr;
  for (int f = blockIdx.x * R + fr; f < Ty; f += gridDim.x * R) {
    const long long o = (long long)f * C;
    float v[V];
    if (f < Tn) {
      Vec<T, V>::load(xr + o, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += bi[j];
      if (rr) {
        float r[V];
        Vec<T, V>::load(rr + o, r);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += r[j];
      }
      if (sr) Vec<T, V>::store(sr + o, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = snake(v[j], al[j], inv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    Vec<T, V>::store(yr + o, v);
  }
}

// Channels-first: rows [B * C, L] contiguous, row r of channel r % C; V divides L.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) snake_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ bias,
    const float* __restrict__ alpha, T* __restrict__ y, T* __restrict__ s, int rows, int C, int L) {
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int c = r % C;
    const float al = __ldg(alpha + c), inv = 1.0f / (al + ALPHA_EPS), bi = bias ? __ldg(bias + c) : 0.f;
    const long long base = (long long)r * L;
    for (int i = (blockIdx.x * blockDim.x + threadIdx.x) * V; i < L; i += gridDim.x * blockDim.x * V) {
      const long long o = base + i;
      float v[V];
      Vec<T, V>::load(x + o, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += bi;
      if (res) {
        float rv[V];
        Vec<T, V>::load(res + o, rv);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += rv[j];
      }
      if (s) Vec<T, V>::store(s + o, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = snake(v[j], al, inv);
      Vec<T, V>::store(y + o, v);
    }
  }
}

constexpr int RESIDENT_BLOCKS = 132 * 8;  // 8 blocks of 256 threads on each of the 132 SMs

template <typename T, int V>
int launch_frames(const void* x, const void* res, const float* bias, const float* alpha, void* y, void* s,
                  int B, int C, int Tn, int Ty, long long xb, long long rb, long long yb, long long sb,
                  cudaStream_t st) {
  const int CV = C / V;
  if (C % V || CV > 512 || B > 65535) return (int)cudaErrorInvalidValue;
  const int R = CV >= THREADS ? 1 : THREADS / CV;
  const int need = (Ty + R - 1) / R;
  const int per_row = (RESIDENT_BLOCKS * 2 + B - 1) / B;
  const dim3 grid(need < per_row ? need : per_row, B);
  snake_frames_kernel<T, V><<<grid, CV * R, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), bias, alpha, static_cast<T*>(y),
      static_cast<T*>(s), C, Tn, Ty, xb, rb, yb, sb);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_rows(const void* x, const void* res, const float* bias, const float* alpha, void* y, void* s,
                int B, int C, int L, cudaStream_t st) {
  if (L % V) return (int)cudaErrorInvalidValue;
  const int rows = B * C;
  const int need = (L / V + THREADS - 1) / THREADS;
  const int per_row = (RESIDENT_BLOCKS * 2 + rows - 1) / rows;
  const dim3 grid(need < per_row ? need : per_row, rows < 65535 ? rows : 65535);
  snake_rows_kernel<T, V><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), bias, alpha, static_cast<T*>(y),
      static_cast<T*>(s), rows, C, L);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* x, const void* res, const float* bias, const float* alpha, void* y, void* s, int B,
           int C, int Tn, int Ty, long long xb, long long rb, long long yb, long long sb, int channels_last,
           cudaStream_t st) {
  if (channels_last) return launch_frames<T, V>(x, res, bias, alpha, y, s, B, C, Tn, Ty, xb, rb, yb, sb, st);
  if (Ty != Tn) return (int)cudaErrorInvalidValue;
  return launch_rows<T, V>(x, res, bias, alpha, y, s, B, C, Tn, st);
}

}  // namespace

// x (and res) [B, C, T] contiguous, or channels-last [B, C, 1, T] with batch-row
// strides xb, rb (elements); bias [C] f32 or null; alpha [C] f32; y [B, C, Ty]
// (channels-last: row stride yb, frames T..Ty-1 zeroed; channels-first: Ty == T);
// s like x (row stride sb) or null; res null where no residual is added.
// dtype: the tensors' type, 0 f32, 1 bf16, 2 f16. vec: 16-byte vectors (V = 8
// bf16 or f16, 4 f32), else one element a thread.
extern "C" int acad_snake(const void* x, const void* res, const float* bias, const float* alpha, void* y,
                          void* s, int B, int C, int T, int Ty, long long xb, long long rb, long long yb,
                          long long sb, int channels_last, int dtype, int vec, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || Ty < T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return vec ? launch<float, 4>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st)
                 : launch<float, 1>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st);
    case 1:
      return vec ? launch<__nv_bfloat16, 8>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st)
                 : launch<__nv_bfloat16, 1>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st);
    case 2:
      return vec ? launch<__half, 8>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st)
                 : launch<__half, 1>(x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
