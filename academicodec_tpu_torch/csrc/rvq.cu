// Residual-VQ encode for Hopper (sm_90a).
//
// Replaces the TPU kernel academicodec_tpu/ops/pallas/rvq.py:_rvq_kernel
// (rvq_encode_fused). For each row of x [N, D] and each of n_q codebooks
// [K, D] in turn: d = |r|^2 - 2 r.e + |e|^2 in f32, take the argmin (lowest
// index on ties), write it, and subtract the chosen codebook row from the
// residual r.
//
// Bound on the H100: operations. 2*N*K*D*n_q f32 FMAs (100.7 GFLOP at
// N 8000, D 512, K 1024, n_q 12: 1.5 ms at the 67 TFLOP/s f32 peak) against
// ~42 MB of traffic (0.013 ms at 3.35 TB/s).
//
// Design:
//  * one block owns TN rows; their f32 residual stays in shared memory
//    through all n_q layers (64 KB at D 512, dynamic shared memory);
//  * the codebook is streamed through shared memory in [KC codes x DC dims]
//    tiles, stored transposed so a warp reads 32 consecutive codes without
//    bank conflicts; each warp owns 4 rows (read by broadcast) and each lane
//    4 codes of every chunk, so one thread keeps a 4x4 tile of dot products;
//  * each thread keeps a running (min, index) per row across the chunks,
//    compared lexicographically, then a warp shuffle reduces the 32 lanes:
//    the lowest index wins ties, as jnp.argmin does;
//  * the chosen row is subtracted by a gather from the codebook (the TPU
//    kernel's one-hot matmul has no reason to exist here);
//  * |e|^2 is computed once per call by embed_sqnorm_kernel;
//  * the ragged edge of N is masked, not padded.
// Dot products are sequential f32 FMAs over d: no TF32, no bf16. Making it
// fast (cp.async/TMA pipelining, wgmma with a 3xTF32 split) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 32;           // rows per block
constexpr int KC = 128;          // codes per chunk (4 per lane)
constexpr int DC = 32;           // dims per codebook tile
constexpr int THREADS = 256;     // 8 warps x 4 rows
constexpr int ETILE_LD = KC + 1; // padded leading dim of the transposed tile

__global__ void embed_sqnorm_kernel(const float* __restrict__ embed,
                                    float* __restrict__ enorm, int rows, int d) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float* e = embed + (size_t)warp * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(e[c], e[c], s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) enorm[warp] = s;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  const float* __restrict__ enorm, int* __restrict__ codes,
                  int n, int d, int dp, int n_q, int k) {
  extern __shared__ __align__(16) float smem[];
  float* resid = smem;                 // [TN][dp]
  float* etile = resid + TN * dp;      // [DC][ETILE_LD]
  float* rnorm = etile + DC * ETILE_LD;  // [TN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TN;
  const int myrow = warp * 4;  // this warp's rows in the tile

  for (int i = tid; i < TN * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp;
    resid[i] = (row0 + r < n && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }

  for (int q = 0; q < n_q; ++q) {
    const float* e = embed + (size_t)q * k * d;
    const float* en = enorm + (size_t)q * k;
    __syncthreads();  // residual rows loaded / updated

    // |r|^2 of this warp's rows (read only by this warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* rr = resid + (myrow + i) * dp;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(rr[c], rr[c], s);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) rnorm[myrow + i] = s;
    }
    __syncwarp();

    float best_v[4];
    int best_i[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best_v[i] = INFINITY;
      best_i[i] = 0;
    }

    for (int k0 = 0; k0 < k; k0 += KC) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int d0 = 0; d0 < dp; d0 += DC) {
        __syncthreads();  // previous tile consumed
        for (int i = tid; i < KC * DC; i += THREADS) {
          const int code = i / DC, dd = i - code * DC;
          const int gk = k0 + code, gd = d0 + dd;
          etile[dd * ETILE_LD + code] =
              (gk < k && gd < d) ? e[(size_t)gk * d + gd] : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int dd = 0; dd < DC; dd += 4) {
          float4 rv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rv[i] = *reinterpret_cast<const float4*>(resid + (myrow + i) * dp + d0 + dd);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float ev[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) ev[j] = etile[(dd + u) * ETILE_LD + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float r = u == 0 ? rv[i].x : u == 1 ? rv[i].y : u == 2 ? rv[i].z : rv[i].w;
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(r, ev[j], acc[i][j]);
            }
          }
        }
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = k0 + lane + 32 * j;
        if (code < k) {
          const float ec = en[code];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dist = (rnorm[myrow + i] - 2.f * acc[i][j]) + ec;
            if (better(dist, code, best_v[i], best_i[i])) {
              best_v[i] = dist;
              best_i[i] = code;
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = best_v[i];
      int id = best_i[i];
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, id, o);
        if (better(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      const int gr = row0 + myrow + i;
      if (lane == 0 && gr < n) codes[(size_t)q * n + gr] = id;
      const float* er = e + (size_t)id * d;
      float* rr = resid + (myrow + i) * dp;
      for (int c = lane; c < d; c += 32) rr[c] -= er[c];
    }
  }
}

}  // namespace

extern "C" int acad_rvq_encode(const float* x, const float* embed, float* enorm,
                               int* codes, int n, int d, int n_q, int k,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n_q * k;
  embed_sqnorm_kernel<<<(rows + 7) / 8, 256, 0, s>>>(embed, enorm, rows, d);
  const int dp = (d + DC - 1) / DC * DC;
  const size_t smem = (size_t)(TN * dp + DC * ETILE_LD + TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rvq_encode_kernel<<<(n + TN - 1) / TN, THREADS, smem, s>>>(
      x, embed, enorm, codes, n, d, dp, n_q, k);
  return (int)cudaGetLastError();
}

extern "C" const char* acad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
