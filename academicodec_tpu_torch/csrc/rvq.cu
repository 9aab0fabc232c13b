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
// ~42 MB of traffic (0.013 ms at 3.35 TB/s). To approach the FMA peak the
// inner loop must issue nothing but FMAs and a few shared loads, and the
// codebook stream must cost the SM no instructions.
//
// Design:
//  * a pre-pass (embed_tiles_kernel) copies the codebooks into tile order,
//    [n_q][K / KC][D / DC][DC dims][KC codes], zero-padded, so that every
//    tile is one contiguous 16 KB block; |e|^2 comes from
//    embed_sqnorm_kernel;
//  * one block owns TN = 64 rows; their f32 residual stays in shared memory,
//    dims-major, through all n_q layers (136 KB at D 512). 8000 rows make 125
//    blocks, one per SM;
//  * the [DC = 16 x KC = 256] tiles stream through a 4-stage ring, one TMA
//    bulk copy per tile (cp.async.bulk, completion on a "full" mbarrier)
//    issued by one thread two tiles ahead, in one sequence across all layers
//    (the next layer's first tiles land during this layer's last), so the
//    SM spends no instructions on the copy (per-thread cp.async copies of
//    the same tiles cost every thread address arithmetic and issue slots per
//    tile). Each warp releases a stage on its "empty" mbarrier, so warps
//    drift apart within the ring instead of meeting at a block barrier after
//    every tile;
//  * register tiles: 8 warps as 2 (rows) x 4 (codes), lane (lr, lc); each
//    thread keeps 8 rows x 8 codes of dot products. Per dim it loads its rows
//    and codes as two float4 each (both operands are dims-major), every
//    load a single wavefront, double-buffered in registers: 64 FMAs per 4
//    shared loads;
//  * each thread keeps a running (min, index) per row across the chunks,
//    compared lexicographically, reduced over the row's 8 lanes by shuffles
//    and over the 4 code warps through shared memory: the lowest index wins
//    ties, as jnp.argmin does. Then each warp subtracts its 8 rows' chosen
//    codebook rows, gathered from the row-major codebook with all 8 in
//    flight together, and recomputes |r|^2;
//  * the ragged edges of N, K and D are masked (zero rows, zero-padded
//    tiles), not copied.
// Dot products are sequential f32 FMAs over d: no TF32, no bf16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;        // rows per block
constexpr int KC = 256;       // codes per tile
constexpr int DC = 16;        // dims per tile
constexpr int STAGES = 4;     // ring stages
constexpr int AHEAD = 2;      // tiles in flight ahead of the one being multiplied
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDR = TN + 4;   // row stride of the dims-major residual (floats)
constexpr unsigned TILE_BYTES = DC * KC * sizeof(float);
static_assert(AHEAD <= STAGES - 1, "a stage is refilled only after its last tile was released");

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

// embed [n_q][k][d] -> tiles [n_q][nchunks][ndt][DC][KC], zero past k and d;
// one 32 x 32 block of (codes, dims) per thread block, through shared memory
__global__ void embed_tiles_kernel(const float* __restrict__ e, float* __restrict__ tiles, int k,
                                   int d, int nchunks, int ndt) {
  __shared__ float t[32][33];
  const int q = blockIdx.z, k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const float* eq = e + (size_t)q * k * d;
  for (int y = threadIdx.y; y < 32; y += 8) {
    const int kk = k0 + y, dd = d0 + threadIdx.x;
    t[y][threadIdx.x] = (kk < k && dd < d) ? eq[(size_t)kk * d + dd] : 0.f;
  }
  __syncthreads();
  const int c = k0 / KC;
  for (int y = threadIdx.y; y < 32; y += 8) {
    const int dd = d0 + y;
    if (dd >= ndt * DC) break;
    float* tile = tiles + (((size_t)q * nchunks + c) * ndt + dd / DC) * DC * KC;
    tile[(dd % DC) * KC + k0 % KC + threadIdx.x] = t[threadIdx.x][y];
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one contiguous tile into a ring stage by the TMA unit; the stage's
// mbarrier completes when its bytes have landed
__device__ __forceinline__ void issue_tile(float* stage, uint64_t* mbar, const float* src) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(mbar)),
               "r"(TILE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(stage)),
      "l"(src), "r"(TILE_BYTES), "r"(smem_addr(mbar))
      : "memory");
}

// Wait for the phase of the given parity to complete. A wait of more than
// 2^28 polls traps, so that a fault turns into a launch error, not a hang.
__device__ __forceinline__ void wait_phase(uint64_t* mbar, unsigned parity) {
  unsigned done = 0, polls = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(mbar)), "r"(parity)
        : "memory");
    if (done) return;
    if (++polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void arrive(uint64_t* mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(mbar)) : "memory");
}

// Tile t goes to stage t % STAGES. The producer (thread 0) keeps AHEAD tiles
// in flight and refills a stage once every warp has released its last tile.
__device__ __forceinline__ void produce(int t, int total, float* ring, uint64_t* full,
                                        uint64_t* empty, const float* tiles) {
  if (t >= total) return;
  const int st = t % STAGES;
  if (t >= STAGES) wait_phase(empty + st, (t / STAGES - 1) & 1);
  issue_tile(ring + st * DC * KC, full + st, tiles + (size_t)t * DC * KC);
}

struct Operands {
  float4 r0, r1, e0, e1;  // rows tr4 + 0..3, 32 + tr4 + 0..3; codes tc4 + 0..3, 128 + tc4 + 0..3
};

__device__ __forceinline__ void load_operands(Operands& o, const float* rt, const float* et) {
  o.r0 = *reinterpret_cast<const float4*>(rt);
  o.r1 = *reinterpret_cast<const float4*>(rt + 32);
  o.e0 = *reinterpret_cast<const float4*>(et);
  o.e1 = *reinterpret_cast<const float4*>(et + 128);
}

// acc[r][j] += r . e at one dim: every sum runs in increasing order of d
__device__ __forceinline__ void fma_dim(float acc[8][8], const Operands& o) {
  const float rv[8] = {o.r0.x, o.r0.y, o.r0.z, o.r0.w, o.r1.x, o.r1.y, o.r1.z, o.r1.w};
  const float ev[8] = {o.e0.x, o.e0.y, o.e0.z, o.e0.w, o.e1.x, o.e1.y, o.e1.z, o.e1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(rv[r], ev[j], acc[r][j]);
}

// |r|^2 of rows [8w, 8w + 8) for warp w
__device__ __forceinline__ void row_norms(float* rn, const float* resid, int d) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = w * 8; r < w * 8 + 8; ++r) {
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(resid[c * LDR + r], resid[c * LDR + r], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rn[r] = s;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  const float* __restrict__ tiles, const float* __restrict__ enorm,
                  int* __restrict__ codes, int n, int d, int dp, int n_q, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);    // [STAGES] tile landed
  uint64_t* empty = full + STAGES;                           // [STAGES] tile consumed by all warps
  float* resid = reinterpret_cast<float*>(empty + STAGES);   // [dp][LDR]
  float* ring = resid + dp * LDR;                            // [STAGES][DC][KC]
  float* cand_v = ring + STAGES * DC * KC;                   // [4 code warps][TN]
  int* cand_i = reinterpret_cast<int*>(cand_v + 4 * TN);     // [4][TN]
  float* rn = reinterpret_cast<float*>(cand_i + 4 * TN);     // [TN] |r|^2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3, lr = lane >> 3, lc = lane & 7;
  const int tr4 = (wr * 4 + lr) * 4, tc4 = (wc * 8 + lc) * 4;
  const int row0 = blockIdx.x * TN;
  const int nchunks = (k + KC - 1) / KC, ndt = dp / DC;
  const int per_layer = nchunks * ndt, total = n_q * per_layer;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(empty + s)), "r"(WARPS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < AHEAD; ++t) produce(t, total, ring, full, empty, tiles);
  for (int i = tid; i < TN * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp;
    resid[c * LDR + r] = (row0 + r < n && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();
  row_norms(rn, resid, d);

  float best_v[8], acc[8][8];
  int best_i[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best_v[r] = INFINITY;
    best_i[r] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  // tile i is (layer q, chunk c, dim tile dt), the i-th block of tiles
  for (int i = 0, q = 0, c = 0, dt = 0; i < total; ++i) {
    if (tid == 0) produce(i + AHEAD, total, ring, full, empty, tiles);
    wait_phase(full + i % STAGES, (i / STAGES) & 1);

    const float* et = ring + (i % STAGES) * DC * KC + tc4;
    const float* rt = resid + (size_t)dt * DC * LDR + tr4;
    Operands o[2];
    load_operands(o[0], rt, et);
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) {
      if (dd + 1 < DC) load_operands(o[(dd + 1) & 1], rt + (dd + 1) * LDR, et + (dd + 1) * KC);
      fma_dim(acc, o[dd & 1]);
    }
    __syncwarp();
    if (lane == 0) arrive(empty + i % STAGES);  // this warp is done with the stage

    const int tq = q, tc = c;  // this tile's layer and chunk; advance to the next tile's
    if (++dt == ndt) {
      dt = 0;
      if (++c == nchunks) {
        c = 0;
        ++q;
      }
    }
    if (dt != 0) continue;
    // end of a chunk of codes: fold its distances into the running minima
    const float* en = enorm + (size_t)tq * k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = tc * KC + (j < 4 ? tc4 + j : 128 + tc4 + j - 4);
      if (code < k) {
        const float ec = __ldg(en + code);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float dist = (rn[r < 4 ? tr4 + r : 28 + tr4 + r] - 2.f * acc[r][j]) + ec;
          if (better(dist, code, best_v[r], best_i[r])) {
            best_v[r] = dist;
            best_i[r] = code;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][j] = 0.f;
    }
    if (c != 0) continue;

    // end of a layer: the minimum over the 8 lanes of a row, then over the
    // 4 code warps through shared memory
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = best_v[r];
      int id = best_i[r];
      for (int o2 = 1; o2 < 8; o2 <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o2);
        const int oi = __shfl_xor_sync(0xffffffffu, id, o2);
        if (better(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      const int row = r < 4 ? tr4 + r : 28 + tr4 + r;
      if (lc == 0) {
        cand_v[wc * TN + row] = v;
        cand_i[wc * TN + row] = id;
      }
      best_v[r] = INFINITY;
      best_i[r] = 0;
    }
    __syncthreads();
    // warp w settles rows [8w, 8w + 8): writes the codes, subtracts the
    // chosen rows (the 8 gathers in flight together) and recomputes |r|^2
    const int r0 = warp * 8;
    int ids[8];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      float v = lane < 4 ? cand_v[lane * TN + r0 + rr] : INFINITY;
      int id = lane < 4 ? cand_i[lane * TN + r0 + rr] : 0;
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o2);
        const int oi = __shfl_xor_sync(0xffffffffu, id, o2);
        if (better(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      ids[rr] = __shfl_sync(0xffffffffu, id, 0);
      if (lane == 0 && row0 + r0 + rr < n) codes[(size_t)tq * n + row0 + r0 + rr] = ids[rr];
    }
    if (tq != n_q - 1) {
      const float* eq = embed + (size_t)tq * k * d;
      float sq[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) sq[rr] = 0.f;
      for (int cc = lane; cc < d; cc += 32) {
        float ev[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) ev[rr] = __ldg(eq + (size_t)ids[rr] * d + cc);
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          float* p = resid + cc * LDR + r0 + rr;
          const float nv = *p - ev[rr];
          *p = nv;
          sq[rr] = fmaf(nv, nv, sq[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        float t = sq[rr];
        for (int o2 = 16; o2 > 0; o2 >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o2);
        if (lane == 0) rn[r0 + rr] = t;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int acad_rvq_encode(const float* x, const float* embed, float* tiles, float* enorm,
                               int* codes, int n, int d, int n_q, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n_q * k;
  const int dp = (d + DC - 1) / DC * DC, nchunks = (k + KC - 1) / KC;
  embed_sqnorm_kernel<<<(rows + 7) / 8, 256, 0, s>>>(embed, enorm, rows, d);
  embed_tiles_kernel<<<dim3(nchunks * KC / 32, (dp + 31) / 32, n_q), dim3(32, 8), 0, s>>>(
      embed, tiles, k, d, nchunks, dp / DC);
  const size_t smem = 2 * STAGES * sizeof(uint64_t) + (size_t)(dp * LDR + STAGES * DC * KC + 9 * TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rvq_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rvq_encode_kernel<<<(n + TN - 1) / TN, THREADS, smem, s>>>(x, embed, tiles, enorm, codes, n, d,
                                                             dp, n_q, k);
  return (int)cudaGetLastError();
}

extern "C" const char* acad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
