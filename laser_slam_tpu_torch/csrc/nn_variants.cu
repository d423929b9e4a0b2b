// The exact-NN shootout's experiment kernels, written for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes (laser_slam_tpu_torch/ops/cuda_build.py); the
// Python wrappers live in laser_slam_tpu_torch/ops/nn_variants.py beside
// their plain torch versions.
//
// mm_indices_kernel      replaces E5 experiments/pallas_payload_variants.py
//                        _nn_idx_kernel and E1 experiments/
//                        pallas_nn_variants.py kern (HIGHEST precision).
// mm_indices_bf16_kernel replaces E1 kern at DEFAULT precision (one bf16
//                        pass of the MXU).
// mm_payload_kernel      replaces E4 pallas_payload_variants.py _nn_kernel.
// mm_pruned_kernel       replaces E6 pallas_payload_variants.py
//                        _pruned_kernel.
// nn_tiled_kernel<QPT>   replaces E2 pallas_nn_variants.py vpu_kernel and
//                        E3 pallas_tile_sweep.py nn_tiled (K1's function at
//                        a chosen tile shape).
//
// The matmul form.  Query row (x, y, z, 1) times reference row (-2x, -2y,
// -2z, |r|^2) is |q-r|^2 - |q|^2, the "score"; the wrapper adds |q|^2 back.
// The reference rows are built by the wrapper (float4 each) and staged in
// shared memory a tile at a time; each thread owns one query and keeps its
// running best in registers.  All index kernels take a strict '<' in
// ascending reference order, which yields the lowest index of the minimum:
// the Pallas rule (lowest column within a tile, strict '<' across tiles)
// gives the same index for any tile width.
//
// What bounds them on this card: no device-memory traffic to speak of (a
// query is read once, a reference row once per block, from L2), so the
// work is instruction issue on the CUDA cores:
//   * highest: 3 f32 FMAs, a compare and 2 selects per pair.  The tensor
//     cores take no f32 operands and TF32 keeps bf16's rank problem, so
//     the product stays on the FMA pipes.
//   * bf16: the product runs on the tensor cores (mma.sync m16n8k16, K
//     padded 4 -> 16 with zeros, f32 accumulate), so what is left on the
//     CUDA cores is the argmin pass: a compare and 2 selects per pair.
//   * payload (E4, E6): the highest scores plus the tie bookkeeping of a
//     tile (a compare for '<', one for '=='); the Pallas one-hot payload
//     matmul (16x the scoring work on the TPU) becomes a gather of the
//     winning row from L2 when a finished tile improves the best.
//   * tiled exact (E2/E3): K1's 11 instructions per pair
//     (csrc/nn.cu), at a chosen (queries per block, reference points per
//     shared-memory tile).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define MM_THREADS 128
#define MM_CHUNK 2048          // reference rows staged per pass (32 KB)
#define MAX_PAYLOAD 8
#define TILED_THREADS 256

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mm_score(float qx, float qy, float qz,
                                          float4 r) {
  return fmaf(qz, r.z, fmaf(qy, r.y, fmaf(qx, r.x, r.w)));
}

__device__ __forceinline__ void stage_rows(const float4* __restrict__ r_ext,
                                           int first, int n, float4* s_r) {
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    s_r[k] = r_ext[(size_t)first + k];
}

__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           size_t qi, bool active, float& qx,
                                           float& qy, float& qz) {
  qx = qy = qz = 0.f;
  if (active) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
}

// ---------------------------------------------------------------------------
// E5 / E1 highest: matmul-form index 1-NN in f32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MM_THREADS)
mm_indices_kernel(const float* __restrict__ q,
                  const float4* __restrict__ r_ext, int Q, int R,
                  float* __restrict__ score_out, int* __restrict__ idx_out) {
  __shared__ float4 s_r[MM_CHUNK];
  const size_t qi = (size_t)blockIdx.x * MM_THREADS + threadIdx.x;
  const bool active = qi < (size_t)Q;
  float qx, qy, qz;
  load_query(q, qi, active, qx, qy, qz);
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < R; c0 += MM_CHUNK) {
    const int n = min(MM_CHUNK, R - c0);
    stage_rows(r_ext, c0, n, s_r);
    __syncthreads();
    if (active) {
      for (int k = 0; k < n; ++k) {
        const float s = mm_score(qx, qy, qz, s_r[k]);
        if (s < best) {
          best = s;
          best_i = c0 + k;
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    score_out[qi] = best;
    idx_out[qi] = best_i;
  }
}

// ---------------------------------------------------------------------------
// E1 bf16: one bf16 pass on the tensor cores, f32 accumulate
// ---------------------------------------------------------------------------
//
// A warp owns 16 queries (the M of mma.m16n8k16) and walks the reference
// 8 rows (N) at a time.  K holds (x, y, z, 1) against (-2x, -2y, -2z,
// |r|^2) in its first four slots and zeros in the other twelve, so only the
// lanes with threadID_in_group 0 and 1 carry non-zero A and B fragments.
// Lane (g = lane/4, t = lane%4) receives the scores of query rows g and
// g+8 against reference columns 2t and 2t+1; it keeps a running best for
// both rows, and the four lanes of a group merge theirs at the end (least
// score, then least index).  Reference rows past R are staged with an
// infinite |r|^2, so their scores never win.

#define BF16_WARPS 4
#define BF16_QUERIES (16 * BF16_WARPS)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t b0) {
  // a2 = a3 = b1 = 0: K slots 8..15 are the zero padding.
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u), "f"(0.f),
        "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void take_min(float s, int i, float& best,
                                         int& best_i) {
  if (s < best) {
    best = s;
    best_i = i;
  }
}

__device__ __forceinline__ void merge_group(float& best, int& best_i) {
  for (int off = 1; off < 4; off <<= 1) {
    const float s = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (s < best || (s == best && i < best_i)) {
      best = s;
      best_i = i;
    }
  }
}

__global__ void __launch_bounds__(32 * BF16_WARPS)
mm_indices_bf16_kernel(const float* __restrict__ q,
                       const float4* __restrict__ r_ext, int Q, int R,
                       float* __restrict__ score_out,
                       int* __restrict__ idx_out) {
  __shared__ uint2 s_b[MM_CHUNK];   // per reference row: K slots 0-1, 2-3
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 =
      (size_t)blockIdx.x * BF16_QUERIES + (threadIdx.x >> 5) * 16 + g;
  const size_t row1 = row0 + 8;
  uint32_t a0 = 0u, a1 = 0u;
  if (t < 2) {
    // t = 0: K slots (0, 1) = (x, y); t = 1: slots (2, 3) = (z, 1).
    if (row0 < (size_t)Q)
      a0 = t == 0 ? pack_bf16(q[3 * row0], q[3 * row0 + 1])
                  : pack_bf16(q[3 * row0 + 2], 1.f);
    if (row1 < (size_t)Q)
      a1 = t == 0 ? pack_bf16(q[3 * row1], q[3 * row1 + 1])
                  : pack_bf16(q[3 * row1 + 2], 1.f);
  }
  float best0 = INFINITY, best1 = INFINITY;
  int idx0 = 0, idx1 = 0;
  for (int c0 = 0; c0 < R; c0 += MM_CHUNK) {
    const int n = min(MM_CHUNK, R - c0);
    const int n8 = (n + 7) & ~7;
    for (int k = threadIdx.x; k < n8; k += blockDim.x) {
      float4 r = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (k < n) r = r_ext[(size_t)c0 + k];
      s_b[k] = make_uint2(pack_bf16(r.x, r.y), pack_bf16(r.z, r.w));
    }
    __syncthreads();
    for (int k8 = 0; k8 < n8; k8 += 8) {
      uint32_t b0 = 0u;
      if (t < 2) {
        const uint2 w = s_b[k8 + g];
        b0 = t == 0 ? w.x : w.y;
      }
      float d[4];
      mma_bf16_16816(d, a0, a1, b0);
      const int col = c0 + k8 + 2 * t;
      take_min(d[0], col, best0, idx0);
      take_min(d[1], col + 1, best0, idx0);
      take_min(d[2], col, best1, idx1);
      take_min(d[3], col + 1, best1, idx1);
    }
    __syncthreads();
  }
  merge_group(best0, idx0);
  merge_group(best1, idx1);
  if (t == 0) {
    if (row0 < (size_t)Q) {
      score_out[row0] = best0;
      idx_out[row0] = idx0;
    }
    if (row1 < (size_t)Q) {
      score_out[row1] = best1;
      idx_out[row1] = idx1;
    }
  }
}

// ---------------------------------------------------------------------------
// E4 / E6: payload of the winning tile, tied rows averaged
// ---------------------------------------------------------------------------

// Per query and reference tile: the least score, the first staged row
// that attains it and how many rows do.  The payload rows are read only
// when a finished tile improves the running best (a few times a query),
// not at every improvement inside a tile, where the lanes of a warp would
// diverge on dependent loads from L2.
struct TileBest {
  float min;
  int arg;
  int count;
};

__device__ __forceinline__ void tile_scan(float qx, float qy, float qz,
                                          const float4* s_r, int k0, int n,
                                          TileBest& tb) {
  tb.min = INFINITY;
  tb.arg = k0;
  tb.count = 0;
  for (int k = k0; k < k0 + n; ++k) {
    const float s = mm_score(qx, qy, qz, s_r[k]);
    if (s <= tb.min) {         // one rarely taken branch per pair
      const bool lower = s < tb.min;
      tb.count = lower ? 1 : tb.count + 1;
      tb.arg = lower ? k : tb.arg;
      tb.min = s;
    }
  }
}

// Fold the tile of staged rows [k0, k0 + n) (global row = base + k) into
// the running best with a strict '<'.  A tile that wins with tied rows
// scores them again (the same FMAs, so the same bits) and averages their
// payload rows, as the Pallas one-hot / count does.
__device__ __forceinline__ void tile_fold(float qx, float qy, float qz,
                                          const float4* s_r, int k0, int n,
                                          size_t base,
                                          const float* __restrict__ pay,
                                          int P, const TileBest& tb,
                                          float& best,
                                          float (&best_pay)[MAX_PAYLOAD]) {
  if (!(tb.min < best)) return;
  best = tb.min;
  if (tb.count == 1) {
    const float* row = pay + (base + tb.arg) * (size_t)P;
#pragma unroll
    for (int p = 0; p < MAX_PAYLOAD; ++p) best_pay[p] = p < P ? row[p] : 0.f;
    return;
  }
  float sum[MAX_PAYLOAD];
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) sum[p] = 0.f;
  for (int k = tb.arg; k < k0 + n; ++k) {
    if (mm_score(qx, qy, qz, s_r[k]) == tb.min) {
      const float* row = pay + (base + k) * (size_t)P;
#pragma unroll
      for (int p = 0; p < MAX_PAYLOAD; ++p)
        if (p < P) sum[p] += row[p];
    }
  }
  const float c = (float)tb.count;
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) best_pay[p] = __fdiv_rn(sum[p], c);
}

__device__ __forceinline__ void store_payload(float* __restrict__ out,
                                              size_t qi, int P,
                                              const float (&v)[MAX_PAYLOAD]) {
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p)
    if (p < P) out[qi * P + p] = v[p];
}

// E4: each block owns MM_THREADS queries and walks all reference tiles of
// rb rows in order.  A pass stages as many whole tiles as fit MM_CHUNK.
__global__ void __launch_bounds__(MM_THREADS)
mm_payload_kernel(const float* __restrict__ q,
                  const float4* __restrict__ r_ext,
                  const float* __restrict__ pay, int Q, int R, int P, int rb,
                  float* __restrict__ score_out, float* __restrict__ pay_out) {
  __shared__ float4 s_r[MM_CHUNK];
  const size_t qi = (size_t)blockIdx.x * MM_THREADS + threadIdx.x;
  const bool active = qi < (size_t)Q;
  float qx, qy, qz;
  load_query(q, qi, active, qx, qy, qz);
  float best = INFINITY;
  float best_pay[MAX_PAYLOAD];
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) best_pay[p] = 0.f;
  TileBest tb;
  const int pass = (MM_CHUNK / rb) * rb;
  for (int c0 = 0; c0 < R; c0 += pass) {
    const int n = min(pass, R - c0);
    stage_rows(r_ext, c0, n, s_r);
    __syncthreads();
    if (active) {
      for (int k0 = 0; k0 < n; k0 += rb) {
        tile_scan(qx, qy, qz, s_r, k0, rb, tb);
        tile_fold(qx, qy, qz, s_r, k0, rb, c0, pay, P, tb, best, best_pay);
      }
    }
    __syncthreads();
  }
  if (active) {
    score_out[qi] = best;
    store_payload(pay_out, qi, P, best_pay);
  }
}

// E6: block i owns the Morton-sorted query tile [i*qb, (i+1)*qb) and visits
// the nj reference tiles (rb rows each, Morton-sorted) starting at its
// diagonal tile (j + i*nj/ni) % nj.  Before each tile it computes the
// squared gap between the two tiles' boxes, summed (gx^2 + gy^2) + gz^2,
// and skips the tile unless that bound is below the block's largest
// (best score + |q|^2), which starts at +inf and is refreshed after every
// visited tile (pallas_payload_variants.py:341-362).  Every branch on it
// is uniform across the block.  visits[i] counts the tiles visited.
__global__ void __launch_bounds__(TILED_THREADS)
mm_pruned_kernel(const float* __restrict__ q_sorted,
                 const float* __restrict__ q_norm2,
                 const float4* __restrict__ r_ext,
                 const float* __restrict__ pay,
                 const float* __restrict__ q_boxes,
                 const float* __restrict__ r_boxes, int P, int qb, int rb,
                 int ni, int nj, float* __restrict__ score_out,
                 float* __restrict__ pay_out, int* __restrict__ visits) {
  __shared__ float4 s_r[MM_CHUNK];
  __shared__ float s_wmax[TILED_THREADS / 32];
  const int t = threadIdx.x;
  const int i = blockIdx.x;
  const bool active = t < qb;
  const size_t qi = (size_t)i * qb + t;
  float qx, qy, qz;
  load_query(q_sorted, qi, active, qx, qy, qz);
  const float qn2 = active ? q_norm2[qi] : 0.f;
  const float* qbox = q_boxes + 6 * (size_t)i;
  float best = INFINITY;
  float best_pay[MAX_PAYLOAD];
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) best_pay[p] = 0.f;
  float best_max = INFINITY;
  int visited = 0;
  const int start = (int)(((long long)i * nj) / (ni > 0 ? ni : 1));
  TileBest tb;
  for (int j = 0; j < nj; ++j) {
    const int tile = (j + start) % nj;
    const float* rbox = r_boxes + 6 * (size_t)tile;
    float g[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      g[d] = fmaxf(fmaxf(__fsub_rn(qbox[d], rbox[3 + d]),
                         __fsub_rn(rbox[d], qbox[3 + d])), 0.f);
    const float lb = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]),
                                         __fmul_rn(g[1], g[1])),
                               __fmul_rn(g[2], g[2]));
    if (!(lb < best_max)) continue;
    ++visited;
    const size_t first = (size_t)tile * rb;
    stage_rows(r_ext, (int)first, rb, s_r);
    __syncthreads();
    if (active) {
      tile_scan(qx, qy, qz, s_r, 0, rb, tb);
      tile_fold(qx, qy, qz, s_r, 0, rb, first, pay, P, tb, best, best_pay);
    }
    float m = active ? __fadd_rn(best, qn2) : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((t & 31) == 0) s_wmax[t >> 5] = m;
    __syncthreads();
    best_max = s_wmax[0];
    for (int w = 1; w < TILED_THREADS / 32; ++w)
      best_max = fmaxf(best_max, s_wmax[w]);
    __syncthreads();
  }
  if (active) {
    score_out[qi] = best;
    store_payload(pay_out, qi, P, best_pay);
  }
  if (t == 0) visits[i] = visited;
}

// ---------------------------------------------------------------------------
// E2 / E3: K1's exact 1-NN at a chosen tile shape
// ---------------------------------------------------------------------------
//
// A block owns qb = blockDim.x * QPT queries (thread t holds queries
// t + j*blockDim.x, j < QPT) and stages the reference rb points at a time
// (dynamic shared memory, SoA, 12*rb bytes).  Distances round exactly as
// K1's (csrc/nn.cu sq_dist), so the result equals K1's bit for bit.

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int QPT>
__global__ void __launch_bounds__(TILED_THREADS)
nn_tiled_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                int Q, int R, int rb, float* __restrict__ d2_out,
                int* __restrict__ idx_out) {
  extern __shared__ float s_xyz[];
  float* sx = s_xyz;
  float* sy = s_xyz + rb;
  float* sz = s_xyz + 2 * rb;
  const size_t q0 = (size_t)blockIdx.x * blockDim.x * QPT + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int best_i[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const size_t qi = q0 + (size_t)j * blockDim.x;
    load_query(q, qi, qi < (size_t)Q, qx[j], qy[j], qz[j]);
    best[j] = INFINITY;
    best_i[j] = 0;
  }
  for (int c0 = 0; c0 < R; c0 += rb) {
    const int n = min(rb, R - c0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float* p = ref + 3 * ((size_t)c0 + k);
      sx[k] = p[0];
      sy[k] = p[1];
      sz[k] = p[2];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float rx = sx[k], ry = sy[k], rz = sz[k];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float d = sq_dist(qx[j], qy[j], qz[j], rx, ry, rz);
        if (d < best[j]) {
          best[j] = d;
          best_i[j] = c0 + k;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const size_t qi = q0 + (size_t)j * blockDim.x;
    if (qi < (size_t)Q) {
      d2_out[qi] = best[j];
      idx_out[qi] = best_i[j];
    }
  }
}

template <int QPT>
static int launch_tiled(const float* q, const float* ref, int Q, int R,
                        int threads, int rb, float* d2_out, int* idx_out,
                        cudaStream_t stream) {
  const size_t smem = 12 * (size_t)rb;
  cudaError_t err = cudaFuncSetAttribute(
      nn_tiled_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qb = threads * QPT;
  const int blocks = (Q + qb - 1) / qb;
  nn_tiled_kernel<QPT><<<blocks, threads, smem, stream>>>(q, ref, Q, R, rb,
                                                           d2_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" {

int lsl_mm_indices(const float* q, const float* r_ext, int Q, int R,
                   int bf16, float* score_out, int* idx_out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float4* r4 = (const float4*)r_ext;
  if (bf16) {
    const int blocks = (Q + BF16_QUERIES - 1) / BF16_QUERIES;
    mm_indices_bf16_kernel<<<blocks, 32 * BF16_WARPS, 0,
                             (cudaStream_t)stream>>>(q, r4, Q, R, score_out,
                                                     idx_out);
  } else {
    const int blocks = (Q + MM_THREADS - 1) / MM_THREADS;
    mm_indices_kernel<<<blocks, MM_THREADS, 0, (cudaStream_t)stream>>>(
        q, r4, Q, R, score_out, idx_out);
  }
  return (int)cudaGetLastError();
}

int lsl_mm_payload(const float* q, const float* r_ext, const float* pay,
                   int Q, int R, int P, int rb, float* score_out,
                   float* pay_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 1 || P > MAX_PAYLOAD || rb < 1 || rb > MM_CHUNK || R % rb)
    return (int)cudaErrorInvalidValue;
  const int blocks = (Q + MM_THREADS - 1) / MM_THREADS;
  mm_payload_kernel<<<blocks, MM_THREADS, 0, (cudaStream_t)stream>>>(
      q, (const float4*)r_ext, pay, Q, R, P, rb, score_out, pay_out);
  return (int)cudaGetLastError();
}

int lsl_mm_payload_pruned(const float* q_sorted, const float* q_norm2,
                          const float* r_ext, const float* pay,
                          const float* q_boxes, const float* r_boxes, int Q,
                          int R, int P, int qb, int rb, int ni, int nj,
                          float* score_out, float* pay_out, int* visits,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 1 || P > MAX_PAYLOAD || qb < 1 || qb > TILED_THREADS ||
      rb < 1 || rb > MM_CHUNK || ni * qb != Q || nj * rb != R)
    return (int)cudaErrorInvalidValue;
  mm_pruned_kernel<<<ni, TILED_THREADS, 0, (cudaStream_t)stream>>>(
      q_sorted, q_norm2, (const float4*)r_ext, pay, q_boxes, r_boxes, P, qb,
      rb, ni, nj, score_out, pay_out, visits);
  return (int)cudaGetLastError();
}

int lsl_nn_tiled(const float* q, const float* ref, int Q, int R, int qb,
                 int rb, float* d2_out, int* idx_out, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (qb >= 1 && qb <= TILED_THREADS)
    return launch_tiled<1>(q, ref, Q, R, qb, rb, d2_out, idx_out, s);
  switch (qb / TILED_THREADS * (qb % TILED_THREADS == 0)) {
    case 1: return launch_tiled<1>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    case 2: return launch_tiled<2>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    case 4: return launch_tiled<4>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    case 8: return launch_tiled<8>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    case 16:
      return launch_tiled<16>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    case 32:
      return launch_tiled<32>(q, ref, Q, R, 256, rb, d2_out, idx_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
