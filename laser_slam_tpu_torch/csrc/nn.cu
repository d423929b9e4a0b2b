// Exact 1-nearest-neighbour kernels for the ICP correspondence search,
// written for Hopper (sm_90a).  Built with nvcc into a shared library with
// a plain C interface and loaded through ctypes
// (laser_slam_tpu_torch/ops/cuda_build.py); the Python wrappers live in
// laser_slam_tpu_torch/ops/nn_kernels.py beside their plain torch versions.
//
// K1  nn_idx_kernel     replaces laser_slam_tpu/ops/pallas_nn.py
//                       _nn_idx_kernel (wrapper nn_indices).
// K2  nn_pruned_kernel  replaces laser_slam_tpu/ops/pallas_nn.py
//                       _nn_pruned_kernel (wrapper nn_indices_pruned).
//
// What bounds them on this card: an 8-deep f32 distance per (query,
// reference) pair and no matrix product, so the work is FP32 ALU issue
// (3 sub, 3 mul, 2 add, 1 compare, 2 selects per pair), not memory: a
// reference point is read once from device memory per block and then
// broadcast from shared memory to every thread of the block.  wgmma does
// not apply (no product to feed it), and the ||q||^2 - 2 q.r + ||r||^2
// expansion that would is rank-unsafe at 50 m scene scale in f32.
//
// Design: one thread per query, NN_THREADS queries per block.  The block
// stages reference points in NN_CHUNK-point pieces as SoA x/y/z in shared
// memory (24 KB) and every thread scans the piece against its query,
// keeping its best with a strict '<' so the lowest index wins within and
// across tiles, exactly as the Pallas kernels' running (min, argmin).
// Distances use explicit round-to-nearest intrinsics (no FMA contraction)
// in the order (dx*dx + dy*dy) + dz*dz, so they equal the plain torch
// version (neighbors.sqdist) bit for bit.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define NN_THREADS 256
#define NN_CHUNK 2048
#define NN_WARPS (NN_THREADS / 32)

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage reference rows [first, first + n) of an AoS [R,3] array into the
// block's shared SoA buffers.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ ref,
                                            int first, int n, float* sx,
                                            float* sy, float* sz) {
  for (int k = threadIdx.x; k < n; k += NN_THREADS) {
    const float* p = ref + 3 * ((size_t)first + k);
    sx[k] = p[0];
    sy[k] = p[1];
    sz[k] = p[2];
  }
}

// Scan a staged chunk whose first row has global index `base`.
__device__ __forceinline__ void scan_chunk(float qx, float qy, float qz,
                                           const float* sx, const float* sy,
                                           const float* sz, int n, int base,
                                           float& best, int& best_i) {
  for (int k = 0; k < n; ++k) {
    const float d = sq_dist(qx, qy, qz, sx[k], sy[k], sz[k]);
    if (d < best) {
      best = d;
      best_i = base + k;
    }
  }
}

// K1: exact 1-NN of Q queries against all R reference points.
__global__ void __launch_bounds__(NN_THREADS)
nn_idx_kernel(const float* __restrict__ q, const float* __restrict__ ref,
              int Q, int R, float* __restrict__ d2_out,
              int* __restrict__ idx_out) {
  __shared__ float sx[NN_CHUNK], sy[NN_CHUNK], sz[NN_CHUNK];
  const int qi = blockIdx.x * NN_THREADS + threadIdx.x;
  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < R; c0 += NN_CHUNK) {
    const int n = min(NN_CHUNK, R - c0);
    stage_chunk(ref, c0, n, sx, sy, sz);
    __syncthreads();
    if (active) scan_chunk(qx, qy, qz, sx, sy, sz, n, c0, best, best_i);
    __syncthreads();
  }
  if (active) {
    d2_out[qi] = best;
    idx_out[qi] = best_i;
  }
}

// K2: radius-bounded exact 1-NN.  Block b owns the Morton-sorted query
// tile [b*qb, (b+1)*qb) and walks reference tiles (rb points each, of the
// Morton-sorted reference) in its row of `order`, ascending lower bound
// `lb`.  It stops at the first bound >= cutoff2 (the row is sorted) and
// skips a tile whose bound is >= the largest running best in the block,
// the rule of the Pallas kernel (pallas_nn.py:273-274).  The block
// maximum is a warp-shuffle reduction followed by a shared-memory pass;
// every branch on it is uniform across the block.
__global__ void __launch_bounds__(NN_THREADS)
nn_pruned_kernel(const float* __restrict__ q_sorted,
                 const float* __restrict__ ref_sorted,
                 const int* __restrict__ order, const float* __restrict__ lb,
                 int qb, int rb, int nR, float cutoff2,
                 float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float sx[NN_CHUNK], sy[NN_CHUNK], sz[NN_CHUNK];
  __shared__ float s_wmax[NN_WARPS];
  const int t = threadIdx.x;
  const bool active = t < qb;
  const size_t qi = (size_t)blockIdx.x * qb + t;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q_sorted[3 * qi];
    qy = q_sorted[3 * qi + 1];
    qz = q_sorted[3 * qi + 2];
  }
  const int* order_row = order + (size_t)blockIdx.x * nR;
  const float* lb_row = lb + (size_t)blockIdx.x * nR;
  float best = INFINITY;
  int best_i = 0;
  for (int j = 0; j < nR; ++j) {
    const float bound = lb_row[j];
    if (!(bound < cutoff2)) break;
    float m = active ? best : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((t & 31) == 0) s_wmax[t >> 5] = m;
    __syncthreads();
    float block_max = s_wmax[0];
    for (int w = 1; w < NN_WARPS; ++w) block_max = fmaxf(block_max, s_wmax[w]);
    __syncthreads();
    if (!(bound < block_max)) continue;
    const int first = order_row[j] * rb;
    for (int c0 = 0; c0 < rb; c0 += NN_CHUNK) {
      const int n = min(NN_CHUNK, rb - c0);
      stage_chunk(ref_sorted, first + c0, n, sx, sy, sz);
      __syncthreads();
      if (active)
        scan_chunk(qx, qy, qz, sx, sy, sz, n, first + c0, best, best_i);
      __syncthreads();
    }
  }
  if (active) {
    d2_out[qi] = best;
    idx_out[qi] = best_i;
  }
}

extern "C" {

int lsl_nn_indices(const float* q, const float* ref, int Q, int R,
                   float* d2_out, int* idx_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Q + NN_THREADS - 1) / NN_THREADS;
  nn_idx_kernel<<<blocks, NN_THREADS, 0, (cudaStream_t)stream>>>(
      q, ref, Q, R, d2_out, idx_out);
  return (int)cudaGetLastError();
}

int lsl_nn_indices_pruned(const float* q_sorted, const float* ref_sorted,
                          const int* order, const float* lb, int nQ, int qb,
                          int rb, int nR, float cutoff2, float* d2_out,
                          int* idx_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  nn_pruned_kernel<<<nQ, NN_THREADS, 0, (cudaStream_t)stream>>>(
      q_sorted, ref_sorted, order, lb, qb, rb, nR, cutoff2, d2_out, idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
