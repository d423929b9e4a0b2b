// Pieces shared by the exact-NN kernels of csrc/nn.cu (K1, K2) and
// csrc/nn_variants.cu (E2/E3's item kernel, E6): coordinate-wise squared
// distances rounded as the plain torch version, the 64-bit merge keys,
// the spread of a Morton coordinate, cp.async staging into 16-byte
// shared rows, the scan of a staged span, the publish of a thread's
// bests, a block maximum and the unpack of the merged keys.
// ops/cuda_build.py hashes this header into the library name of every
// source, so an edit rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

typedef unsigned long long u64;

#define NN_QPT 4                      // queries a thread
#define NN_SPAN 128                   // points a group scans of a chunk
#define NN_STAGES 3                   // chunks staged ahead of the scan + 1
#define NN_UNPACK_THREADS 256
// Key of (d2 = +inf, idx = 0), the state before any point is scanned.
// K2's item counter, stored after the keys, counts up from it too.
#define NN_INIT_KEY 0x7f80000000000000ULL

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The low 10 bits of x spread to every third bit: one coordinate of a
// 30-bit Morton code (K2's set-up, E6's).
__device__ __forceinline__ unsigned spread_bits10(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x30000FFu;
  x = (x | (x << 8)) & 0x300F00Fu;
  x = (x | (x << 4)) & 0x30C30C3u;
  x = (x | (x << 2)) & 0x9249249u;
  return x;
}

__device__ __forceinline__ u64 pack_key(float d2, int idx) {
  return ((u64)__float_as_uint(d2) << 32) | (unsigned)idx;
}

__device__ __forceinline__ float key_d2(u64 key) {
  return __uint_as_float((unsigned)(key >> 32));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying reference rows [first, first + n) of an AoS [R,3] array
// into 16-byte shared rows.
template <int NT>
__device__ __forceinline__ void stage_chunk(float4* dst,
                                            const float* __restrict__ ref,
                                            size_t first, int n) {
  for (int k = threadIdx.x; k < n; k += NT) {
    const float* p = ref + 3 * (first + k);
    float* d = reinterpret_cast<float*>(dst + k);
    cp_async4(d, p);
    cp_async4(d + 1, p + 1);
    cp_async4(d + 2, p + 2);
  }
}

// Scan n staged points (global index base + k) against a thread's
// queries; a strict '<' keeps the lowest index of a tie.
__device__ __forceinline__ void scan_span(const float4* s, int n, int base,
                                          const float (&qx)[NN_QPT],
                                          const float (&qy)[NN_QPT],
                                          const float (&qz)[NN_QPT],
                                          float (&best)[NN_QPT],
                                          int (&best_i)[NN_QPT]) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 r = s[k];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const float d = sq_dist(qx[u], qy[u], qz[u], r.x, r.y, r.z);
      if (d < best[u]) {
        best[u] = d;
        best_i[u] = base + k;
      }
    }
  }
}

// Merge a thread's bests that improved since it last published.
__device__ __forceinline__ void publish(u64* keys, const int (&qi)[NN_QPT],
                                        int Q, const float (&best)[NN_QPT],
                                        const int (&best_i)[NN_QPT],
                                        float (&published)[NN_QPT]) {
#pragma unroll
  for (int u = 0; u < NN_QPT; ++u) {
    if (qi[u] < Q && best[u] < published[u]) {
      atomicMin(keys + qi[u], pack_key(best[u], best_i[u]));
      published[u] = best[u];
    }
  }
}

// Largest value of v over the block (every thread gets it).  The caller
// keeps s_warp untouched until every thread has read it.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* s_warp) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_warp[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, s_warp[w]);
  return m;
}

// keys[s] -> (d2, idx) at row perm[s] (K2's unsort) or row s.
__global__ void __launch_bounds__(NN_UNPACK_THREADS)
nn_unpack_kernel(const u64* __restrict__ keys, int Q,
                 const long long* __restrict__ perm,
                 float* __restrict__ d2_out, int* __restrict__ idx_out) {
  const int s = blockIdx.x * NN_UNPACK_THREADS + threadIdx.x;
  if (s >= Q) return;
  const u64 key = keys[s];
  const long long row = perm != nullptr ? perm[s] : s;
  d2_out[row] = key_d2(key);
  idx_out[row] = (int)(unsigned)(key & 0xffffffffULL);
}

static cudaError_t launch_unpack(const u64* keys, int Q,
                                 const long long* perm, float* d2_out,
                                 int* idx_out, cudaStream_t stream) {
  const int blocks = (Q + NN_UNPACK_THREADS - 1) / NN_UNPACK_THREADS;
  nn_unpack_kernel<<<blocks, NN_UNPACK_THREADS, 0, stream>>>(
      keys, Q, perm, d2_out, idx_out);
  return cudaGetLastError();
}
