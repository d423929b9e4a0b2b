// Exact 1-nearest-neighbour kernels for the ICP correspondence search,
// written for Hopper (sm_90a).  Built with nvcc into a shared library with
// a plain C interface and loaded through ctypes
// (laser_slam_tpu_torch/ops/cuda_build.py); the Python wrappers live in
// laser_slam_tpu_torch/ops/nn_kernels.py beside their plain torch versions.
//
// K1  nn_items_kernel<false>  replaces laser_slam_tpu/ops/pallas_nn.py
//                             _nn_idx_kernel (wrapper nn_indices).
// K2  nn_items_kernel<true>   replaces laser_slam_tpu/ops/pallas_nn.py
//                             _nn_pruned_kernel (wrapper
//                             nn_indices_pruned).
// nn_unpack_kernel writes both kernels' (d2, idx) from the merged keys,
// in the original query order for K2.
//
// What bounds them: f32 instruction issue.  Each (query, reference) pair
// costs 3 sub, 3 mul, 2 add, a compare and 2 selects, and there is no
// matrix product: the tensor cores (wgmma, mma.sync) take no f32
// operands, and the ||q||^2 - 2 q.r + ||r||^2 expansion that would feed
// them loses 1.1e-3 m^2 even in f32 and 17.7 m^2 in bf16 at 50 m scene
// scale (the shootout, csrc/nn_variants.cu), so the coordinate-wise form
// stays.  Memory is no limit: the whole reference (0.98 MB at 81920
// points) stays in the 50 MB L2, and a staged point serves 256 queries.
//
// Design.  The Pallas kernels walk reference tiles in sequence, one query
// tile per grid row, with a scratch (min, argmin).  Here the reference
// dimension is parallel too:
//   * Work item = (query tile of <= 256 queries, reference tile).  K1:
//     4096-point tiles, the last one ragged.  K2: the tile of rank j in
//     the query tile's row of `order` (ascending AABB bound `lb`).
//     Items are numbered rank-major (item = j * nQt + i), so every query
//     tile's nearest reference tile comes before anyone's second-nearest.
//     Blocks take items from a counter, so items start in that order.
//   * Exact merge across blocks: a query's result is one 64-bit key,
//     (f32 bits of d2) << 32 | idx.  d2 >= +0, so its bits order like the
//     float, and atomicMin gives the least d2 with ties to the lowest
//     index, whatever order the blocks run in: K1's tie rule, and
//     deterministic.  The wrapper fills the keys with (+inf, 0) on the
//     caller's stream before the launch; nn_unpack_kernel splits them.
//   * K2 reads the merged bests before it scans an item: it skips the
//     item when lb >= cutoff^2 (the Pallas rule) or when lb >= the
//     largest merged d2 over the tile's queries (one L2 load a query and
//     a block maximum).  A merged best is a real distance, never below
//     the final one, so every point of a skipped tile is at least as far
//     as the query's final best: the skip is as safe as the Pallas rule
//     (pallas_nn.py:273-274), and it also prunes with the bests of the
//     tile's other blocks.  K2 publishes its bests after every staged
//     chunk so that later items see them soon.  Which tiles K2 scans
//     depends on block timing; its results do not (d2 exact within the
//     cutoff, > cutoff^2 beyond it).
//   * 4 queries a thread: 64 threads hold a query tile, and a block has
//     GROUPS such groups, each scanning its own 128-point span of every
//     staged chunk.  A reference point is one LDS.128 for 4 pairs (the
//     old one-query-a-thread kernel paid 3 scalar loads a pair), and the
//     4 running (best, idx) chains give the scheduler independent work.
//   * Asynchronous staging: a ring of 3 chunks in shared memory, rows of
//     16 bytes (x, y, z, pad), filled with cp.async (4-byte copies: the
//     [R,3] rows are 12 bytes and need no alignment beyond 4) two chunks
//     ahead of the scan, one barrier a chunk.
//   * Grids on 132 SMs.  K1: 2 groups (128 threads), one block an item;
//     at 8192 x 81920 that is 32 x 20 = 640 items, 4.85 per SM, all
//     resident at once (12 KB of shared memory and <= 64 registers a
//     thread allow 8 a SM), so the card splits them evenly.  K2: 8 groups
//     (512 threads, 48 KB), a persistent grid of 2 blocks a SM taking
//     items from the counter: 264 items in flight (ranks 0-8 of 32 query
//     tiles), so later ranks start after nearer ones have published.
//     The persistent grid sets how many items are in flight here, where
//     a plain grid of one block an item would leave it to the occupancy
//     that the register count allows: the more items start together,
//     the fewer bests are known when they test their bounds.
//   * Distances use explicit round-to-nearest intrinsics (no FMA
//     contraction) in the order (dx*dx + dy*dy) + dz*dz, so they equal
//     the plain torch version (neighbors.sqdist) bit for bit.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

typedef unsigned long long u64;

#define NN_QPT 4                      // queries a thread
#define NN_GROUP 64                   // threads that hold one query tile
#define NN_QT (NN_QPT * NN_GROUP)     // 256: the largest query tile
#define NN_SPAN 128                   // points a group scans of a chunk
#define NN_STAGES 3                   // chunks in the shared-memory ring
#define NN_K1_RT 4096                 // K1's reference tile
#define NN_K1_GROUPS 2
#define NN_K2_GROUPS 8
#define NN_K2_BLOCKS_PER_SM 2
#define NN_UNPACK_THREADS 256
// Key of (d2 = +inf, idx = 0), the state before any point is scanned.
// The item counter, stored after the keys, counts up from it too.
#define NN_INIT_KEY 0x7f80000000000000ULL

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
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

// One kernel for K1 (PRUNED = false) and K2 (PRUNED = true).  Query tile
// i holds queries [i*qt, min((i+1)*qt, Q)) of q (K2: Morton-sorted).  K1
// item (i, j) scans reference rows [j*rt, min((j+1)*rt, R)); K2 item
// (i, j) scans tile order[i][j] (rows order*rt .. +rt of the sorted
// reference) unless its bound lb[i][j] lets it skip.  keys[Q] is the
// item counter; scanned[i] (K2, optional) counts the reference points
// scanned for query tile i.
template <bool PRUNED, int GROUPS>
__global__ void __launch_bounds__(GROUPS * NN_GROUP,
                                  1024 / (GROUPS * NN_GROUP))
nn_items_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                int Q, int R, int qt, int rt, int nQt, int n_items,
                const int* __restrict__ order, const float* __restrict__ lb,
                int nR, float cutoff2, u64* keys,
                int* __restrict__ scanned) {
  constexpr int NT = GROUPS * NN_GROUP;
  constexpr int CHUNK = GROUPS * NN_SPAN;
  extern __shared__ float4 ring[];       // NN_STAGES x CHUNK rows
  __shared__ int s_item;
  __shared__ float s_warp[NT / 32];
  const int t = threadIdx.x;
  const int group = t / NN_GROUP;
  const int lane = t % NN_GROUP;
  u64* next_item = keys + Q;

  for (;;) {
    __syncthreads();                     // the last item's shared state is free
    if (t == 0) {
      const u64 taken = atomicAdd(next_item, 1ULL) - NN_INIT_KEY;
      s_item = taken < (u64)n_items ? (int)taken : n_items;
    }
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) return;
    const int i = item % nQt;            // query tile
    const int j = item / nQt;            // rank (K2) or reference tile (K1)

    int first, n;
    if (PRUNED) {
      const float bound = lb[(size_t)i * nR + j];
      if (!(bound < cutoff2)) continue;
      float m = -INFINITY;
      for (int s = t; s < qt; s += NT)
        m = fmaxf(m, key_d2(__ldcg(keys + (size_t)i * qt + s)));
      m = block_max<NT>(m, s_warp);
      if (!(bound < m)) continue;
      first = order[(size_t)i * nR + j] * rt;
      n = rt;
      if (scanned != nullptr && t == 0) atomicAdd(scanned + i, n);
    } else {
      first = j * rt;
      n = min(rt, R - first);
    }

    float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT], best[NN_QPT], published[NN_QPT];
    int qi[NN_QPT], best_i[NN_QPT];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const int slot = lane + u * NN_GROUP;
      qi[u] = slot < qt ? min(i * qt + slot, Q) : Q;   // Q: no query
      const size_t row = 3 * (size_t)(qi[u] < Q ? qi[u] : 0);
      qx[u] = q[row];
      qy[u] = q[row + 1];
      qz[u] = q[row + 2];
      best[u] = INFINITY;
      published[u] = INFINITY;
      best_i[u] = 0;
    }

    const int nchunks = (n + CHUNK - 1) / CHUNK;
#pragma unroll
    for (int s = 0; s < NN_STAGES - 1; ++s) {
      if (s < nchunks)
        stage_chunk<NT>(ring + s * CHUNK, ref, (size_t)first + s * CHUNK,
                        min(CHUNK, n - s * CHUNK));
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<NN_STAGES - 2>();    // chunk c has landed (this thread)
      __syncthreads();                   // ... for every thread; c-1 is free
      const int ahead = c + NN_STAGES - 1;
      if (ahead < nchunks)
        stage_chunk<NT>(ring + (ahead % NN_STAGES) * CHUNK, ref,
                        (size_t)first + ahead * CHUNK,
                        min(CHUNK, n - ahead * CHUNK));
      cp_async_commit();
      const int off = c * CHUNK + group * NN_SPAN;
      scan_span(ring + (c % NN_STAGES) * CHUNK + group * NN_SPAN,
                min(NN_SPAN, n - off), first + off, qx, qy, qz, best, best_i);
      if (PRUNED) publish(keys, qi, Q, best, best_i, published);
    }
    cp_async_wait<0>();
    if (!PRUNED) publish(keys, qi, Q, best, best_i, published);
  }
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

template <bool PRUNED, int GROUPS>
static cudaError_t launch_items(int grid, const float* q, const float* ref,
                                int Q, int R, int qt, int rt, int nQt,
                                int n_items, const int* order,
                                const float* lb, int nR, float cutoff2,
                                u64* keys, int* scanned,
                                cudaStream_t stream) {
  const int smem = NN_STAGES * GROUPS * NN_SPAN * (int)sizeof(float4);
  // K2's 48 KB ring and the static shared memory pass the 48 KB a launch
  // gets without this opt-in.
  cudaError_t err = cudaFuncSetAttribute(
      nn_items_kernel<PRUNED, GROUPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nn_items_kernel<PRUNED, GROUPS><<<grid, GROUPS * NN_GROUP, smem, stream>>>(
      q, ref, Q, R, qt, rt, nQt, n_items, order, lb, nR, cutoff2, keys,
      scanned);
  return cudaGetLastError();
}

static cudaError_t launch_unpack(const u64* keys, int Q,
                                 const long long* perm, float* d2_out,
                                 int* idx_out, cudaStream_t stream) {
  const int blocks = (Q + NN_UNPACK_THREADS - 1) / NN_UNPACK_THREADS;
  nn_unpack_kernel<<<blocks, NN_UNPACK_THREADS, 0, stream>>>(
      keys, Q, perm, d2_out, idx_out);
  return cudaGetLastError();
}

extern "C" {

// K1.  keys: Q + 1 entries filled with NN_INIT_KEY.
int lsl_nn_indices(const float* q, const float* ref, int Q, int R,
                   u64* keys, float* d2_out, int* idx_out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nQt = (Q + NN_QT - 1) / NN_QT;
  const int n_items = nQt * ((R + NN_K1_RT - 1) / NN_K1_RT);
  err = launch_items<false, NN_K1_GROUPS>(
      n_items, q, ref, Q, R, NN_QT, NN_K1_RT, nQt, n_items, nullptr,
      nullptr, 0, 0.f, keys, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_unpack(keys, Q, nullptr, d2_out, idx_out, s);
}

// K2.  Q = nQ * qb Morton-sorted queries; order, lb: [nQ, nR]; qperm
// [Q] int64 (sorted row -> original row); keys: Q + 1 entries filled with
// NN_INIT_KEY; scanned: [nQ] zeros, or null.
int lsl_nn_indices_pruned(const float* q_sorted, const float* ref_sorted,
                          const int* order, const float* lb,
                          const long long* qperm, int Q, int qb, int rb,
                          int nR, float cutoff2, u64* keys, int* scanned,
                          float* d2_out, int* idx_out, int device,
                          void* stream) {
  if (qb < 1 || qb > NN_QT || Q % qb != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nQ = Q / qb;
  const int n_items = nQ * nR;
  const int grid = min(n_items, NN_K2_BLOCKS_PER_SM * n_sm);
  err = launch_items<true, NN_K2_GROUPS>(
      grid, q_sorted, ref_sorted, Q, nR * rb, qb, rb, nQ, n_items, order, lb,
      nR, cutoff2, keys, scanned, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_unpack(keys, Q, qperm, d2_out, idx_out, s);
}

}  // extern "C"
