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
// K1L, K2L: the same kernels over a lane axis (wrappers
// nn_indices_lanes, nn_indices_pruned_lanes), which is what the JAX
// package's fleet runs under vmap: B independent (queries, reference)
// problems in one launch.
// nn_unpack_kernel (csrc/nn_common.cuh, with the helpers that E2/E3's
// item kernel in csrc/nn_variants.cu shares) writes both kernels' (d2,
// idx) from the merged keys, in the original query order for K2.
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
//   * Lanes.  Lane b reads queries q + 3*b*Q and reference ref + 3*b*R
//     and merges into keys + b*Q; the item counter follows all B*Q keys.
//     A flat query tile t = b*nQt + i numbers the lanes' tiles one after
//     the other, and items stay rank-major over them (item = j * B*nQt +
//     t), so every lane's nearest tiles come before anyone's second.  K2's
//     order and lb rows are [B*nQt, nR]: row t.  One lane is the single
//     problem above, item for item.
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
// K2's set-up (k2_sort_kernel or k2_codes_kernel, then k2_tables_kernel)
// builds on the card, bit for bit, the tables that the JAX package
// computes in XLA around the Pallas call (pallas_nn.py:313-340) and the
// port's plain version computes in torch (nn_kernels.pruned_tables,
// about 110 small launches a call, which cost K2 more than its scan):
//   * The reference's Morton box (its finite min/max and the inverse
//     extent) is computed once, by nn_kernels.build_pruned_ref, and read
//     here.
//   * Query sort.  A query's key is (30-bit Morton code << 32 | row); the
//     row breaks ties, so the ascending keys give the stable argsort.
//     The code rounds as the torch expression: (p - lo) * inv clamped to
//     [0, 1], times 1023, truncated, each step a separately rounded f32
//     operation.  Up to K2_SORT_KEYS queries a lane, one block a lane
//     sorts the keys (bitonic: in registers, by warp shuffles, and through
//     shared memory for the strides across warps); above that
//     k2_codes_kernel writes the codes for one stable torch.sort, chosen
//     by size before any launch.
//   * Tables.  One block a (lane, query tile) gathers its sorted rows,
//     empties their merge keys, reduces the tile's box, computes its nR
//     bounds as pruned_tables sums them, sorts (lb bits << 32 | j) keys
//     (lb >= +0, so the bits order like the float, and j breaks ties as
//     the stable argsort), counts the bounds within the cutoff and writes
//     the aliased order and the bounds, +inf past the cutoff.  Rows of
//     more than K2_TABLE_KEYS bounds (reference tiles of a few points)
//     take one torch.sort of the keys between two launches instead.
//   So a K2 call is four launches on the card: sort, tables, items,
//   unpack.  The set-up is bound by the sort's steps in one block on one
//   SM (0.06 ms at 8192 queries on an H100), not by bytes: it moves
//   about 0.3 MB.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of its launches.

#include "nn_common.cuh"

#define NN_GROUP 64                   // threads that hold one query tile
#define NN_QT (NN_QPT * NN_GROUP)     // 256: the largest query tile
#define NN_K1_RT 4096                 // K1's reference tile
#define NN_K1_GROUPS 2
#define NN_K2_GROUPS 8
#define NN_K2_BLOCKS_PER_SM 2

// One kernel for K1 (PRUNED = false) and K2 (PRUNED = true).  Query tile
// i holds queries [i*qt, min((i+1)*qt, Q)) of q (K2: Morton-sorted).  K1
// item (i, j) scans reference rows [j*rt, min((j+1)*rt, R)); K2 item
// (i, j) scans tile order[i][j] (rows order*rt .. +rt of the sorted
// reference) unless its bound lb[i][j] lets it skip.  keys[Q] is the
// item counter; scanned[i] (K2, optional) counts the reference points
// scanned for query tile i.  Over lanes Q and R are per lane, nQt the
// query tiles of one lane and nT = lanes * nQt; i above is the tile
// within its lane and order, lb and scanned are indexed by the flat tile.
template <bool PRUNED, int GROUPS>
__global__ void __launch_bounds__(GROUPS * NN_GROUP,
                                  1024 / (GROUPS * NN_GROUP))
nn_items_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                int Q, int R, int qt, int rt, int nQt, int nT, int n_items,
                const int* __restrict__ order, const float* __restrict__ lb,
                int nR, float cutoff2, u64* keys_all,
                int* __restrict__ scanned) {
  constexpr int NT = GROUPS * NN_GROUP;
  constexpr int CHUNK = GROUPS * NN_SPAN;
  extern __shared__ float4 ring[];       // NN_STAGES x CHUNK rows
  __shared__ int s_item;
  __shared__ float s_warp[NT / 32];
  const int t = threadIdx.x;
  const int group = t / NN_GROUP;
  const int lane = t % NN_GROUP;
  u64* next_item = keys_all + (size_t)(nT / nQt) * Q;

  for (;;) {
    __syncthreads();                     // the last item's shared state is free
    if (t == 0) {
      const u64 taken = atomicAdd(next_item, 1ULL) - NN_INIT_KEY;
      s_item = taken < (u64)n_items ? (int)taken : n_items;
    }
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) return;
    const int tile = item % nT;          // flat query tile
    const int j = item / nT;             // rank (K2) or reference tile (K1)
    const int b = tile / nQt;            // lane
    const int i = tile % nQt;            // query tile within the lane
    const float* __restrict__ qb = q + 3 * (size_t)b * Q;
    const float* __restrict__ refb = ref + 3 * (size_t)b * R;
    u64* keys = keys_all + (size_t)b * Q;

    int first, n;
    if (PRUNED) {
      const float bound = lb[(size_t)tile * nR + j];
      if (!(bound < cutoff2)) continue;
      float m = -INFINITY;
      for (int s = t; s < qt; s += NT)
        m = fmaxf(m, key_d2(__ldcg(keys + (size_t)i * qt + s)));
      m = block_max<NT>(m, s_warp);
      if (!(bound < m)) continue;
      first = order[(size_t)tile * nR + j] * rt;
      n = rt;
      if (scanned != nullptr && t == 0) atomicAdd(scanned + tile, n);
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
      qx[u] = qb[row];
      qy[u] = qb[row + 1];
      qz[u] = qb[row + 2];
      best[u] = INFINITY;
      published[u] = INFINITY;
      best_i[u] = 0;
    }

    const int nchunks = (n + CHUNK - 1) / CHUNK;
#pragma unroll
    for (int s = 0; s < NN_STAGES - 1; ++s) {
      if (s < nchunks)
        stage_chunk<NT>(ring + s * CHUNK, refb, (size_t)first + s * CHUNK,
                        min(CHUNK, n - s * CHUNK));
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<NN_STAGES - 2>();    // chunk c has landed (this thread)
      __syncthreads();                   // ... for every thread; c-1 is free
      const int ahead = c + NN_STAGES - 1;
      if (ahead < nchunks)
        stage_chunk<NT>(ring + (ahead % NN_STAGES) * CHUNK, refb,
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

template <bool PRUNED, int GROUPS>
static cudaError_t launch_items(int grid, const float* q, const float* ref,
                                int Q, int R, int qt, int rt, int nQt,
                                int nT, int n_items, const int* order,
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
      q, ref, Q, R, qt, rt, nQt, nT, n_items, order, lb, nR, cutoff2, keys,
      scanned);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// K2's set-up
// --------------------------------------------------------------------------

#define K2_SORT_THREADS 1024
#define K2_SORT_KEYS 16384           // a lane's queries one block sorts
#define K2_TABLE_THREADS NN_QT       // a query tile's rows, one a thread
#define K2_TABLE_KEYS 4096           // bounds a row one block sorts
#define K2_CODE_THREADS 256

// min and max that return NaN when either side is NaN, as torch.amin,
// torch.maximum and torch.clamp do.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// The 30-bit Morton code of point p over the box (lo, inv), rounded as
// nn_kernels._morton3d: u = clamp((p - lo) * inv, 0, 1), then
// (u * 1023).to(int32), which truncates (NaN converts to 0 in both).
__device__ __forceinline__ unsigned k2_code(const float* __restrict__ p,
                                            const float* __restrict__ box) {
  unsigned g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float u = __fmul_rn(__fsub_rn(p[d], box[d]), box[6 + d]);
    const float c = u != u ? u : fminf(fmaxf(u, 0.f), 1.f);
    g[d] = (unsigned)(int)__fmul_rn(c, 1023.f);
  }
  return spread_bits10(g[0]) | (spread_bits10(g[1]) << 1) |
         (spread_bits10(g[2]) << 2);
}

__device__ __forceinline__ void keep(u64& k, u64 o, bool keep_min) {
  k = keep_min ? (o < k ? o : k) : (o > k ? o : k);
}

// Ascending bitonic sort of P keys (a power of two, P = NT * E or P <=
// NT with E = 1) held E to a thread in registers: thread t holds
// positions t*E .. t*E + E-1 (those at P and beyond stay out).  As E6's
// cluster_sort (csrc/nn_variants.cu) within one block: a pair within a
// thread meets in registers, within a warp by shuffles, across warps in
// s_keys (P keys), so only the strides of 32E and more pass through
// shared memory.
template <int NT, int E>
__device__ __forceinline__ void block_sort_held(u64* s_keys, u64 (&k)[E],
                                                int P) {
  const int t = threadIdx.x;
  const int pos0 = t * E;
  const bool holds = pos0 < P;
  const int lim = min(32 * E, P);    // strides from here on: shared memory
  for (int size = 2; size <= P; size <<= 1) {
    int stride = size >> 1;
    if (stride >= lim) {                       // across warps
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (holds) s_keys[pos0 + e] = k[e];
      for (; stride >= lim; stride >>= 1) {
        __syncthreads();
        for (int x = t; x < P / 2; x += NT) {
          const int i = ((x & ~(stride - 1)) << 1) | (x & (stride - 1));
          const int j = i + stride;
          const u64 a = s_keys[i], b = s_keys[j];
          if ((a > b) == ((i & size) == 0)) {
            s_keys[i] = b;
            s_keys[j] = a;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (holds) k[e] = s_keys[pos0 + e];
      __syncthreads();               // read before the next store
    }
    for (; stride >= E; stride >>= 1) {        // across lanes
      const bool keep_min = ((pos0 & stride) == 0) == ((pos0 & size) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e)
        keep(k[e], __shfl_xor_sync(0xffffffffu, k[e], stride / E),
             keep_min);
    }
    for (; stride > 0; stride >>= 1) {         // within a thread
#pragma unroll
      for (int s = 1; s < E; s <<= 1) {
        if (s == stride) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int f = e ^ s;
            if (f > e) {
              const u64 a = k[e], b = k[f];
              if ((a > b) == (((pos0 + e) & size) == 0)) {
                k[e] = b;
                k[f] = a;
              }
            }
          }
        }
      }
    }
  }
}

template <int NT, int E>
__device__ __forceinline__ void sort_held(u64* s, int P) {
  const int pos0 = (int)threadIdx.x * E;
  const bool holds = pos0 < P;
  u64 k[E];
  __syncthreads();                   // the caller's keys are written
#pragma unroll
  for (int e = 0; e < E; ++e) k[e] = holds ? s[pos0 + e] : ~0ULL;
  block_sort_held<NT, E>(s, k, P);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (holds) s[pos0 + e] = k[e];
  __syncthreads();                   // the sorted keys are readable
}

// Ascending sort of P (a power of two, P <= 16 NT) keys s[0, P) in
// shared memory by the block's NT threads, P / NT (at least 1) of them a
// thread in registers (block_sort_held).
template <int NT>
__device__ __forceinline__ void block_sort(u64* s, int P) {
  switch (P / NT) {                  // keys a thread; uniform in the block
    case 16: sort_held<NT, 16>(s, P); break;
    case 8: sort_held<NT, 8>(s, P); break;
    case 4: sort_held<NT, 4>(s, P); break;
    case 2: sort_held<NT, 2>(s, P); break;
    default: sort_held<NT, 1>(s, P); break;
  }
}

// Query sort in shared memory: block b codes lane b's Q <= K2_SORT_KEYS
// queries as (code << 32 | row) keys over its box (box + 9b: lo, hi,
// inv), sorts P >= Q keys (padding ~0 sorts last) and writes
// qperm[b*Q + s], the row of sorted rank s.
__global__ void __launch_bounds__(K2_SORT_THREADS)
k2_sort_kernel(const float* __restrict__ q, const float* __restrict__ box,
               int Q, int P, long long* __restrict__ qperm) {
  extern __shared__ u64 s_keys[];
  const int b = blockIdx.x;
  const float* __restrict__ qb = q + 3 * (size_t)b * Q;
  const float* __restrict__ bx = box + 9 * (size_t)b;
  for (int k = threadIdx.x; k < P; k += K2_SORT_THREADS)
    s_keys[k] = k < Q ? ((u64)k2_code(qb + 3 * (size_t)k, bx) << 32) |
                            (unsigned)k
                      : ~0ULL;
  block_sort<K2_SORT_THREADS>(s_keys, P);
  for (int k = threadIdx.x; k < Q; k += K2_SORT_THREADS)
    qperm[(size_t)b * Q + k] = (long long)(s_keys[k] & 0xffffffffULL);
}

// Block box of v (min of v[0..2], max of v[3..5]) with NaN carried, into
// s_box[6] for every thread.
template <int NT>
__device__ __forceinline__ void block_box_nan(float (&v)[6],
                                              float (*s_warp)[NT / 32],
                                              float* s_box) {
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[d], off);
      v[d] = d < 3 ? nan_min(v[d], o) : nan_max(v[d], o);
    }
    if ((threadIdx.x & 31) == 0) s_warp[d][threadIdx.x >> 5] = v[d];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int d = threadIdx.x;
    float m = s_warp[d][0];
    for (int w = 1; w < NT / 32; ++w)
      m = d < 3 ? nan_min(m, s_warp[d][w]) : nan_max(m, s_warp[d][w]);
    s_box[d] = m;
  }
  __syncthreads();
}

// The codes alone, codes[b*Q + k], for one stable torch.sort of lanes of
// more than K2_SORT_KEYS queries.
__global__ void __launch_bounds__(K2_CODE_THREADS)
k2_codes_kernel(const float* __restrict__ q, const float* __restrict__ box,
                int lanes, int Q, int* __restrict__ codes) {
  const size_t k = (size_t)blockIdx.x * K2_CODE_THREADS + threadIdx.x;
  if (k >= (size_t)lanes * Q) return;
  codes[k] = (int)k2_code(q + 3 * k, box + 9 * (k / Q));
}

// Tables: block `tile` = b*nQ + i holds query tile i of lane b (qb rows
// from flat sorted row first = b*Q + i*qb).  Stage 0 does it all with the
// row's bounds sorted in shared memory (P >= nR keys); stage 1 stops
// after writing the unsorted bound keys to lb_keys[tile*nR + j]; stage 2,
// after a torch.sort of each row of lb_keys, only writes order and lb
// from them.  rows (lanes only, else null) receives b*Q + row for the
// unpack of the flat output; the block of tile 0 also sets the item
// counter keys[lanes*Q].
__global__ void __launch_bounds__(K2_TABLE_THREADS)
k2_tables_kernel(const float* __restrict__ q,
                 const long long* __restrict__ qperm,
                 const float* __restrict__ tile_lo,
                 const float* __restrict__ tile_hi, int lanes, int Q,
                 int qb, int nR, int P, float cutoff2, int stage,
                 float* __restrict__ q_sorted, int* __restrict__ order,
                 float* __restrict__ lb, u64* __restrict__ keys,
                 long long* __restrict__ rows, u64* __restrict__ lb_keys) {
  extern __shared__ u64 s_keys[];    // P bound keys (stage 0)
  __shared__ float s_warp[6][K2_TABLE_THREADS / 32];
  __shared__ float s_box[6];
  __shared__ int s_cnt;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int nQ = Q / qb;
  const int b = tile / nQ;
  const size_t first = (size_t)b * Q + (size_t)(tile % nQ) * qb;
  if (stage != 2) {
    float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
    for (int s = t; s < qb; s += K2_TABLE_THREADS) {
      const size_t row = (size_t)b * Q + (size_t)qperm[first + s];
      const float x = q[3 * row], y = q[3 * row + 1], z = q[3 * row + 2];
      float* o = q_sorted + 3 * (first + s);
      o[0] = x;
      o[1] = y;
      o[2] = z;
      keys[first + s] = NN_INIT_KEY;
      if (rows != nullptr) rows[first + s] = (long long)row;
      v[0] = nan_min(v[0], x);
      v[1] = nan_min(v[1], y);
      v[2] = nan_min(v[2], z);
      v[3] = nan_max(v[3], x);
      v[4] = nan_max(v[4], y);
      v[5] = nan_max(v[5], z);
    }
    if (tile == 0 && t == 0) keys[(size_t)lanes * Q] = NN_INIT_KEY;
    block_box_nan<K2_TABLE_THREADS>(v, s_warp, s_box);
    const float* __restrict__ tl = tile_lo + 3 * (size_t)b * nR;
    const float* __restrict__ th = tile_hi + 3 * (size_t)b * nR;
    const int n = stage == 0 ? P : nR;
    for (int j = t; j < n; j += K2_TABLE_THREADS) {
      u64 key = ~0ULL;
      if (j < nR) {
        // gap = clamp(max(tile_lo - q_hi, q_lo - tile_hi), 0), and
        // lb = (gx*gx + gy*gy) + gz*gz, as pruned_tables.
        float g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          g[d] = nan_max(nan_max(__fsub_rn(tl[3 * j + d], s_box[3 + d]),
                                 __fsub_rn(s_box[d], th[3 * j + d])),
                         0.f);
        const float l = __fadd_rn(
            __fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
            __fmul_rn(g[2], g[2]));
        // Every NaN one key, so NaN bounds keep their order by j, last.
        const unsigned bits = l != l ? 0x7fffffffu : __float_as_uint(l);
        key = ((u64)bits << 32) | (unsigned)j;
      }
      if (stage == 0)
        s_keys[j] = key;
      else
        lb_keys[(size_t)tile * nR + j] = key;
    }
    if (stage == 1) return;
    block_sort<K2_TABLE_THREADS>(s_keys, P);
  }
  const u64* sorted = stage == 0 ? s_keys : lb_keys + (size_t)tile * nR;
  if (t == 0) s_cnt = 0;
  __syncthreads();
  int kept = 0;                      // sorted ascending: a prefix is kept
  for (int j = t; j < nR; j += K2_TABLE_THREADS)
    kept += key_d2(sorted[j]) <= cutoff2;
  if (kept) atomicAdd(&s_cnt, kept);
  __syncthreads();
  const int cnt = s_cnt;
  const int last = max(cnt - 1, 0);
  for (int j = t; j < nR; j += K2_TABLE_THREADS) {
    order[(size_t)tile * nR + j] =
        (int)(unsigned)(sorted[min(j, last)] & 0xffffffffULL);
    lb[(size_t)tile * nR + j] = j < cnt ? key_d2(sorted[j]) : INFINITY;
  }
}

static int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

extern "C" {

// K2's query sort in shared memory: q [lanes, Q, 3] with Q <=
// K2_SORT_KEYS, box [lanes, 3, 3] (lo, hi, inv); qperm [lanes, Q] int64.
int lsl_k2_sort(const float* q, const float* box, int lanes, int Q,
                long long* qperm, int device, void* stream) {
  if (lanes < 1 || Q < 1 || Q > K2_SORT_KEYS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = pow2_at_least(Q);
  const int smem = P * (int)sizeof(u64);
  err = cudaFuncSetAttribute(k2_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  k2_sort_kernel<<<lanes, K2_SORT_THREADS, smem, (cudaStream_t)stream>>>(
      q, box, Q, P, qperm);
  return (int)cudaGetLastError();
}

// K2's query codes for torch.sort: codes [lanes, Q] int32.
int lsl_k2_codes(const float* q, const float* box, int lanes, int Q,
                 int* codes, int device, void* stream) {
  if (lanes < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)lanes * Q;
  const int blocks = (int)((n + K2_CODE_THREADS - 1) / K2_CODE_THREADS);
  k2_codes_kernel<<<blocks, K2_CODE_THREADS, 0, (cudaStream_t)stream>>>(
      q, box, lanes, Q, codes);
  return (int)cudaGetLastError();
}

// K2's tables from the sorted rows qperm [lanes, Q] (int64, within the
// lane): q_sorted [lanes, Q, 3], order and lb [lanes, Q/qb, nR], keys
// [lanes*Q + 1] set to NN_INIT_KEY, rows [lanes*Q] (or null).  Stage 0:
// nR <= K2_TABLE_KEYS, all in one launch; stages 1 and 2 around a
// torch.sort of lb_keys [lanes*Q/qb, nR].
int lsl_k2_tables(const float* q, const long long* qperm,
                  const float* tile_lo, const float* tile_hi, int lanes,
                  int Q, int qb, int nR, float cutoff2, int stage,
                  float* q_sorted, int* order, float* lb, u64* keys,
                  long long* rows, u64* lb_keys, int device, void* stream) {
  if (lanes < 1 || qb < 1 || qb > K2_TABLE_THREADS || Q % qb != 0 ||
      nR < 1 || stage < 0 || stage > 2 ||
      (stage == 0 && nR > K2_TABLE_KEYS) ||
      (stage != 0 && lb_keys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int P = stage == 0 ? pow2_at_least(nR) : 0;
  const int smem = P * (int)sizeof(u64);
  const int blocks = lanes * (Q / qb);
  k2_tables_kernel<<<blocks, K2_TABLE_THREADS, smem, (cudaStream_t)stream>>>(
      q, qperm, tile_lo, tile_hi, lanes, Q, qb, nR, P, cutoff2, stage,
      q_sorted, order, lb, keys, rows, lb_keys);
  return (int)cudaGetLastError();
}

// K1 over lanes: q [lanes, Q, 3], ref [lanes, R, 3]; keys: lanes*Q + 1
// entries filled with NN_INIT_KEY; d2_out, idx_out [lanes, Q].
int lsl_nn_indices_lanes(const float* q, const float* ref, int lanes, int Q,
                         int R, u64* keys, float* d2_out, int* idx_out,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nQt = (Q + NN_QT - 1) / NN_QT;
  const int nT = lanes * nQt;
  const int n_items = nT * ((R + NN_K1_RT - 1) / NN_K1_RT);
  err = launch_items<false, NN_K1_GROUPS>(
      n_items, q, ref, Q, R, NN_QT, NN_K1_RT, nQt, nT, n_items, nullptr,
      nullptr, 0, 0.f, keys, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_unpack(keys, lanes * Q, nullptr, d2_out, idx_out, s);
}

// K1.  keys: Q + 1 entries filled with NN_INIT_KEY.
int lsl_nn_indices(const float* q, const float* ref, int Q, int R,
                   u64* keys, float* d2_out, int* idx_out, int device,
                   void* stream) {
  return lsl_nn_indices_lanes(q, ref, 1, Q, R, keys, d2_out, idx_out,
                              device, stream);
}

// K2 over lanes.  Each lane holds Q = nQ * qb Morton-sorted queries
// (q_sorted [lanes, Q, 3]) and its sorted reference (ref_sorted [lanes,
// nR*rb, 3]); order, lb: [lanes, nQ, nR]; qperm [lanes*Q] int64 (sorted
// row -> original row of the flat [lanes*Q] output); keys: lanes*Q + 1
// entries filled with NN_INIT_KEY; scanned: [lanes*nQ] zeros, or null.
int lsl_nn_indices_pruned_lanes(const float* q_sorted,
                                const float* ref_sorted, const int* order,
                                const float* lb, const long long* qperm,
                                int lanes, int Q, int qb, int rb, int nR,
                                float cutoff2, u64* keys, int* scanned,
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
  const int nT = lanes * nQ;
  const int n_items = nT * nR;
  const int grid = min(n_items, NN_K2_BLOCKS_PER_SM * n_sm);
  err = launch_items<true, NN_K2_GROUPS>(
      grid, q_sorted, ref_sorted, Q, nR * rb, qb, rb, nQ, nT, n_items, order,
      lb, nR, cutoff2, keys, scanned, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_unpack(keys, lanes * Q, qperm, d2_out, idx_out, s);
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
  return lsl_nn_indices_pruned_lanes(q_sorted, ref_sorted, order, lb, qperm,
                                     1, Q, qb, rb, nR, cutoff2, keys,
                                     scanned, d2_out, idx_out, device,
                                     stream);
}

}  // extern "C"
