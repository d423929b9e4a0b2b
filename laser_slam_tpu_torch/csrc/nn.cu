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

extern "C" {

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
