// The exact-NN shootout's experiment kernels, written for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes (laser_slam_tpu_torch/ops/cuda_build.py); the
// Python wrappers live in laser_slam_tpu_torch/ops/nn_variants.py beside
// their plain torch versions.
//
// mm_items_kernel and    replace E5 experiments/pallas_payload_variants.py
// mm_epilogue_kernel     _nn_idx_kernel (and E1 experiments/
//                        pallas_nn_variants.py kern at HIGHEST precision)
//                        and E4 pallas_payload_variants.py _nn_kernel;
//                        mm_prelude_kernel is their set-up.
// e1_items_kernel and    replace E1 experiments/pallas_nn_variants.py
// e1_epilogue_kernel     kern at DEFAULT precision (:75-136, one bf16 pass
//                        of the MXU with f32 accumulate); e1_prelude_kernel
//                        is its set-up.
// e6_items_kernel and    replace E6 pallas_payload_variants.py
// e6_epilogue_kernel     _pruned_kernel; e6_morton_kernel and
//                        e6_gather_kernel are its set-up (the wrapper's
//                        sort, boxes and unsort at :380-451).
// nn_tile_items_kernel   replaces E2 pallas_nn_variants.py vpu_kernel and
//                        E3 pallas_tile_sweep.py nn_tiled (K1's function at
//                        a chosen tile shape).
//
// The matmul form.  Query row (x, y, z, 1) times reference row (-2x, -2y,
// -2z, |r|^2) is |q-r|^2 - |q|^2, the "score", three FMAs a pair in one
// order (mm_score); d2 = max(score + |q|^2, 0).  The extended reference
// rows are built on the card (E4/E5 by mm_prelude_kernel, E6 by its
// gather kernel, E1's bf16 B fragment words by e1_prelude_kernel) and
// staged in shared memory a span at a time.
//
// What bounds them on this card: no device-memory traffic to speak of (a
// query is read once, a reference row once per block, from L2), so the
// work is instruction issue on the CUDA cores, and the design keeps the
// loop over pairs down to the function's own arithmetic:
//   * E5 and E4: 3 f32 FMAs and a min a pair.  The tensor cores take no
//     f32 operands and TF32 keeps bf16's rank problem, so the product
//     stays on the FMA pipes.  (Query tile x reference span) work items
//     fill the card (512 at 8192 x 65536); a thread holds 4 queries, so a
//     shared-memory read of a row serves 4 pairs, and carries no index:
//     each query's least score per key tile folds into a 64-bit key,
//     (orderable score bits) << 32 | key tile, merged across items by
//     atomicMin.  The least key is the least score in the lowest key
//     tile that attains it, the Pallas rule across tiles (strict '<' in
//     ascending order).  An epilogue of one warp a query scores the
//     winning key tile again with the same FMAs (the same bits): E5 takes
//     its lowest tied row (the key tile is 512 rows, the span a group
//     scans; the lowest row of the lowest tile is the lowest index of the
//     minimum, the Pallas result for any tile width), E4 averages the
//     payload rows that tie (the key tile is E4's own rb = _tile(R, 2048),
//     so the Pallas one-hot / count of the winning tile).  Set-up,
//     items and epilogue: three launches a call.
//   * E1 (bf16): the product is bf16 with f32 accumulate, which the
//     tensor cores do (mma.sync m16n8k8: K = 8 holds the 4 real slots
//     with half m16n8k16's padding; 8 FLOPs a pair, 4.3 us of the card's
//     989 TFLOP/s at 8192 x 65536), so what bounds it is the CUDA cores'
//     pass over the scores, and the design leaves one fminf a pair there
//     (16 us at one instruction a lane a clock; twice that if the min
//     issues at half rate).  E5's keys carry over: work items of 256
//     queries x 2048 rows (1024 at 8192 x 65536, up to 8 blocks an SM),
//     each warp holding 4 m16 A fragments in registers and reusing each
//     B fragment across them; each query's minimum a 512-row key tile
//     folded by shuffles into one key, merged by atomicMin; the reference
//     rounded and packed to bf16 B words once, by the set-up, and staged
//     by cp.async into two shared buffers, one filling while the other is
//     scanned; an epilogue that scores the winning tile again with the
//     same mma instruction and K slots (the same bits), takes the lowest
//     row that ties, and writes index -1 if none does (a self-check, not
//     a fallback).  Set-up, items and epilogue: three launches a call.
//   * pruned payload (E6): E4's scan over the tiles its items do not
//     skip; ties and payloads are the epilogue's, as E4's.
//   * tiled exact (E2/E3): K1's 11 instructions per pair (csrc/nn.cu), at
//     a chosen (query tile, reference tile) work item.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "nn_common.cuh"

namespace cg = cooperative_groups;

#define MAX_PAYLOAD 8
#define KEY_EMPTY 0xffffffffffffffffULL   // no score merged yet

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mm_score(float qx, float qy, float qz,
                                          float4 r) {
  return fmaf(qz, r.z, fmaf(qy, r.y, fmaf(qx, r.x, r.w)));
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Bits of a score whose unsigned order is the float order (-0 made +0).
__device__ __forceinline__ unsigned score_bits(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float bits_score(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ u64 score_key(float s, unsigned tile) {
  return ((u64)score_bits(s) << 32) | tile;
}

// Of the n extended rows from r_ext[first]: how many score exactly `best`
// against (x, y, z) (the same FMAs as the scan, so the same bits), and
// their payload rows summed into sum, both across the warp.  Row s's
// payload is pay[rows[s]] (E6's sorted reference) or pay[s].
__device__ __forceinline__ int tied_payload(float x, float y, float z,
                                            float best,
                                            const float4* __restrict__ r_ext,
                                            size_t first, int n,
                                            const int* __restrict__ rows,
                                            const float* __restrict__ pay,
                                            int P,
                                            float (&sum)[MAX_PAYLOAD]) {
  int count = 0;
  for (int k = threadIdx.x & 31; k < n; k += 32) {
    const size_t s = first + k;
    if (mm_score(x, y, z, r_ext[s]) == best) {
      ++count;
      const float* pr = pay + (rows != nullptr ? (size_t)rows[s] : s) * P;
#pragma unroll
      for (int p = 0; p < MAX_PAYLOAD; ++p)
        if (p < P) sum[p] = __fadd_rn(sum[p], pr[p]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
#pragma unroll
    for (int p = 0; p < MAX_PAYLOAD; ++p)
      sum[p] = __fadd_rn(sum[p], __shfl_xor_sync(0xffffffffu, sum[p], off));
  }
  return count;
}

// ---------------------------------------------------------------------------
// E1 bf16: one bf16 pass on the tensor cores, f32 accumulate
// ---------------------------------------------------------------------------
//
// Three launches a call:
//   * e1_prelude_kernel: each reference row's B fragment words, rounded to
//     bf16 once, (-2x, -2y) and (-2z, |r|^2), 8 bytes a row in rows[R8]
//     (R rounded up to 8; the pad rows zero), and the queries' keys
//     emptied.  |r|^2 is norm2's f32 value, (x*x + y*y) + z*z, the one the
//     plain set-up rounds.
//   * e1_items_kernel (pass 1): block (i, j) holds query tile i (256
//     queries; each of its 4 warps holds 4 m16 A fragments of (x, y, z, 1)
//     in registers) and scans reference span j (2048 rows) a key tile
//     (512 rows) at a time, the key tiles staged by cp.async into two
//     shared buffers, one filling while the other is scanned.  Each 8-row
//     B fragment is read from shared memory once a warp and multiplied
//     into its 4 A fragments by mma.sync m16n8k8 (K slots 0-3 real, 4-7
//     zero: lanes with threadID_in_group 2 and 3 hold zero A words and
//     read the zero pad words of a 16-byte shared row), and each of the
//     warp's 16 scores a lane gets takes one fminf and nothing else.  At
//     the end of a key tile a query's minimum is folded across the 4 lanes
//     of its mma group by shuffles into score_key(min, key tile) and kept
//     in shared memory; the block's keys meet the other items' by one
//     atomicMin a query.  Rows past R in the last 8-row step are masked
//     to +inf (a zero A word times a finite pad word is 0, never NaN).
//   * e1_epilogue_kernel (pass 2), a warp a query: the least key decoded
//     to (score, key tile); the tile scored again with the same mma.sync
//     m16n8k8 and the same K slots (the query in every A row), so its
//     scores carry the pass's bits (e1_rescore: 16 steps of 8 rows at a
//     time, up to the first batch that holds the key's score, masks only
//     on the reference's last, ragged tile); its lowest row with that
//     score, d2 = max(score + |q|^2, 0) with |q|^2 = norm2, the key
//     emptied for the next call.  A tile in which no row reproduces the
//     key's score writes index -1, which the checks refuse.

#define E1_WARPS 4
#define E1_THREADS (32 * E1_WARPS)
#define E1_FRAGS 4                                // m16 A fragments a warp
#define E1_QT (16 * E1_FRAGS * E1_WARPS)          // 256 queries a tile
#define E1_KEY_TILE 512                           // rows a key tile (staged)
#define E1_SPAN (4 * E1_KEY_TILE)                 // 2048 rows an item
#define E1_BLOCKS_PER_SM 8
#define E1_PRELUDE_THREADS 256
#define E1_EPILOGUE_THREADS 256
#define E1_BATCH 16                               // epilogue steps a batch

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// A fragment word of the query row (x, y, z, 1) for the lane with
// threadID_in_group t: K slots (2t, 2t + 1).
__device__ __forceinline__ uint32_t e1_a_word(const float* __restrict__ q,
                                              size_t row, int t) {
  if (t == 0) return pack_bf16(q[3 * row], q[3 * row + 1]);
  if (t == 1) return pack_bf16(q[3 * row + 2], 1.f);
  return 0u;
}

// D = A B, m16n8k8, bf16 operands, f32 accumulate from zero: d0, d1 are
// row g, columns 2t, 2t + 1; d2, d3 row g + 8.
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4], uint32_t a0,
                                              uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(E1_PRELUDE_THREADS)
e1_prelude_kernel(const float* __restrict__ ref, int Q, int R, int R8,
                  uint2* __restrict__ rows, u64* __restrict__ keys) {
  const int k = blockIdx.x * E1_PRELUDE_THREADS + threadIdx.x;
  if (k < R8) {
    uint2 w = make_uint2(0u, 0u);
    if (k < R) {
      const float x = ref[3 * (size_t)k], y = ref[3 * (size_t)k + 1],
                  z = ref[3 * (size_t)k + 2];
      w = make_uint2(pack_bf16(-2.f * x, -2.f * y),
                     pack_bf16(-2.f * z, norm2(x, y, z)));
    }
    rows[k] = w;
  }
  if (k < Q) keys[k] = KEY_EMPTY;
}

// Copy n packed rows into 16-byte shared rows (words 2-3 stay zero).
__device__ __forceinline__ void e1_stage(uint4* dst,
                                         const uint2* __restrict__ src,
                                         int n) {
  for (int k = threadIdx.x; k < n; k += E1_THREADS)
    cp_async8(dst + k, src + k);
}

__global__ void __launch_bounds__(E1_THREADS, E1_BLOCKS_PER_SM)
e1_items_kernel(const float* __restrict__ q, const uint2* __restrict__ rows,
                int Q, int R, int n_qt, u64* keys) {
  __shared__ uint4 s_b[2][E1_KEY_TILE];   // (B word t = 0, t = 1, 0, 0)
  __shared__ u64 s_key[E1_QT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i = blockIdx.x % n_qt;
  const int j = blockIdx.x / n_qt;
  const int first = j * E1_SPAN;
  const int n = min(E1_SPAN, R - first);
  const int n_tiles = (n + E1_KEY_TILE - 1) / E1_KEY_TILE;
  for (int k = threadIdx.x; k < 2 * E1_KEY_TILE; k += E1_THREADS)
    (&s_b[0][0])[k] = make_uint4(0u, 0u, 0u, 0u);   // the pad words, once
  for (int k = threadIdx.x; k < E1_QT; k += E1_THREADS) s_key[k] = KEY_EMPTY;
  __syncthreads();                   // zeros before the copies land
  e1_stage(s_b[0], rows + first, min(E1_KEY_TILE, n));
  cp_async_commit();
  if (n_tiles > 1)
    e1_stage(s_b[1], rows + first + E1_KEY_TILE,
             min(E1_KEY_TILE, n - E1_KEY_TILE));
  cp_async_commit();

  const int q0 = i * E1_QT + warp * (16 * E1_FRAGS);
  uint32_t a[E1_FRAGS][2];
#pragma unroll
  for (int f = 0; f < E1_FRAGS; ++f) {
    const int r0 = q0 + 16 * f + g;
    a[f][0] = r0 < Q ? e1_a_word(q, r0, t) : 0u;
    a[f][1] = r0 + 8 < Q ? e1_a_word(q, r0 + 8, t) : 0u;
  }
  const uint32_t* s_w = reinterpret_cast<const uint32_t*>(&s_b[0][0]);
  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<1>();              // key tile c has landed (this thread)
    __syncthreads();                 // ... for every thread
    const uint32_t* w = s_w + (c & 1) * 4 * E1_KEY_TILE + 4 * g + t;
    const int m = min(E1_KEY_TILE, n - c * E1_KEY_TILE);
    const int full = m & ~7;
    float mn[E1_FRAGS][4];
#pragma unroll
    for (int f = 0; f < E1_FRAGS; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) mn[f][e] = INFINITY;
#pragma unroll 4
    for (int k8 = 0; k8 < full; k8 += 8) {
      const uint32_t b = w[4 * k8];
#pragma unroll
      for (int f = 0; f < E1_FRAGS; ++f) {
        float d[4];
        mma_bf16_1688(d, a[f][0], a[f][1], b);
#pragma unroll
        for (int e = 0; e < 4; ++e) mn[f][e] = fminf(mn[f][e], d[e]);
      }
    }
    if (full < m) {                  // the reference's last, ragged step
      const uint32_t b = w[4 * full];
      const bool c0 = full + 2 * t < m, c1 = full + 2 * t + 1 < m;
#pragma unroll
      for (int f = 0; f < E1_FRAGS; ++f) {
        float d[4];
        mma_bf16_1688(d, a[f][0], a[f][1], b);
        mn[f][0] = fminf(mn[f][0], c0 ? d[0] : INFINITY);
        mn[f][1] = fminf(mn[f][1], c1 ? d[1] : INFINITY);
        mn[f][2] = fminf(mn[f][2], c0 ? d[2] : INFINITY);
        mn[f][3] = fminf(mn[f][3], c1 ? d[3] : INFINITY);
      }
    }
    const unsigned tile = (unsigned)(first / E1_KEY_TILE + c);
#pragma unroll
    for (int f = 0; f < E1_FRAGS; ++f) {
      float lo = fminf(mn[f][0], mn[f][1]), hi = fminf(mn[f][2], mn[f][3]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fminf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (t == 0) {                  // this lane alone owns rows g, g + 8
        const int s = warp * (16 * E1_FRAGS) + 16 * f + g;
        const u64 klo = score_key(lo, tile), khi = score_key(hi, tile);
        if (klo < s_key[s]) s_key[s] = klo;
        if (khi < s_key[s + 8]) s_key[s + 8] = khi;
      }
    }
    __syncthreads();                 // buffer c & 1 is read: refill it
    if (c + 2 < n_tiles)
      e1_stage(s_b[c & 1], rows + first + (c + 2) * E1_KEY_TILE,
               min(E1_KEY_TILE, n - (c + 2) * E1_KEY_TILE));
    cp_async_commit();
  }
  cp_async_wait<0>();
  for (int k = threadIdx.x; k < E1_QT; k += E1_THREADS) {
    const int qi = i * E1_QT + k;
    if (qi < Q && s_key[k] != KEY_EMPTY) atomicMin(keys + qi, s_key[k]);
  }
}

// The lowest of rows [first, first + n) whose score against the A word a
// equals best, by the items' mma; the whole warp gets it (0xffffffff if
// none).  Lane (g, t < 2) reads B word t of rows first + k8 + g, E1_BATCH
// steps of 8 rows at a time with their loads issued together, up to the
// first batch that holds the score.  RAGGED (the reference's last key
// tile only) masks the rows past n; the pad rows up to a multiple of 8
// exist (zero).
template <bool RAGGED>
__device__ __forceinline__ unsigned e1_rescore(const uint2* __restrict__ rows,
                                               uint32_t a, float best,
                                               int first, int n) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, g = lane >> 2;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(rows + first + g) + t;
  unsigned row = 0xffffffffu;
  for (int k0 = 0; k0 < n && row == 0xffffffffu; k0 += 8 * E1_BATCH) {
    uint32_t b[E1_BATCH];
#pragma unroll
    for (int s = 0; s < E1_BATCH; ++s)
      b[s] = t < 2 && (!RAGGED || k0 + 8 * s < n) ? src[2 * (k0 + 8 * s)]
                                                  : 0u;
#pragma unroll
    for (int s = 0; s < E1_BATCH; ++s) {
      const int c = k0 + 8 * s + 2 * t;
      if (!RAGGED || k0 + 8 * s < n) {   // the same for the whole warp
        float d[4];
        mma_bf16_1688(d, a, a, b[s]);
        if ((!RAGGED || c < n) && d[0] == best)
          row = min(row, (unsigned)(first + c));
        if ((!RAGGED || c + 1 < n) && d[1] == best)
          row = min(row, (unsigned)(first + c + 1));
      }
    }
    row = __reduce_min_sync(0xffffffffu, row);
  }
  return row;
}

__global__ void __launch_bounds__(E1_EPILOGUE_THREADS)
e1_epilogue_kernel(const float* __restrict__ q,
                   const uint2* __restrict__ rows, int Q, int R,
                   u64* __restrict__ keys, float* __restrict__ d2_out,
                   int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (E1_EPILOGUE_THREADS / 32) + threadIdx.x / 32;
  if (qi >= Q) return;               // a whole warp
  const u64 key = keys[qi];
  const float x = q[3 * (size_t)qi], y = q[3 * (size_t)qi + 1],
              z = q[3 * (size_t)qi + 2];
  const uint32_t a = e1_a_word(q, qi, lane & 3);
  float best = INFINITY;
  unsigned row = 0xffffffffu;        // the lowest row that scores best
  if (key != KEY_EMPTY) {
    best = bits_score((unsigned)(key >> 32));
    const int first = (int)(key & 0xffffffffULL) * E1_KEY_TILE;
    const int n = min(E1_KEY_TILE, R - first);
    row = n == E1_KEY_TILE ? e1_rescore<false>(rows, a, best, first, n)
                           : e1_rescore<true>(rows, a, best, first, n);
  }
  if (lane == 0) {
    d2_out[qi] = fmaxf(__fadd_rn(best, norm2(x, y, z)), 0.f);
    idx_out[qi] = row == 0xffffffffu ? -1 : (int)row;
    keys[qi] = KEY_EMPTY;
  }
}

// ---------------------------------------------------------------------------
// E5 and E4: matmul-form 1-NN as (query tile x reference span) work items
// ---------------------------------------------------------------------------
//
// Three launches a call:
//   * mm_prelude_kernel: the extended reference rows (-2x, -2y, -2z,
//     |r|^2) and the queries' keys emptied.
//   * mm_items_kernel (pass 1): block (i, j) holds query tile i (512
//     queries, 4 a thread of a 128-thread group) and stages reference
//     span j (2048 rows, 32 KB) in shared memory by cp.async; each of the
//     4 groups scans its own 512 rows of the span, 3 FMAs and a min a
//     pair, and folds its minima into one key a query at every boundary
//     of a key tile (w rows; a row's key tile is row / w).  The groups'
//     keys meet in shared memory before one atomicMin a query.
//   * mm_epilogue_kernel (pass 2), a warp a query: the least key decoded
//     to (score, key tile), the tile scored again; E5's lowest tied row or
//     E4's averaged tied payload, d2 = max(score + |q|^2, 0), the key
//     emptied for the next call.
// E5's key tile is a group's 512 rows (a fold once an item); E4's is its
// own rb = _tile(R, 2048), which need not divide the span: a group's rows
// fold once for each key tile they cross (once at rb = 2048, every row at
// rb = 1).

#define ITEM_THREADS 512
#define ITEM_GROUP 128                     // threads holding a query tile
#define ITEM_GROUPS (ITEM_THREADS / ITEM_GROUP)
#define ITEM_QT (NN_QPT * ITEM_GROUP)      // 512 queries a tile
#define ITEM_ROWS 512                      // rows a group scans of a span
#define ITEM_SPAN (ITEM_GROUPS * ITEM_ROWS)  // 2048 rows a span
#define MM_PRELUDE_THREADS 256
#define MM_EPILOGUE_THREADS 256
static_assert(ITEM_QT == ITEM_THREADS, "the merge takes a query a thread");

__global__ void __launch_bounds__(MM_PRELUDE_THREADS)
mm_prelude_kernel(const float* __restrict__ ref, int Q, int R,
                  float4* __restrict__ r_ext, u64* __restrict__ keys) {
  const int k = blockIdx.x * MM_PRELUDE_THREADS + threadIdx.x;
  if (k < R) {
    const float x = ref[3 * (size_t)k], y = ref[3 * (size_t)k + 1],
                z = ref[3 * (size_t)k + 2];
    r_ext[k] = make_float4(-2.f * x, -2.f * y, -2.f * z, norm2(x, y, z));
  }
  if (k < Q) keys[k] = KEY_EMPTY;
}

__global__ void __launch_bounds__(ITEM_THREADS, 2)
mm_items_kernel(const float* __restrict__ q, const float4* __restrict__ r_ext,
                int Q, int R, int w, int n_qt, u64* keys) {
  __shared__ float4 s_r[ITEM_SPAN];
  __shared__ u64 s_key[ITEM_GROUPS][ITEM_QT];
  const int t = threadIdx.x;
  const int group = t / ITEM_GROUP;
  const int lane = t % ITEM_GROUP;
  const int i = blockIdx.x % n_qt;
  const int j = blockIdx.x / n_qt;
  const int first = j * ITEM_SPAN;
  const int n = min(ITEM_SPAN, R - first);
  const float4* src = r_ext + first;
  for (int k = t; k < n; k += ITEM_THREADS) cp_async16(s_r + k, src + k);
  cp_async_commit();
  const int q0 = i * ITEM_QT;
  float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT];
  u64 key[NN_QPT];
#pragma unroll
  for (int u = 0; u < NN_QPT; ++u) {
    const size_t qi = min(q0 + lane + u * ITEM_GROUP, Q - 1);
    qx[u] = q[3 * qi];
    qy[u] = q[3 * qi + 1];
    qz[u] = q[3 * qi + 2];
    key[u] = KEY_EMPTY;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int end = min((group + 1) * ITEM_ROWS, n);
  for (int k0 = group * ITEM_ROWS; k0 < end;) {
    const int tile = (first + k0) / w;           // rows [k0, k1): one tile
    const int k1 = min(end, (tile + 1) * w - first);
    float mn[NN_QPT];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) mn[u] = INFINITY;
    // Unrolled 16 deep, so the loop's own count and branch add little to
    // the 4 instructions a pair.
#pragma unroll 16
    for (int k = k0; k < k1; ++k) {
      const float4 r = s_r[k];
#pragma unroll
      for (int u = 0; u < NN_QPT; ++u)
        mn[u] = fminf(mn[u], mm_score(qx[u], qy[u], qz[u], r));
    }
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const u64 c = score_key(mn[u], (unsigned)tile);
      key[u] = c < key[u] ? c : key[u];
    }
    k0 = k1;
  }
#pragma unroll
  for (int u = 0; u < NN_QPT; ++u) s_key[group][lane + u * ITEM_GROUP] = key[u];
  __syncthreads();
  if (q0 + t < Q) {                  // ITEM_QT == ITEM_THREADS: a query each
    u64 v = s_key[0][t];
#pragma unroll
    for (int g = 1; g < ITEM_GROUPS; ++g) v = s_key[g][t] < v ? s_key[g][t] : v;
    if (v != KEY_EMPTY) atomicMin(keys + q0 + t, v);
  }
}

template <bool PAYLOAD>
__global__ void __launch_bounds__(MM_EPILOGUE_THREADS)
mm_epilogue_kernel(const float* __restrict__ q,
                   const float4* __restrict__ r_ext,
                   const float* __restrict__ pay, int Q, int R, int P, int w,
                   u64* __restrict__ keys, float* __restrict__ d2_out,
                   int* __restrict__ idx_out, float* __restrict__ pay_out) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (MM_EPILOGUE_THREADS / 32) + threadIdx.x / 32;
  if (qi >= Q) return;
  const u64 key = keys[qi];
  const float x = q[3 * (size_t)qi], y = q[3 * (size_t)qi + 1],
              z = q[3 * (size_t)qi + 2];
  float best = INFINITY;
  float sum[MAX_PAYLOAD];
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) sum[p] = 0.f;
  int count = 0;
  unsigned row = 0xffffffffu;        // E5: the lowest tied row
  if (key != KEY_EMPTY) {
    best = bits_score((unsigned)(key >> 32));
    const int tile = (int)(key & 0xffffffffULL);
    const size_t first = (size_t)tile * w;
    const int n = min(w, R - tile * w);
    if (PAYLOAD) {
      count = tied_payload(x, y, z, best, r_ext, first, n, nullptr, pay, P,
                           sum);
    } else {
      for (int k = lane; k < n; k += 32)
        if (mm_score(x, y, z, r_ext[first + k]) == best)
          row = min(row, (unsigned)(first + k));
      row = __reduce_min_sync(0xffffffffu, row);
    }
  }
  if (lane == 0) {
    d2_out[qi] = fmaxf(__fadd_rn(best, norm2(x, y, z)), 0.f);
    if (PAYLOAD) {
      const float c = (float)max(count, 1);
      for (int p = 0; p < P; ++p)
        pay_out[(size_t)qi * P + p] = __fdiv_rn(sum[p], c);
    } else {
      idx_out[qi] = row == 0xffffffffu ? 0 : (int)row;
    }
    keys[qi] = KEY_EMPTY;
  }
}

// ---------------------------------------------------------------------------
// E6: Morton-sorted, box-pruned payload 1-NN as (query tile x reference
// tile) work items
// ---------------------------------------------------------------------------
//
// The Pallas kernel walks the reference tiles of one query tile in its
// rotated visit order, (j + i*nj/ni) % nj, and skips a tile whose box
// bound reaches the tile's largest best (pallas_payload_variants.py:
// 322-362).  Here every (query tile i, reference tile) pair is a work item
// of a persistent grid, and the walk's sequential state becomes one merge
// key a query:
//   * Pass 1 (e6_items_kernel) computes each query's least score over the
//     item's tile (3 FMAs and a min a pair; no index) and lowers the key
//     (orderable score bits) << 32 | rank with atomicMin, where rank is
//     the tile's place in query tile i's rotated visit order.  The least
//     key is the least score with ties to the first tile in visit order:
//     E6's rule across tiles, whatever order the items run in.  -0 is
//     made +0 first, so scores that compare equal get one key.
//   * Before it scans, an item reads the merged keys of its query tile and
//     skips when its bound reaches their largest (score + |q|^2), as the
//     Pallas kernel compares its running bests.  A merged best is a real
//     score of a scanned row, never below the final one, so a skipped tile
//     holds no better score beyond rounding.  Items start rank-major, each
//     query tile's tiles in ascending bound (nj <= the block's threads;
//     else in the visit order), so the nearest tiles publish first.  Which
//     tiles are scanned depends on block timing; the results do not.
//   * Pass 2 (e6_epilogue_kernel), a warp a query, decodes the key,
//     scores the winning tile again with the same FMAs (the same bits),
//     averages the payload rows that tie with the least (__fdiv_rn, as
//     E4), and writes d2 and the payload at the caller's row.
// The set-up runs on the card as well: e6_morton_kernel (a cluster of 16
// blocks a cloud: the bounds meet in distributed shared memory, then the
// codes, then a bitonic sort of (code, row) keys in the cluster's shared
// memory; torch.sort of the codes instead for a cloud of more than
// 131072 points) and e6_gather_kernel (sorted queries with |q|^2, sorted
// extended reference rows, both clouds' tile boxes, the keys set to
// empty): with the two passes, four launches a call.

#define E6_THREADS 512
#define E6_GROUP 64                  // threads holding a query tile
#define E6_GROUPS (E6_THREADS / E6_GROUP)
#define E6_QT (NN_QPT * E6_GROUP)    // 256: the largest query tile
#define E6_RB 1024                   // the largest reference tile
#define E6_BLOCKS_PER_SM 2
#define E6_MORTON_CLUSTER 16           // blocks a cloud (non-portable)
#define E6_MORTON_THREADS 1024
#define E6_SORT_KPT 8                // sort keys a thread at most
#define E6_GATHER_THREADS 256
#define E6_EPILOGUE_THREADS 256
#define E6_PARKED 1.0e5f

// Squared gap between two boxes (min xyz, max xyz), summed (gx^2 + gy^2)
// + gz^2: at most every pair distance between them.
__device__ __forceinline__ float box_gap2(const float* a, const float* b) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(fmaxf(__fsub_rn(a[d], b[3 + d]), __fsub_rn(b[d], a[3 + d])),
                 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

__device__ __forceinline__ int visit_start(int i, int ni, int nj) {
  return (int)(((long long)i * nj) / ni);
}

__device__ __forceinline__ bool unparked(float x, float y, float z) {
  return fabsf(x) < E6_PARKED && fabsf(y) < E6_PARKED && fabsf(z) < E6_PARKED;
}

// Min (d < 3) or max (d >= 3) of v[d] over the block; thread 0 gets it.
template <int NT>
__device__ __forceinline__ void block_box(float (&v)[6], float (*s)[NT / 32]) {
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[d], off);
      v[d] = d < 3 ? fminf(v[d], o) : fmaxf(v[d], o);
    }
    if ((threadIdx.x & 31) == 0) s[d][threadIdx.x >> 5] = v[d];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < 6; ++d)
      for (int w = 1; w < NT / 32; ++w)
        v[d] = d < 3 ? fminf(v[d], s[d][w]) : fmaxf(v[d], s[d][w]);
  }
}

// E6's Morton code of point k: clip((p - lo) * inv * 1023, 0, 1023) a
// coordinate, spread into 30 bits; parked rows 2^30.
__device__ __forceinline__ unsigned morton_code(const float* __restrict__ p,
                                                int k, const float (&lo)[3],
                                                const float (&inv)[3]) {
  const float c[3] = {p[3 * (size_t)k], p[3 * (size_t)k + 1],
                      p[3 * (size_t)k + 2]};
  if (!unparked(c[0], c[1], c[2])) return 1u << 30;
  unsigned u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    u[d] = (unsigned)(int)fminf(
        fmaxf(__fmul_rn(__fmul_rn(__fsub_rn(c[d], lo[d]), inv[d]), 1023.f),
              0.f),
        1023.f);
  return spread_bits10(u[0]) | (spread_bits10(u[1]) << 1) |
         (spread_bits10(u[2]) << 2);
}

// One cluster's bitonic sort of its cloud's (code << 32 | row) keys, E
// keys a thread in registers (k[e] at position pos0 + e; the block holds
// positions [base, base + m) of P = 16m): pairs within a thread meet in
// registers, within a warp by shuffles, across warps in the block's
// shared memory, across blocks through the partner block's shared memory
// (both blocks read each other's keys between two cluster barriers).
template <int E>
__device__ __forceinline__ void cluster_sort(cg::cluster_group& cluster,
                                             u64* s_keys, u64 (&k)[E],
                                             int m, int base, int pos0) {
  const int t = threadIdx.x;
  const bool holds = t * E < m;
  const int P = E6_MORTON_CLUSTER * m;
  const int lim = min(32 * E, m);    // strides from here on: shared memory
  const int part = (int)cluster.block_rank();
  for (int size = 2; size <= P; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= m; stride >>= 1) {        // across blocks
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (holds) s_keys[t * E + e] = k[e];
      cluster.sync();
      const u64* other =
          cluster.map_shared_rank(&s_keys[0], part ^ (stride / m));
      const bool keep_min = ((base & stride) == 0) == ((base & size) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (holds) {
          const u64 o = other[t * E + e];
          k[e] = keep_min ? (o < k[e] ? o : k[e]) : (o > k[e] ? o : k[e]);
        }
      }
      cluster.sync();                // the partner has read this block
    }
    if (stride >= lim) {                       // across warps
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (holds) s_keys[t * E + e] = k[e];
      for (; stride >= lim; stride >>= 1) {
        __syncthreads();
        for (int x = t; x < m / 2; x += E6_MORTON_THREADS) {
          const int i = ((x & ~(stride - 1)) << 1) | (x & (stride - 1));
          const int j = i + stride;
          const u64 a = s_keys[i], b = s_keys[j];
          if ((a > b) == (((base + i) & size) == 0)) {
            s_keys[i] = b;
            s_keys[j] = a;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (holds) k[e] = s_keys[t * E + e];
      __syncthreads();               // read before the next store
    }
    for (; stride >= E; stride >>= 1) {        // across lanes
      const bool keep_min = ((pos0 & stride) == 0) == ((pos0 & size) == 0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 o = __shfl_xor_sync(0xffffffffu, k[e], stride / E);
        k[e] = keep_min ? (o < k[e] ? o : k[e]) : (o > k[e] ? o : k[e]);
      }
    }
    for (; stride > 0; stride >>= 1) {        // within a thread
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

// Codes and sort of one cloud for cluster_sort<E>; the sorted rows go to
// out[0, n).
template <int E>
__device__ __forceinline__ void code_and_sort(cg::cluster_group& cluster,
                                              u64* s_keys,
                                              const float* __restrict__ p,
                                              int n, int m,
                                              const float (&lo)[3],
                                              const float (&inv)[3],
                                              int* __restrict__ out) {
  const int base = (int)cluster.block_rank() * m;
  const int pos0 = base + (int)threadIdx.x * E;
  const bool holds = (int)threadIdx.x * E < m;
  u64 k[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    k[e] = ~0ULL;
    if (holds && pos0 + e < n)
      k[e] = ((u64)morton_code(p, pos0 + e, lo, inv) << 32) |
             (unsigned)(pos0 + e);
  }
  cluster_sort<E>(cluster, s_keys, k, m, base, pos0);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (holds && pos0 + e < n)
      out[pos0 + e] = (int)(unsigned)(k[e] & 0xffffffffULL);
}

// E6's Morton codes (nn_variants.morton_order) and the stable sort by
// them.  Blocks 0-15 take the queries, 16-31 the reference; a cloud's 16
// blocks form a cluster.  Bounds: each block reduces a sixteenth of its
// cloud over the unparked rows and the blocks read each other's partial
// bounds from shared memory.  With perm, the cluster then sorts its cloud
// by (code << 32 | row) keys, which is the stable order since the row
// breaks ties, in a bitonic network over P = 16m >= n positions (padding
// ~0 sorts last; cluster_sort), and perm[Q + R] receives the sorted rows:
// queries, then the reference.  Without perm (a cloud too large for the
// cluster) the kernel writes codes[Q + R] for torch.sort instead: query
// codes - 2^31 (negative), then reference codes, so one stable sort
// orders each cloud and keeps the queries first.
__global__ void __launch_bounds__(E6_MORTON_THREADS)
e6_morton_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                 int Q, int R, int m_q, int m_r, int* __restrict__ codes,
                 int* __restrict__ perm) {
  extern __shared__ u64 s_keys[];    // m keys (perm only)
  __shared__ float s_part[6];
  __shared__ float s_all[E6_MORTON_CLUSTER][6];
  __shared__ float s_warp[6][E6_MORTON_THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const bool is_q = blockIdx.x < E6_MORTON_CLUSTER;
  const float* p = is_q ? q : ref;
  const int n = is_q ? Q : R;
  const int k0 = (int)((long long)n * part / E6_MORTON_CLUSTER);
  const int k1 = (int)((long long)n * (part + 1) / E6_MORTON_CLUSTER);
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                -INFINITY};
  for (int k = k0 + threadIdx.x; k < k1; k += E6_MORTON_THREADS) {
    const float x = p[3 * (size_t)k], y = p[3 * (size_t)k + 1],
                z = p[3 * (size_t)k + 2];
    if (unparked(x, y, z)) {
      v[0] = fminf(v[0], x);
      v[1] = fminf(v[1], y);
      v[2] = fminf(v[2], z);
      v[3] = fmaxf(v[3], x);
      v[4] = fmaxf(v[4], y);
      v[5] = fmaxf(v[5], z);
    }
  }
  block_box<E6_MORTON_THREADS>(v, s_warp);
  if (threadIdx.x == 0)
    for (int d = 0; d < 6; ++d) s_part[d] = v[d];
  cluster.sync();
  if (threadIdx.x < 6 * E6_MORTON_CLUSTER) {
    const int b = threadIdx.x / 6, d = threadIdx.x % 6;
    s_all[b][d] = cluster.map_shared_rank(&s_part[0], b)[d];
  }
  cluster.sync();                    // no block leaves while others read it
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int b = 0; b < E6_MORTON_CLUSTER; ++b) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], s_all[b][d]);
      hi[d] = fmaxf(hi[d], s_all[b][3 + d]);
    }
  }
  float inv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    inv[d] = __fdiv_rn(1.f, fmaxf(__fsub_rn(hi[d], lo[d]), 1e-6f));
  if (perm == nullptr) {
    for (int k = k0 + threadIdx.x; k < k1; k += E6_MORTON_THREADS) {
      const unsigned code = morton_code(p, k, lo, inv);
      codes[is_q ? k : Q + k] = is_q ? (int)(code | 0x80000000u) : (int)code;
    }
    return;
  }
  const int m = is_q ? m_q : m_r;
  int* out = perm + (is_q ? 0 : Q);
  switch (m / E6_MORTON_THREADS) {   // keys a thread; uniform in a cluster
    case 8: code_and_sort<8>(cluster, s_keys, p, n, m, lo, inv, out); break;
    case 4: code_and_sort<4>(cluster, s_keys, p, n, m, lo, inv, out); break;
    case 2: code_and_sort<2>(cluster, s_keys, p, n, m, lo, inv, out); break;
    default: code_and_sort<1>(cluster, s_keys, p, n, m, lo, inv, out); break;
  }
}

// After the sort (perm[Q + R]: sorted rank -> row, the queries' Q, then
// the reference's R): block b < ni gathers query tile b (x, y, z, |q|^2)
// and its box and empties its keys; block ni + t gathers reference tile t
// as extended rows (-2x, -2y, -2z, |r|^2) and its box.  Boxes cover
// parked rows too, as tile_boxes.
__global__ void __launch_bounds__(E6_GATHER_THREADS)
e6_gather_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                 const int* __restrict__ perm, int Q, int qb, int rb,
                 int ni, float4* __restrict__ q4, float4* __restrict__ r_ext,
                 float* __restrict__ q_boxes, float* __restrict__ r_boxes,
                 u64* __restrict__ keys, u64* __restrict__ counter,
                 int* __restrict__ visits) {
  __shared__ float s_warp[6][E6_GATHER_THREADS / 32];
  const bool is_q = blockIdx.x < ni;
  const int tile = is_q ? blockIdx.x : blockIdx.x - ni;
  const int n = is_q ? qb : rb;
  const size_t first = (size_t)tile * n;
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                -INFINITY};
  for (int k = threadIdx.x; k < n; k += E6_GATHER_THREADS) {
    const size_t s = first + k;
    const float* p = (is_q ? q : ref) + 3 * (size_t)perm[is_q ? s : Q + s];
    const float x = p[0], y = p[1], z = p[2];
    v[0] = fminf(v[0], x);
    v[1] = fminf(v[1], y);
    v[2] = fminf(v[2], z);
    v[3] = fmaxf(v[3], x);
    v[4] = fmaxf(v[4], y);
    v[5] = fmaxf(v[5], z);
    const float n2 = norm2(x, y, z);
    if (is_q) {
      q4[s] = make_float4(x, y, z, n2);
      keys[s] = KEY_EMPTY;
    } else {
      r_ext[s] = make_float4(-2.f * x, -2.f * y, -2.f * z, n2);
    }
  }
  block_box<E6_GATHER_THREADS>(v, s_warp);
  if (threadIdx.x == 0) {
    float* box = (is_q ? q_boxes : r_boxes) + 6 * (size_t)tile;
    for (int d = 0; d < 6; ++d) box[d] = v[d];
    if (is_q) visits[tile] = 0;
    if (blockIdx.x == 0) *counter = 0;
  }
}

// Pass 1.  Items are numbered rank-major (item = j * ni + i) and taken from
// *counter.  64 threads hold the query tile (4 queries each); group g of
// the 8 scans every 8th row of the staged reference tile, and the groups'
// minima meet in shared memory before one atomicMin a query.
__global__ void __launch_bounds__(E6_THREADS, E6_BLOCKS_PER_SM)
e6_items_kernel(const float4* __restrict__ q4,
                const float4* __restrict__ r_ext,
                const float* __restrict__ q_boxes,
                const float* __restrict__ r_boxes, int qb, int rb, int ni,
                int nj, u64* keys, u64* counter, int* __restrict__ visits) {
  __shared__ float4 s_r[E6_RB];
  __shared__ float s_min[E6_GROUPS][E6_QT];
  __shared__ float s_lb[E6_THREADS];
  __shared__ float s_warp[E6_THREADS / 32];
  __shared__ int s_item, s_tile;
  const int t = threadIdx.x;
  const int group = t / E6_GROUP;
  const int lane = t % E6_GROUP;
  const int n_items = ni * nj;
  const bool by_bound = nj <= E6_THREADS;

  for (;;) {
    __syncthreads();                 // the last item's shared state is free
    if (t == 0) {
      const u64 taken = atomicAdd(counter, 1ULL);
      s_item = taken < (u64)n_items ? (int)taken : n_items;
    }
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) return;
    const int i = item % ni;
    const int j = item / ni;
    const int start = visit_start(i, ni, nj);
    const float* qbox = q_boxes + 6 * (size_t)i;
    int tile;
    float lb;
    if (by_bound) {                  // the tile of bound rank j
      if (t < nj) s_lb[t] = box_gap2(qbox, r_boxes + 6 * (size_t)t);
      __syncthreads();
      if (t < nj) {
        const float mine = s_lb[t];
        int rank = 0;
        for (int k = 0; k < nj; ++k) {
          const float o = s_lb[k];
          rank += (o < mine) || (o == mine && k < t);
        }
        if (rank == j) s_tile = t;
      }
      __syncthreads();
      tile = s_tile;
      lb = s_lb[tile];
    } else {
      tile = (j + start) % nj;
      lb = box_gap2(qbox, r_boxes + 6 * (size_t)tile);
    }

    const size_t q0 = (size_t)i * qb;
    float m = -INFINITY;
    for (int s = t; s < qb; s += E6_THREADS) {
      const u64 key = __ldcg(keys + q0 + s);
      m = fmaxf(m, key == KEY_EMPTY
                       ? INFINITY
                       : __fadd_rn(bits_score((unsigned)(key >> 32)),
                                   q4[q0 + s].w));
    }
    m = block_max<E6_THREADS>(m, s_warp);
    if (!(lb < m)) continue;
    if (t == 0) atomicAdd(visits + i, 1);

    const float4* src = r_ext + (size_t)tile * rb;
    for (int k = t; k < rb; k += E6_THREADS) cp_async16(s_r + k, src + k);
    cp_async_commit();
    float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT], mn[NN_QPT];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const float4 qq = q4[q0 + min(lane + u * E6_GROUP, qb - 1)];
      qx[u] = qq.x;
      qy[u] = qq.y;
      qz[u] = qq.z;
      mn[u] = INFINITY;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int k = group; k < rb; k += E6_GROUPS) {
      const float4 r = s_r[k];
#pragma unroll
      for (int u = 0; u < NN_QPT; ++u)
        mn[u] = fminf(mn[u], mm_score(qx[u], qy[u], qz[u], r));
    }
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) s_min[group][lane + u * E6_GROUP] = mn[u];
    __syncthreads();
    if (t < qb) {
      float v = s_min[0][t];
#pragma unroll
      for (int g = 1; g < E6_GROUPS; ++g) v = fminf(v, s_min[g][t]);
      const unsigned rank = (unsigned)((tile - start + nj) % nj);
      atomicMin(keys + q0 + t, score_key(v, rank));
    }
  }
}

// Pass 2, a warp a sorted query s: the winning tile's rows that tie with
// the least score, their payloads averaged, written at row perm[s].  It
// leaves the keys empty and the item counter at 0, so the items can run
// again on the same tables.
__global__ void __launch_bounds__(E6_EPILOGUE_THREADS)
e6_epilogue_kernel(const float4* __restrict__ q4,
                   const float4* __restrict__ r_ext,
                   const int* __restrict__ perm,
                   const float* __restrict__ pay, int Q, int P, int qb,
                   int rb, int ni, int nj, u64* __restrict__ keys,
                   u64* __restrict__ counter, float* __restrict__ d2_out,
                   float* __restrict__ pay_out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (E6_EPILOGUE_THREADS / 32) + threadIdx.x / 32;
  if (blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
  if (s >= Q) return;
  const u64 key = keys[s];
  const size_t row = perm[s];
  const float4 q = q4[s];
  float sum[MAX_PAYLOAD];
#pragma unroll
  for (int p = 0; p < MAX_PAYLOAD; ++p) sum[p] = 0.f;
  int count = 0;
  float best = INFINITY;
  if (key != KEY_EMPTY) {
    best = bits_score((unsigned)(key >> 32));
    const int i = s / qb;
    const int tile =
        (int)((key & 0xffffffffULL) + (u64)visit_start(i, ni, nj)) % nj;
    count = tied_payload(q.x, q.y, q.z, best, r_ext, (size_t)tile * rb, rb,
                         perm + Q, pay, P, sum);
  }
  if (lane == 0) {
    d2_out[row] = fmaxf(__fadd_rn(best, q.w), 0.f);
    const float c = (float)max(count, 1);
    for (int p = 0; p < P; ++p)
      pay_out[row * P + p] = __fdiv_rn(sum[p], c);
    keys[s] = KEY_EMPTY;
  }
}

// ---------------------------------------------------------------------------
// E2 / E3: K1's exact 1-NN at a chosen tile shape
// ---------------------------------------------------------------------------
//
// K1's item design (csrc/nn.cu) with the sweep's tile as the work item: a
// block takes (query tile i of qb queries, reference tile j of rb points)
// and stages the whole reference tile in shared memory (16-byte rows from
// cp.async, a chunk of groups * 128 points at a time, two chunks ahead of
// the scan), so rb is bounded by one block's shared memory as the TPU
// sweep's tile is by VMEM.  gt threads (a power of two, 32-256) hold up
// to 4 * gt queries, 4 a thread; the block's NT / gt groups each scan
// their own 128-point span of every chunk.  A query tile larger than
// 4 * gt (qb > 1024) takes several passes over the staged tile.  Each
// thread lowers its queries' keys (d2 bits << 32 | idx) with atomicMin
// once a pass, and nn_unpack_kernel splits them: d2 bit-equal to K1's
// and to nn_kernels.nn_indices_plain, ties to the lowest index.

#define TL_MAX_GT 256

template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
nn_tile_items_kernel(const float* __restrict__ q,
                     const float* __restrict__ ref, int Q, int R, int qb,
                     int rb, int nQt, int gt, u64* keys) {
  extern __shared__ float4 tile[];      // min(rb, R) rows
  const int t = threadIdx.x;
  const int group = t / gt;
  const int lane = t % gt;
  const int chunk = (NT / gt) * NN_SPAN;
  const int i = blockIdx.x % nQt;
  const int j = blockIdx.x / nQt;
  const int first = j * rb;
  const int n = min(rb, R - first);
  const int nchunks = (n + chunk - 1) / chunk;
#pragma unroll
  for (int s = 0; s < NN_STAGES - 1; ++s) {
    if (s < nchunks)
      stage_chunk<NT>(tile + s * chunk, ref, (size_t)first + s * chunk,
                      min(chunk, n - s * chunk));
    cp_async_commit();
  }
  const int q_first = i * qb;
  const int q_n = min(qb, Q - q_first);
  for (int p0 = 0; p0 < q_n; p0 += NN_QPT * gt) {
    float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT], best[NN_QPT], published[NN_QPT];
    int qi[NN_QPT], best_i[NN_QPT];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const int slot = p0 + lane + u * gt;
      qi[u] = slot < q_n ? q_first + slot : Q;   // Q: no query
      const size_t row = 3 * (size_t)(qi[u] < Q ? qi[u] : 0);
      qx[u] = q[row];
      qy[u] = q[row + 1];
      qz[u] = q[row + 2];
      best[u] = INFINITY;
      published[u] = INFINITY;
      best_i[u] = 0;
    }
    for (int c = 0; c < nchunks; ++c) {
      if (p0 == 0) {                      // the first pass stages the tile
        cp_async_wait<NN_STAGES - 2>();   // chunk c has landed (this thread)
        __syncthreads();                  // ... for every thread
        const int ahead = c + NN_STAGES - 1;
        if (ahead < nchunks)
          stage_chunk<NT>(tile + ahead * chunk, ref,
                          (size_t)first + ahead * chunk,
                          min(chunk, n - ahead * chunk));
        cp_async_commit();
      }
      const int off = c * chunk + group * NN_SPAN;
      scan_span(tile + off, min(NN_SPAN, n - off), first + off, qx, qy, qz,
                best, best_i);
    }
    publish(keys, qi, Q, best, best_i, published);
  }
  cp_async_wait<0>();
}

// (threads that hold a pass's queries, block threads) for a qb-query tile:
// 4 queries a thread, at least a warp, at most 256; 512-thread blocks
// where a tile of more than 4096 points lets only one block on an SM.
static void tile_layout(int qb, int rb, int* gt, int* nt) {
  int g = 32;
  while (g < TL_MAX_GT && g * NN_QPT < qb) g *= 2;
  *gt = g;
  *nt = rb > 4096 ? 512 : 256;
}

template <int NT>
static int launch_tile_items(const float* q, const float* ref, int Q, int R,
                             int qb, int rb, int gt, u64* keys,
                             cudaStream_t stream) {
  const int smem = 16 * min(rb, R);
  cudaError_t err = cudaFuncSetAttribute(
      nn_tile_items_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int nQt = (Q + qb - 1) / qb;
  const int items = nQt * ((R + rb - 1) / rb);
  nn_tile_items_kernel<NT><<<items, NT, smem, stream>>>(q, ref, Q, R, qb, rb,
                                                        nQt, gt, keys);
  return (int)cudaGetLastError();
}

extern "C" {

// E1 set-up: rows [R8] (uint2, R8 = R rounded up to 8), the packed bf16
// B fragment words of ref [R,3], and keys [Q] emptied.
int lsl_e1_setup(const float* ref, int Q, int R, int R8, void* rows,
                 u64* keys, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1 || R8 != ((R + 7) & ~7))
    return (int)cudaErrorInvalidValue;
  const int n = max(Q, R8);
  e1_prelude_kernel<<<(n + E1_PRELUDE_THREADS - 1) / E1_PRELUDE_THREADS,
                      E1_PRELUDE_THREADS, 0, (cudaStream_t)stream>>>(
      ref, Q, R, R8, (uint2*)rows, keys);
  return (int)cudaGetLastError();
}

// E1's two passes on the tables of lsl_e1_setup: d2_out [Q], idx_out [Q]
// (the lowest index of the least score; -1 where the second scoring did
// not reproduce the key's score).  The keys are left empty.
int lsl_e1_indices(const float* q, const void* rows, int Q, int R,
                   u64* keys, float* d2_out, int* idx_out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint2* r2 = (const uint2*)rows;
  const int n_qt = (Q + E1_QT - 1) / E1_QT;
  const int items = n_qt * ((R + E1_SPAN - 1) / E1_SPAN);
  e1_items_kernel<<<items, E1_THREADS, 0, s>>>(q, r2, Q, R, n_qt, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = E1_EPILOGUE_THREADS / 32;
  e1_epilogue_kernel<<<(Q + per_block - 1) / per_block, E1_EPILOGUE_THREADS,
                       0, s>>>(q, r2, Q, R, keys, d2_out, idx_out);
  return (int)cudaGetLastError();
}

// E4/E5 set-up: the extended rows r_ext [R] (float4) of ref [R,3], and
// keys [Q] emptied.
int lsl_mm_setup(const float* ref, int Q, int R, float* r_ext, u64* keys,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int n = max(Q, R);
  mm_prelude_kernel<<<(n + MM_PRELUDE_THREADS - 1) / MM_PRELUDE_THREADS,
                      MM_PRELUDE_THREADS, 0, (cudaStream_t)stream>>>(
      ref, Q, R, (float4*)r_ext, keys);
  return (int)cudaGetLastError();
}

// E4/E5's two passes on the tables of lsl_mm_setup, with key tiles of w
// rows: E5 (pay == nullptr) writes idx_out, E4 pay_out [Q,P].
static int launch_mm(const float* q, const float* r_ext, const float* pay,
                     int Q, int R, int P, int w, u64* keys, float* d2_out,
                     int* idx_out, float* pay_out, cudaStream_t s) {
  const int n_qt = (Q + ITEM_QT - 1) / ITEM_QT;
  const int items = n_qt * ((R + ITEM_SPAN - 1) / ITEM_SPAN);
  const float4* r4 = (const float4*)r_ext;
  mm_items_kernel<<<items, ITEM_THREADS, 0, s>>>(q, r4, Q, R, w, n_qt, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = MM_EPILOGUE_THREADS / 32;
  const int blocks = (Q + per_block - 1) / per_block;
  if (pay == nullptr)
    mm_epilogue_kernel<false><<<blocks, MM_EPILOGUE_THREADS, 0, s>>>(
        q, r4, pay, Q, R, P, w, keys, d2_out, idx_out, pay_out);
  else
    mm_epilogue_kernel<true><<<blocks, MM_EPILOGUE_THREADS, 0, s>>>(
        q, r4, pay, Q, R, P, w, keys, d2_out, idx_out, pay_out);
  return (int)cudaGetLastError();
}

// E5: d2_out [Q], idx_out [Q] (the lowest index of the least score).
int lsl_mm_indices(const float* q, const float* r_ext, int Q, int R,
                   u64* keys, float* d2_out, int* idx_out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1) return (int)cudaErrorInvalidValue;
  return launch_mm(q, r_ext, nullptr, Q, R, 0, ITEM_ROWS, keys, d2_out,
                   idx_out, nullptr, (cudaStream_t)stream);
}

// E4: d2_out [Q], pay_out [Q,P], tied rows of the winning rb-row tile
// averaged.
int lsl_mm_payload(const float* q, const float* r_ext, const float* pay,
                   int Q, int R, int P, int rb, u64* keys, float* d2_out,
                   float* pay_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1 || P < 1 || P > MAX_PAYLOAD || rb < 1 || R % rb)
    return (int)cudaErrorInvalidValue;
  return launch_mm(q, r_ext, pay, Q, R, P, rb, keys, d2_out, nullptr,
                   pay_out, (cudaStream_t)stream);
}

// E6 set-up, first half: with perm, both clouds sorted by their codes
// (perm[Q + R]: the sorted query rows, then the sorted reference rows;
// m_q, m_r: keys a block, powers of two with 8 m >= the cloud);
// without, codes[Q + R] for one stable sort.
int lsl_e6_morton(const float* q, const float* ref, int Q, int R, int m_q,
                  int m_r, int* codes, int* perm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || R < 1 ||
      (perm != nullptr &&
       ((long long)E6_MORTON_CLUSTER * m_q < Q ||
        (long long)E6_MORTON_CLUSTER * m_r < R || (m_q & (m_q - 1)) ||
        (m_r & (m_r - 1)) || m_q < 1 || m_r < 1 ||
        max(m_q, m_r) > E6_SORT_KPT * E6_MORTON_THREADS)))
    return (int)cudaErrorInvalidValue;
  const int smem = perm != nullptr ? (int)sizeof(u64) * max(m_q, m_r) : 0;
  err = cudaFuncSetAttribute(e6_morton_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(e6_morton_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * E6_MORTON_CLUSTER);
  cfg.blockDim = dim3(E6_MORTON_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = E6_MORTON_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, e6_morton_kernel, q, ref, Q, R, m_q, m_r,
                           codes, perm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// E6 set-up, second half, after the sort: q4 [Q] and r_ext [R] float4,
// q_boxes [ni,6], r_boxes [nj,6]; keys [Q] emptied, *counter and
// visits [ni] zeroed.
int lsl_e6_gather(const float* q, const float* ref, const int* perm,
                  int Q, int R, int qb, int rb, float* q4, float* r_ext,
                  float* q_boxes, float* r_boxes, u64* keys, u64* counter,
                  int* visits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (qb < 1 || qb > E6_QT || rb < 1 || rb > E6_RB || Q % qb || R % rb)
    return (int)cudaErrorInvalidValue;
  const int ni = Q / qb;
  e6_gather_kernel<<<ni + R / rb, E6_GATHER_THREADS, 0,
                     (cudaStream_t)stream>>>(
      q, ref, perm, Q, qb, rb, ni, (float4*)q4, (float4*)r_ext, q_boxes,
      r_boxes, keys, counter, visits);
  return (int)cudaGetLastError();
}

// E6's two passes on the tables of lsl_e6_gather; d2_out [Q], pay_out
// [Q,P] at the caller's rows.  visits[i] gains the tiles that query tile i
// scanned.
int lsl_e6_pruned(const float* q4, const float* r_ext, const float* q_boxes,
                  const float* r_boxes, const int* perm,
                  const float* pay, int Q, int R, int P, int qb, int rb,
                  u64* keys, u64* counter, int* visits, float* d2_out,
                  float* pay_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 1 || P > MAX_PAYLOAD || qb < 1 || qb > E6_QT || rb < 1 ||
      rb > E6_RB || Q % qb || R % rb)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ni = Q / qb, nj = R / rb;
  const int grid = min(ni * nj, E6_BLOCKS_PER_SM * n_sm);
  e6_items_kernel<<<grid, E6_THREADS, 0, s>>>(
      (const float4*)q4, (const float4*)r_ext, q_boxes, r_boxes, qb, rb, ni,
      nj, keys, counter, visits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = E6_EPILOGUE_THREADS / 32;
  e6_epilogue_kernel<<<(Q + per_block - 1) / per_block, E6_EPILOGUE_THREADS,
                       0, s>>>((const float4*)q4, (const float4*)r_ext, perm,
                               pay, Q, P, qb, rb, ni, nj, keys, counter,
                               d2_out, pay_out);
  return (int)cudaGetLastError();
}

// E2/E3.  keys: Q + 1 entries filled with NN_INIT_KEY.
int lsl_nn_tiled(const float* q, const float* ref, int Q, int R, int qb,
                 int rb, u64* keys, float* d2_out, int* idx_out, int device,
                 void* stream) {
  if (!(qb >= 1 && qb <= 256) &&
      !(qb % 256 == 0 && (qb / 256 & (qb / 256 - 1)) == 0 && qb <= 8192))
    return (int)cudaErrorInvalidValue;
  if (rb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  int gt, nt;
  tile_layout(qb, rb, &gt, &nt);
  const int rc =
      nt == 512 ? launch_tile_items<512>(q, ref, Q, R, qb, rb, gt, keys, s)
                : launch_tile_items<256>(q, ref, Q, R, qb, rb, gt, keys, s);
  if (rc != 0) return rc;
  return (int)launch_unpack(keys, Q, nullptr, d2_out, idx_out, s);
}

}  // extern "C"
