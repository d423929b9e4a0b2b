// Point-to-plane Gauss-Newton steps of ICP, written for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded through ctypes (laser_slam_tpu_torch/ops/cuda_build.py); the
// Python wrappers (gn_sums, gn_update) and their plain twin
// (gn_stage_plain) live in laser_slam_tpu_torch/ops/icp.py.
//
// Replaces no Pallas kernel: the JAX package computes this stage with jnp
// ops (laser_slam_tpu/ops/icp.py _gauss_newton_step and the loop body
// around it).  In the port's plain torch the stage issued 165 launches an
// iteration (a cross product, a cat, a weight multiply, two bmm, the
// damped solve, se3.exp/compose/normalize, the differential checker and
// the freeze's wheres), which the host issued more slowly than the card
// ran them.  Here a GN step is two launches:
//
//   gn_sums_kernel    one block a (lane, chunk of GN_CHUNK points).  Per
//                     inlier point, in registers: p = T (x) (se3.apply's
//                     two-cross-product rotation), r = n.(p - q),
//                     J = [p x n, n]; the block writes 28 partial sums,
//                     the 21 upper entries of J^T J, the 6 of -J^T r and
//                     sum |r| (the weight is the trim's bool mask: 0 or
//                     1), to partial[lane, chunk, 28].
//   gn_update_kernel  one warp a lane.  Folds the lane's chunks in
//                     order (in double), damps A by 1e-6 (1 + tr/6) on
//                     its diagonal as _solve_normal does, solves the 6x6
//                     system by Cholesky (A is SPD after damping; double),
//                     and updates the lane's loop state as
//                     gn_stage_plain does: the step gate, T <-
//                     normalize(exp(delta) T) with se3.exp's formulas,
//                     the differential checker's window, the error, the
//                     iteration count and done; on the last GN step of a
//                     match it applies the freeze of the loop state
//                     (lanes done at the iteration's start keep theirs).
//
// What bounds them: bytes.  A step reads p, q, n (36 B) and the mask byte
// of every point once: 38.8 MB for 256 lanes x 4096 points, 11.6 us at
// 3.35 TB/s.  The sums are about 50 FMAs a point, far below the f32 rate.
//
// Determinism.  The chunk count depends on N alone, never on the number
// of lanes, and every sum is taken in a fixed order (each thread over its
// points, a warp's xor butterfly, the warps in order, the chunks in
// order), with no atomics: a lane's result is bit-equal whatever batch it
// is in, and two calls are bit-equal.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of its launch.

#include <cuda_runtime.h>

#define GN_CHUNK 1024          // points a gn_sums_kernel block sums
#define GN_THREADS 256
#define GN_SUMS 28             // 21 of J^T J, 6 of -J^T r, sum |r|
#define GN_WARPS (GN_THREADS / 32)
#define GN_LANES_PER_BLOCK 4   // update: one warp a lane

// Index of (a, b), a <= b, in the row-major upper triangle of a 6x6.
__host__ __device__ constexpr int upper(int a, int b) {
  return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

// se3.quat_rotate: u = 2 qv x v; v + qw u + qv x u.
__device__ __forceinline__ void quat_rotate(float qw, float qx, float qy,
                                            float qz, const float v[3],
                                            float out[3]) {
  const float u0 = 2.f * (qy * v[2] - qz * v[1]);
  const float u1 = 2.f * (qz * v[0] - qx * v[2]);
  const float u2 = 2.f * (qx * v[1] - qy * v[0]);
  out[0] = v[0] + qw * u0 + (qy * u2 - qz * u1);
  out[1] = v[1] + qw * u1 + (qz * u0 - qx * u2);
  out[2] = v[2] + qw * u2 + (qx * u1 - qy * u0);
}

// ---------------------------------------------------------------------------
// The per-chunk sums
// ---------------------------------------------------------------------------

// pts, q, nrm: rows of 3 floats (coordinate stride 1); w: one byte a point
// (the inlier mask); T: a pose7 a lane.  Strides are in elements, the lane
// stride 0 for a reading without a lane axis.
__global__ void __launch_bounds__(GN_THREADS)
gn_sums_kernel(const float* __restrict__ pts, long long pts_lane,
               long long pts_row, const float* __restrict__ q,
               long long q_lane, long long q_row,
               const float* __restrict__ nrm, long long n_lane,
               long long n_row, const unsigned char* __restrict__ w,
               long long w_lane, long long w_row,
               const float* __restrict__ T, long long T_lane, int N,
               int chunks, float* __restrict__ partial) {
  const long long lane = blockIdx.x / chunks;
  const int chunk = blockIdx.x - (int)lane * chunks;
  const float* Tl = T + lane * T_lane;
  const float qw = Tl[0], qx = Tl[1], qy = Tl[2], qz = Tl[3];
  const float tx = Tl[4], ty = Tl[5], tz = Tl[6];

  float s[GN_SUMS];
#pragma unroll
  for (int k = 0; k < GN_SUMS; ++k) s[k] = 0.f;

  const int stop = min((chunk + 1) * GN_CHUNK, N);
  for (int i = chunk * GN_CHUNK + threadIdx.x; i < stop; i += GN_THREADS) {
    if (!w[lane * w_lane + i * w_row]) continue;
    const float* x = pts + lane * pts_lane + i * pts_row;
    const float* y = q + lane * q_lane + i * q_row;
    const float* m = nrm + lane * n_lane + i * n_row;
    const float v[3] = {x[0], x[1], x[2]};
    float rv[3];
    quat_rotate(qw, qx, qy, qz, v, rv);       // se3.apply: R v + t
    const float p0 = rv[0] + tx, p1 = rv[1] + ty, p2 = rv[2] + tz;
    const float n0 = m[0], n1 = m[1], n2 = m[2];
    const float r = n0 * (p0 - y[0]) + n1 * (p1 - y[1]) + n2 * (p2 - y[2]);
    const float J[6] = {p1 * n2 - p2 * n1, p2 * n0 - p0 * n2,
                        p0 * n1 - p1 * n0, n0, n1, n2};
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) s[upper(a, b)] += J[a] * J[b];
      s[21 + a] -= J[a] * r;
    }
    s[27] += fabsf(r);
  }

  // A fixed order: the warp's xor butterfly, then the warps in order.
#pragma unroll
  for (int k = 0; k < GN_SUMS; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  }
  __shared__ float warp_sums[GN_WARPS][GN_SUMS];
  const int wid = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < GN_SUMS; ++k) warp_sums[wid][k] = s[k];
  }
  __syncthreads();
  if (threadIdx.x < GN_SUMS) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < GN_WARPS; ++k) t += warp_sums[k][threadIdx.x];
    partial[(long long)blockIdx.x * GN_SUMS + threadIdx.x] = t;
  }
}

// ---------------------------------------------------------------------------
// The solve, the pose update, the checker and the freeze
// ---------------------------------------------------------------------------

// T <- normalize(compose(exp(delta), T)), se3.exp's formulas (the
// theta^2 < 1e-12 Taylor branch included) in f32.
__device__ void pose_update(const float d[6], float T[7]) {
  const float o0 = d[0], o1 = d[1], o2 = d[2];
  const float th2 = o0 * o0 + o1 * o1 + o2 * o2;
  const bool small = th2 < 1e-12f;
  const float th2s = small ? 1.f : th2;
  const float th = sqrtf(th2s);
  const float half = 0.5f * th;
  const float k = small ? 0.5f - th2 / 48.f : sinf(half) / th;
  const float ew = small ? 1.f - th2 / 8.f : cosf(half);
  const float ex = k * o0, ey = k * o1, ez = k * o2;
  // t = V v, V = I + a K + b K^2 (the left Jacobian), K = hat(omega).
  const float a = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2s;
  const float b = small ? (float)(1.0 / 6.0) - th2 / 120.f
                        : (th - sinf(th)) / (th2s * th);
  const float v0 = d[3], v1 = d[4], v2 = d[5];
  const float c0 = o1 * v2 - o2 * v1, c1 = o2 * v0 - o0 * v2,
              c2 = o0 * v1 - o1 * v0;
  const float cc0 = o1 * c2 - o2 * c1, cc1 = o2 * c0 - o0 * c2,
              cc2 = o0 * c1 - o1 * c0;
  const float et[3] = {v0 + a * c0 + b * cc0, v1 + a * c1 + b * cc1,
                       v2 + a * c2 + b * cc2};
  // compose(exp, T): q = q_e q_T, t = t_e + q_e (t_T).
  const float w2 = T[0], x2 = T[1], y2 = T[2], z2 = T[3];
  float qw = ew * w2 - ex * x2 - ey * y2 - ez * z2;
  float qx = ew * x2 + ex * w2 + ey * z2 - ez * y2;
  float qy = ew * y2 - ex * z2 + ey * w2 + ez * x2;
  float qz = ew * z2 + ex * y2 - ey * x2 + ez * w2;
  const float tT[3] = {T[4], T[5], T[6]};
  float rt[3];
  quat_rotate(ew, ex, ey, ez, tT, rt);
  // normalize: unit quaternion with qw >= 0.
  const float nq = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
  qw /= nq; qx /= nq; qy /= nq; qz /= nq;
  const float sign = qw < 0.f ? -1.f : 1.f;
  T[0] = sign * qw; T[1] = sign * qx; T[2] = sign * qy; T[3] = sign * qz;
  T[4] = et[0] + rt[0]; T[5] = et[1] + rt[1]; T[6] = et[2] + rt[2];
}

// partial [lanes, chunks, GN_SUMS]; n_new [lanes] (the trim's inlier
// count).  The step's state is read from *_src and written to *_dst
// ([lanes, 7], [lanes], [lanes, smooth, 2], [lanes], [lanes]), which may
// be the same arrays.  freeze: *_dst is the loop state; lanes done there
// keep all of it, the others take the step's state and n_in = n_new.
__global__ void __launch_bounds__(GN_LANES_PER_BLOCK * 32)
gn_update_kernel(const float* __restrict__ partial, int chunks,
                 const int* __restrict__ n_new, int lanes, int smooth,
                 int max_iterations, int min_inliers, float min_diff_rot,
                 float min_diff_trans, double damping, const float* T_src,
                 const int* it_src, const float* hist_src,
                 const unsigned char* done_src, const float* err_src,
                 float* T_dst, int* it_dst, float* hist_dst,
                 unsigned char* done_dst, float* err_dst, int* n_in,
                 int freeze) {
  __shared__ double sums[GN_LANES_PER_BLOCK][GN_SUMS];
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * GN_LANES_PER_BLOCK + wid;
  if (lane < lanes && lid < GN_SUMS) {
    const float* src = partial + lane * chunks * GN_SUMS + lid;
    double t = 0.0;
    for (int c = 0; c < chunks; ++c) t += (double)src[(long long)c * GN_SUMS];
    sums[wid][lid] = t;
  }
  __syncwarp();
  if (lane >= lanes || lid != 0) return;
  const double* s = sums[wid];

  // The damped 6x6 system, solved by Cholesky in double.
  double L[6][6];
  double tr = 0.0;
  for (int a = 0; a < 6; ++a) tr += s[upper(a, a)];
  const double damp = damping * (1.0 + tr / 6.0);
  for (int j = 0; j < 6; ++j) {
    double d = s[upper(j, j)] + damp;
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrt(d);
    for (int i = j + 1; i < 6; ++i) {
      double e = s[upper(j, i)];
      for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k];
      L[i][j] = e / L[j][j];
    }
  }
  double x[6];
  for (int i = 0; i < 6; ++i) {
    double e = s[21 + i];
    for (int k = 0; k < i; ++k) e -= L[i][k] * x[k];
    x[i] = e / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double e = x[i];
    for (int k = i + 1; k < 6; ++k) e -= L[k][i] * x[k];
    x[i] = e / L[i][i];
  }

  // The loop state, read before anything is written (src may be dst).
  const int nn = n_new[lane];
  const bool enough = nn >= min_inliers;
  const bool running = !(freeze && done_dst[lane]);
  float T[7];
  for (int c = 0; c < 7; ++c) T[c] = T_src[lane * 7 + c];
  int it = it_src[lane];
  bool done = done_src[lane] != 0;
  float err = err_src[lane];

  const bool step_on = enough && !done && it < max_iterations;
  float d[6];
  for (int c = 0; c < 6; ++c) d[c] = step_on ? (float)x[c] : 0.f;
  pose_update(d, T);

  // The differential checker's window (icp_default.yaml:24-27).
  const float d_rot = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const float d_trans = sqrtf(d[3] * d[3] + d[4] * d[4] + d[5] * d[5]);
  const float* hs = hist_src + lane * smooth * 2;
  float* hd = hist_dst + lane * smooth * 2;
  float sum_rot = 0.f, sum_trans = 0.f;
  for (int k = step_on ? 1 : 0; k < smooth; ++k) {
    sum_rot += hs[2 * k];
    sum_trans += hs[2 * k + 1];
  }
  if (step_on && smooth > 0) {
    sum_rot += d_rot;
    sum_trans += d_trans;
  }
  const bool converged = it + 1 >= smooth &&
                         sum_rot / (float)smooth < min_diff_rot &&
                         sum_trans / (float)smooth < min_diff_trans;
  if (step_on) err = (float)s[27] / (float)max(nn, 1);
  it += step_on ? 1 : 0;
  done = done || converged || !enough;

  if (!running) return;
  if (step_on && smooth > 0) {
    // Rolled forward: each entry is read before it is overwritten.
    for (int k = 0; k + 1 < smooth; ++k) {
      hd[2 * k] = hs[2 * k + 2];
      hd[2 * k + 1] = hs[2 * k + 3];
    }
    hd[2 * smooth - 2] = d_rot;
    hd[2 * smooth - 1] = d_trans;
  } else if (hd != hs) {
    for (int k = 0; k < 2 * smooth; ++k) hd[k] = hs[k];
  }
  for (int c = 0; c < 7; ++c) T_dst[lane * 7 + c] = T[c];
  it_dst[lane] = it;
  done_dst[lane] = done ? 1 : 0;
  err_dst[lane] = err;
  if (freeze) n_in[lane] = nn;
}

extern "C" {

// The sums of one part of a reading: lanes x ceil(N / GN_CHUNK) blocks;
// partial [lanes, ceil(N / GN_CHUNK), GN_SUMS].
int lsl_gn_sums(const float* pts, long long pts_lane, long long pts_row,
                const float* q, long long q_lane, long long q_row,
                const float* nrm, long long n_lane, long long n_row,
                const unsigned char* w, long long w_lane, long long w_row,
                const float* T, long long T_lane, int lanes, int N,
                float* partial, int device, void* stream) {
  if (lanes < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (N + GN_CHUNK - 1) / GN_CHUNK;
  gn_sums_kernel<<<lanes * chunks, GN_THREADS, 0, (cudaStream_t)stream>>>(
      pts, pts_lane, pts_row, q, q_lane, q_row, nrm, n_lane, n_row, w,
      w_lane, w_row, T, T_lane, N, chunks, partial);
  return (int)cudaGetLastError();
}

// One GN step's update of every lane (gn_update_kernel).
int lsl_gn_update(const float* partial, int chunks, const int* n_new,
                  int lanes, int smooth, int max_iterations, int min_inliers,
                  float min_diff_rot, float min_diff_trans, double damping,
                  const float* T_src, const int* it_src,
                  const float* hist_src, const unsigned char* done_src,
                  const float* err_src, float* T_dst, int* it_dst,
                  float* hist_dst, unsigned char* done_dst, float* err_dst,
                  int* n_in, int freeze, int device, void* stream) {
  if (lanes < 1 || chunks < 0 || smooth < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + GN_LANES_PER_BLOCK - 1) / GN_LANES_PER_BLOCK;
  gn_update_kernel<<<blocks, GN_LANES_PER_BLOCK * 32, 0,
                     (cudaStream_t)stream>>>(
      partial, chunks, n_new, lanes, smooth, max_iterations, min_inliers,
      min_diff_rot, min_diff_trans, damping, T_src, it_src, hist_src,
      done_src, err_src, T_dst, it_dst, hist_dst, done_dst, err_dst, n_in,
      freeze);
  return (int)cudaGetLastError();
}

}  // extern "C"
