// Native host-side IO runtime of laser_slam_tpu_torch.
//
// The port's copy of the JAX package's IO library (the same functions,
// the same C interface): fast scan-log decoding and a threaded
// prefetching loader that keeps the device fed without Python overhead
// on the ingest path.
//
//   * decode_kitti_bin: KITTI velodyne .bin (x,y,z,reflectance f32) -> xyz
//   * decode_velodyne_packets: raw 1206-byte Velodyne data packets -> xyz
//   * voxel_downsample: host-side hash-grid downsample (pre-filter before
//     transfer, first point per voxel)
//   * prefetch loader: background thread decoding scans into a ring
//     buffer (SPSC) so Python sees zero-latency `next()` calls.
//
// Built with g++ at first use by laser_slam_tpu_torch/native/__init__.py
// into laser_slam_tpu_torch/_build/ (a name that hashes this source and
// the flags) and bound with ctypes; the numpy versions there are the
// plain versions, used where no compiler is found.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Scan decoding
// ---------------------------------------------------------------------------

// Decode a KITTI .bin file (N x 4 f32). Returns number of points, fills
// out_xyz (caller-allocated, capacity floats >= 3*max_points). Returns -1
// on IO error.
long decode_kitti_bin(const char* path, float* out_xyz, long max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  if (n > max_points) n = max_points;
  std::vector<float> buf(static_cast<size_t>(n) * 4);
  size_t got = std::fread(buf.data(), sizeof(float), buf.size(), f);
  std::fclose(f);
  n = static_cast<long>(got / 4);
  for (long i = 0; i < n; ++i) {
    out_xyz[3 * i + 0] = buf[4 * i + 0];
    out_xyz[3 * i + 1] = buf[4 * i + 1];
    out_xyz[3 * i + 2] = buf[4 * i + 2];
  }
  return n;
}

// ---------------------------------------------------------------------------
// Raw Velodyne data-packet decoder
// ---------------------------------------------------------------------------
//
// The reference consumes PointCloud2 already decoded by the upstream
// Velodyne ROS node; re-owning the sensor front-end means decoding the raw
// 1206-byte UDP data packets here.  Standard layout (VLP-16/HDL-32 class):
// 12 blocks, each { uint16 flag 0xEEFF, uint16 azimuth (0.01 deg, LE),
// 32 x { uint16 distance (2 mm units), uint8 intensity } }, then a 6-byte
// tail (timestamp + model) that this decoder ignores.
//
// Geometry per the Velodyne manuals: with elevation d and azimuth a,
//   x = r * cos(d) * sin(a),  y = r * cos(d) * cos(a),  z = r * sin(d).
// elev_rad has n_lasers entries in FIRING order; when n_lasers == 16 each
// block holds two full firing sequences (channel k uses elev[k % 16]).
// Zero-distance returns (no echo) are skipped.
//
// Azimuth is INTERPOLATED across the block: the block header carries only
// the azimuth of the first firing, but the 32 channels fire sequentially
// over the block interval (for a VLP-16, the second firing sequence is
// ~0.18-0.2 deg later at 600 rpm — ~6-7 cm of skew at 20 m if ignored,
// which is why the upstream Velodyne ROS node interpolates too).  Channel c
// gets az + gap * c/32 where gap is the azimuth step to the next decoded
// block (the last block reuses the previous gap) — a linear-in-channel
// approximation of the per-sequence + per-channel firing times.
//
// Dual-return packets (factory return-mode byte at offset 1204 equal to
// 0x39/0x3A/0x3B) carry each firing TWICE (block pairs: last + strongest
// return); only the even block of each pair is decoded so points are not
// duplicated.

static const long kPacketBytes = 1206;
static const long kBlocksPerPacket = 12;
static const long kChannelsPerBlock = 32;

static inline float block_azimuth_deg(const uint8_t* pkt, long b) {
  const uint8_t* blk = pkt + b * 100;
  return static_cast<float>(blk[2] | (blk[3] << 8)) * 0.01f;
}

long decode_velodyne_packets(const uint8_t* data, long n_packets,
                             const float* elev_rad, long n_lasers,
                             float* out_xyz, long max_points) {
  long m = 0;
  float prev_gap_deg = 0.0f;  // reused for the stream's final block
  for (long p = 0; p < n_packets; ++p) {
    const uint8_t* pkt = data + p * kPacketBytes;
    const uint8_t mode = pkt[1204];
    const bool dual = (mode == 0x39 || mode == 0x3A || mode == 0x3B);
    const long bstep = dual ? 2 : 1;
    for (long b = 0; b < kBlocksPerPacket; b += bstep) {
      const uint8_t* blk = pkt + b * 100;
      const uint16_t flag =
          static_cast<uint16_t>(blk[0] | (blk[1] << 8));
      if (flag != 0xEEFF) continue;  // malformed / padding block
      const float az_deg = block_azimuth_deg(pkt, b);
      // Azimuth gap to the next decoded block (possibly in the next
      // packet); wrap into [0, 360).
      float gap_deg = prev_gap_deg;
      const long b_next = b + bstep;
      const uint8_t* pkt_next =
          (b_next < kBlocksPerPacket) ? pkt
          : (p + 1 < n_packets ? pkt + kPacketBytes : nullptr);
      const long bn = (b_next < kBlocksPerPacket) ? b_next
                                                  : b_next - kBlocksPerPacket;
      if (pkt_next != nullptr) {
        const uint8_t* nblk = pkt_next + bn * 100;
        const uint16_t nflag =
            static_cast<uint16_t>(nblk[0] | (nblk[1] << 8));
        if (nflag == 0xEEFF) {
          gap_deg = block_azimuth_deg(pkt_next, bn) - az_deg;
          if (gap_deg < 0.0f) gap_deg += 360.0f;
          if (gap_deg > 10.0f) gap_deg = prev_gap_deg;  // discontinuity
          else prev_gap_deg = gap_deg;
        }
      }
      for (long c = 0; c < kChannelsPerBlock; ++c) {
        const uint8_t* rec = blk + 4 + c * 3;
        const uint16_t raw =
            static_cast<uint16_t>(rec[0] | (rec[1] << 8));
        if (raw == 0) continue;  // no return
        if (m >= max_points) return m;
        const float r = static_cast<float>(raw) * 0.002f;
        const float az =
            (az_deg + gap_deg * static_cast<float>(c) /
                          static_cast<float>(kChannelsPerBlock)) *
            0.017453292519943295f;
        // Sines and cosines in double, rounded once to float: the numpy
        // plain version rounds the same values, so the two agree bit for
        // bit (float sinf and numpy's float32 sin round differently).
        const float sin_a = static_cast<float>(std::sin(double{az}));
        const float cos_a = static_cast<float>(std::cos(double{az}));
        const float d = elev_rad[c % n_lasers];
        const float cos_d = static_cast<float>(std::cos(double{d}));
        const float sin_d = static_cast<float>(std::sin(double{d}));
        out_xyz[3 * m + 0] = r * cos_d * sin_a;
        out_xyz[3 * m + 1] = r * cos_d * cos_a;
        out_xyz[3 * m + 2] = r * sin_d;
        ++m;
      }
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Host-side voxel downsample (first-point-per-voxel, like ops/cloud.py)
// ---------------------------------------------------------------------------

long voxel_downsample(const float* xyz, long n, float cell,
                      float* out_xyz, long max_out) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(static_cast<size_t>(n));
  long m = 0;
  const float inv = 1.0f / cell;
  for (long i = 0; i < n && m < max_out; ++i) {
    // 21-bit signed cell coordinates packed into 63 bits.
    int64_t cx = static_cast<int64_t>(std::floor(xyz[3 * i + 0] * inv));
    int64_t cy = static_cast<int64_t>(std::floor(xyz[3 * i + 1] * inv));
    int64_t cz = static_cast<int64_t>(std::floor(xyz[3 * i + 2] * inv));
    uint64_t key = ((static_cast<uint64_t>(cx) & 0x1FFFFF) << 42) |
                   ((static_cast<uint64_t>(cy) & 0x1FFFFF) << 21) |
                   (static_cast<uint64_t>(cz) & 0x1FFFFF);
    if (seen.insert(key).second) {
      out_xyz[3 * m + 0] = xyz[3 * i + 0];
      out_xyz[3 * m + 1] = xyz[3 * i + 1];
      out_xyz[3 * m + 2] = xyz[3 * i + 2];
      ++m;
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Threaded prefetching scan loader (SPSC ring buffer)
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> xyz;
  long n_points = 0;
  long index = -1;
};

struct Loader {
  std::vector<std::string> paths;
  long max_points;
  float voxel_cell;  // <= 0 disables the host pre-filter
  size_t depth;
  std::vector<Slot> ring;
  std::atomic<long> head{0};   // next slot the producer fills
  std::atomic<long> tail{0};   // next slot the consumer reads
  std::atomic<bool> stop{false};
  bool ended = false;          // the consumer has read the end marker
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;

  void run() {
    std::vector<float> tmp(static_cast<size_t>(max_points) * 3);
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      long n = decode_kitti_bin(paths[i].c_str(), tmp.data(), max_points);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() ||
                 head.load() - tail.load() < static_cast<long>(depth);
        });
        if (stop.load()) return;
        Slot& s = ring[head.load() % depth];
        if (n <= 0) {
          s.n_points = 0;
        } else if (voxel_cell > 0.0f) {
          s.xyz.resize(static_cast<size_t>(n) * 3);
          s.n_points = voxel_downsample(tmp.data(), n, voxel_cell,
                                        s.xyz.data(), n);
        } else {
          s.xyz.assign(tmp.begin(), tmp.begin() + n * 3);
          s.n_points = n;
        }
        s.index = static_cast<long>(i);
        head.fetch_add(1);
      }
      cv_consume.notify_one();
    }
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop.load() ||
               head.load() - tail.load() < static_cast<long>(depth);
      });
      if (stop.load()) return;
      Slot& s = ring[head.load() % depth];
      s.index = -2;  // end-of-stream marker
      s.n_points = 0;
      head.fetch_add(1);
    }
    cv_consume.notify_one();
  }
};

void* loader_open(const char** paths, long n_paths, long max_points,
                  float voxel_cell, long depth) {
  Loader* L = new Loader();
  for (long i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->max_points = max_points;
  L->voxel_cell = voxel_cell;
  L->depth = static_cast<size_t>(depth > 0 ? depth : 4);
  L->ring.resize(L->depth);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until the next scan is ready. Returns point count (0 at
// end-of-stream), fills out_xyz and out_index.
long loader_next(void* handle, float* out_xyz, long max_points,
                 long* out_index) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->ended) {  // past the end: no slot will come, do not wait
    *out_index = -1;
    return 0;
  }
  L->cv_consume.wait(lk, [&] { return L->head.load() > L->tail.load(); });
  Slot& s = L->ring[L->tail.load() % L->depth];
  long n = s.n_points;
  if (n > max_points) n = max_points;
  if (s.index == -2) {
    *out_index = -1;
    L->tail.fetch_add(1);
    L->ended = true;
    return 0;
  }
  std::memcpy(out_xyz, s.xyz.data(),
              static_cast<size_t>(n) * 3 * sizeof(float));
  *out_index = s.index;
  L->tail.fetch_add(1);
  lk.unlock();
  L->cv_produce.notify_one();
  return n;
}

void loader_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_produce.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
