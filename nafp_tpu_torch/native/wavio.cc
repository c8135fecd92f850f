// Threaded PCM16 WAV segment decoder for the nafp_tpu_torch host data loader.
//
// Native counterpart of the reference's per-sample Python decode path
// (model/utils/audio_utils.py:221-264 driven by worker processes,
// model/trainer.py:183-186). One call decodes a whole batch of segments
// across a thread pool: header parse + pread + int16->float32 scale +
// tail zero-pad, no Python in the loop.
//
// C ABI (ctypes-friendly):
//   nafp_load_segments(paths, starts, n_seg, seg_len, out, n_threads)
//     paths:   array of n_seg C strings (WAV file paths)
//     starts:  per-segment start frame (may run past EOF -> zero pad)
//     seg_len: frames per segment
//     out:     float32 buffer of n_seg * seg_len
//   returns 0 on success, else the (1-based) index of the first failing
//   segment negated, for error reporting.
//
//   nafp_wav_info(path, &n_frames, &sample_rate) -> 0 ok / -1 error

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct WavInfo {
  int64_t data_offset = -1;  // byte offset of PCM payload
  int64_t n_frames = 0;      // total frames (samples, mono)
  int32_t sample_rate = 0;
  int16_t channels = 0;
  int16_t bits = 0;
};

// Minimal RIFF chunk walk. Returns false on malformed header.
bool parse_header(int fd, WavInfo* info) {
  uint8_t hdr[12];
  if (pread(fd, hdr, 12, 0) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;

  int64_t pos = 12;
  uint8_t ck[8];
  bool have_fmt = false;
  while (pread(fd, ck, 8, pos) == 8) {
    uint32_t sz;
    memcpy(&sz, ck + 4, 4);
    if (memcmp(ck, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (pread(fd, fmt, 16, pos + 8) != 16) return false;
      memcpy(&info->channels, fmt + 2, 2);
      memcpy(&info->sample_rate, fmt + 4, 4);
      memcpy(&info->bits, fmt + 14, 2);
      have_fmt = true;
    } else if (memcmp(ck, "data", 4) == 0) {
      info->data_offset = pos + 8;
      if (have_fmt && info->channels > 0 && info->bits > 0) {
        info->n_frames =
            static_cast<int64_t>(sz) / (info->channels * info->bits / 8);
      }
      return have_fmt && info->bits == 16 && info->channels == 1;
    }
    pos += 8 + sz + (sz & 1);  // chunks are word-aligned
  }
  return false;
}

bool load_one(const char* path, int64_t start, int64_t seg_len, float* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  WavInfo info;
  if (!parse_header(fd, &info)) {
    close(fd);
    return false;
  }
  memset(out, 0, sizeof(float) * seg_len);
  int64_t s = start < 0 ? 0 : start;
  if (s < info.n_frames) {
    int64_t n = seg_len;
    if (s + n > info.n_frames) n = info.n_frames - s;
    std::vector<int16_t> buf(n);
    ssize_t got = pread(fd, buf.data(), n * 2, info.data_offset + s * 2);
    if (got < 0) {
      close(fd);
      return false;
    }
    int64_t frames = got / 2;
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i) out[i] = buf[i] * kScale;
  }
  close(fd);
  return true;
}

}  // namespace

extern "C" {

int nafp_wav_info(const char* path, int64_t* n_frames, int32_t* sample_rate) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  WavInfo info;
  bool ok = parse_header(fd, &info);
  close(fd);
  if (!ok) return -1;
  *n_frames = info.n_frames;
  *sample_rate = info.sample_rate;
  return 0;
}

int nafp_load_segments(const char** paths, const int64_t* starts, int n_seg,
                       int64_t seg_len, float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_seg) n_threads = n_seg > 0 ? n_seg : 1;
  std::atomic<int> next(0);
  std::atomic<int> first_fail(0);  // 0 = none; else 1-based index

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_seg) break;
      if (!load_one(paths[i], starts[i], seg_len, out + i * seg_len)) {
        int expected = 0;
        first_fail.compare_exchange_strong(expected, i + 1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return -first_fail.load();
}

}  // extern "C"
