// Native training data loader: threaded wav-crop batch producer.
//
// The port's copy of academicodec_tpu/native/wavloader.cpp (same C ABI,
// same draws), built by native/build.py.
//
// Replacement for the reference's torch DataLoader worker
// processes (models/encodec/main_launch.py:216-237 num_workers=8,
// models/hificodec/train.py:138-164): a C++ thread pool parses RIFF
// headers, seeks DIRECTLY to the crop window (the Python pipeline reads
// whole files for 1 s crops), converts to float32, and assembles
// fixed-shape [batch, segment] buffers into a bounded prefetch queue so
// the device never waits on the host.
//
// Covered dataset behaviors (data/dataset.py):
//   * random fixed-length crop, inclusive final offset / zero-pad short
//     files (reference dataset.py:23-32)
//   * p two-clip mixture augmentation (soundstream/dataset.py:27-48)
//   * corrupt-file fallback to low-level noise (meldataset.py:143-149)
//   * per-epoch reshuffle + DistributedSampler-style rank sharding
//     (wrap-pad then stride; main_launch.py:220-227)
//
// PCM16/24/32 + float32/64 WAVs, mono mixdown by channel mean. No
// resampling: callers needing it use the Python pipeline.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;     // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  int64_t data_off = 0;    // byte offset of sample data
  int64_t data_len = 0;    // bytes of sample data
  int64_t frames() const {
    int bytes = bits / 8;
    return (channels && bytes) ? data_len / (bytes * (int64_t)channels) : 0;
  }
};

bool parse_header(FILE* f, WavInfo* out) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) || memcmp(hdr + 8, "WAVE", 4)) return false;
  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, ch + 4, 4);
    if (!memcmp(ch, "fmt ", 4)) {
      if (size < 16) return false;  // need the full WAVEFORMAT block
      uint8_t buf[40] = {0};
      uint32_t take = size < 40 ? size : 40;
      if (fread(buf, 1, take, f) != take) return false;
      if (size > take && fseek(f, size - take, SEEK_CUR)) return false;
      memcpy(&out->format, buf, 2);
      memcpy(&out->channels, buf + 2, 2);
      memcpy(&out->rate, buf + 4, 4);
      memcpy(&out->bits, buf + 14, 2);
      if (out->format == 0xFFFE && size >= 26) memcpy(&out->format, buf + 24, 2);
      have_fmt = true;
    } else if (!memcmp(ch, "data", 4)) {
      out->data_off = ftell(f);
      out->data_len = size;
      have_data = true;
      if (fseek(f, size + (size & 1), SEEK_CUR)) break;
    } else {
      if (fseek(f, size + (size & 1), SEEK_CUR)) break;
    }
  }
  return have_fmt && have_data && out->channels > 0 && out->bits >= 8;
}

// Read [start, start+count) frames as mono float32; true length may be
// shorter at file end (caller zero-pads). Returns frames read, -1 on error.
int64_t read_mono(const std::string& path, int64_t start, int64_t count,
                  float* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return -1;
  WavInfo w;
  if (!parse_header(f, &w) || (w.format != 1 && w.format != 3)) {
    fclose(f);
    return -1;
  }
  const int bytes = w.bits / 8;
  const int ch = w.channels;
  const int64_t total = w.frames();
  if (start >= total) {
    fclose(f);
    return 0;
  }
  int64_t n = count;
  if (start + n > total) n = total - start;
  if (fseek(f, w.data_off + start * bytes * ch, SEEK_SET)) {
    fclose(f);
    return -1;
  }
  std::vector<uint8_t> raw((size_t)(n * bytes * ch));
  int64_t got = (int64_t)fread(raw.data(), bytes * ch, (size_t)n, f);
  fclose(f);
  if (got <= 0) return -1;
  const float inv_ch = 1.0f / ch;
  for (int64_t i = 0; i < got; i++) {
    float acc = 0.0f;
    for (int c = 0; c < ch; c++) {
      const uint8_t* p = raw.data() + (size_t)((i * ch + c) * bytes);
      float v = 0.0f;
      if (w.format == 1) {
        if (w.bits == 16) {
          int16_t s;
          memcpy(&s, p, 2);
          v = s / 32768.0f;
        } else if (w.bits == 32) {
          int32_t s;
          memcpy(&s, p, 4);
          v = (float)(s / 2147483648.0);
        } else if (w.bits == 24) {
          int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
          v = (float)(s / 2147483648.0);
        } else if (w.bits == 8) {
          v = ((int)p[0] - 128) / 128.0f;
        }
      } else {  // IEEE float
        if (w.bits == 32) {
          float s;
          memcpy(&s, p, 4);
          v = s;
        } else if (w.bits == 64) {
          double s;
          memcpy(&s, p, 8);
          v = (float)s;
        }
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  return got;
}

struct Loader {
  std::vector<std::string> files;
  std::vector<std::atomic<int64_t>>* lengths = nullptr;  // cached frames (-1 = unknown)
  int64_t segment;
  uint32_t expect_rate;  // 0 = accept any; else mismatched files -> fallback
  float mixture_prob;
  int batch;
  uint64_t seed;
  int proc_index, proc_count;
  int depth;
  // resume support: all RNG streams are keyed on (epoch_base + local epoch)
  // so a loader built mid-training reproduces the run's epoch order
  int64_t epoch_base = 0;

  // epoch order state (produced lazily by workers)
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::vector<float>> bufs;      // depth x [batch*segment]
  std::vector<std::atomic<int>>* filled = nullptr;  // items done per slot
  std::vector<int64_t> slot_batch;           // global batch id in each slot, -1 free
  int64_t next_batch_to_hand = 0;            // consumer cursor
  int64_t next_item = 0;                     // producer cursor (global item id)
  std::vector<uint32_t> order;               // current epoch order (sharded)
  int64_t epoch = -1;
  int64_t batches_per_epoch = 0;
  bool stop = false;
  std::vector<std::thread> threads;
  // noise substitutions served so far (corrupt file / wrong rate / short
  // read) — surfaced via wavloader_fallbacks so a partially bad corpus
  // cannot silently train on noise
  std::atomic<long long> fallbacks{0};

  void reshuffle(int64_t e) {
    std::vector<uint32_t> idx(files.size());
    for (uint32_t i = 0; i < idx.size(); i++) idx[i] = i;
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ull +
                        (uint64_t)(e + epoch_base));
    for (size_t i = idx.size() - 1; i > 0; i--) {
      size_t j = rng() % (i + 1);
      std::swap(idx[i], idx[j]);
    }
    // DistributedSampler semantics: wrap-pad to a multiple of proc_count,
    // then stride by rank (dataset.py shard_indices)
    size_t pad = (proc_count - idx.size() % proc_count) % proc_count;
    for (size_t i = 0; i < pad; i++) idx.push_back(idx[i]);
    order.clear();
    for (size_t i = proc_index; i < idx.size(); i += proc_count)
      order.push_back(idx[i]);
    batches_per_epoch = (int64_t)order.size() / batch;  // drop_last
  }

  // deterministic per-(epoch, item) RNG — independent of thread schedule
  static std::mt19937_64 item_rng(uint64_t seed, int64_t e, int64_t item) {
    return std::mt19937_64(
        (seed ^ 0xD1B54A32D192ED03ull) + (uint64_t)e * 0x100000001B3ull +
        (uint64_t)item * 0x9E3779B97F4A7C15ull);
  }

  // file_idx resolved at claim time (under the lock) — `order` mutates at
  // epoch boundaries while stragglers of the previous epoch still load
  void load_item(int64_t e, int64_t item_in_epoch, uint32_t file_idx,
                 float* dst) {
    std::mt19937_64 rng = item_rng(seed, e + epoch_base, item_in_epoch);
    load_crop(file_idx, rng, dst);
    if (mixture_prob > 0.0f) {
      double u = (rng() >> 11) * (1.0 / 9007199254740992.0);
      if (u < mixture_prob) {
        std::vector<float> other((size_t)segment);
        uint32_t fi = (uint32_t)(rng() % files.size());
        load_crop(fi, rng, other.data());
        for (int64_t i = 0; i < segment; i++) dst[i] += other[i];
      }
    }
  }

  void load_crop(uint32_t file_idx, std::mt19937_64& rng, float* dst) {
    const std::string& path = files[file_idx];
    int64_t len = (*lengths)[file_idx].load(std::memory_order_relaxed);
    if (len == -1) {  // probe once (benign if raced: same value)
      FILE* f = fopen(path.c_str(), "rb");
      WavInfo w;
      len = (f && parse_header(f, &w)) ? w.frames() : -2;
      if (len > 0 && expect_rate && w.rate != expect_rate)
        len = -3;  // wrong sample rate: fall back like a corrupt file
      if (f) fclose(f);
      (*lengths)[file_idx].store(len, std::memory_order_relaxed);
    }
    if (len <= 0) {  // corrupt: low-level noise (meldataset.py:143-149)
      fallbacks.fetch_add(1, std::memory_order_relaxed);
      std::mt19937_64 nrng(0);
      std::normal_distribution<float> nd(0.0f, 0.05f);
      for (int64_t i = 0; i < segment; i++) dst[i] = nd(nrng);
      return;
    }
    int64_t start = 0;
    if (len > segment) start = (int64_t)(rng() % (uint64_t)(len - segment + 1));
    int64_t got = read_mono(path, start, segment, dst);
    if (got < 0) {
      fallbacks.fetch_add(1, std::memory_order_relaxed);
      std::mt19937_64 nrng(0);
      std::normal_distribution<float> nd(0.0f, 0.05f);
      for (int64_t i = 0; i < segment; i++) dst[i] = nd(nrng);
      return;
    }
    for (int64_t i = got; i < segment; i++) dst[i] = 0.0f;
  }

  void worker() {
    for (;;) {
      int64_t gb, item, e;
      uint32_t file_idx;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          if (stop) return;
          int64_t item_in_epoch = next_item % (batches_per_epoch * batch);
          gb = next_item / batch;
          // claim a slot for this global batch (FIFO window of `depth`)
          if (gb - next_batch_to_hand < depth) {
            slot = (int)(gb % depth);
            if (slot_batch[slot] == -1 || slot_batch[slot] == gb) {
              slot_batch[slot] = gb;
              e = next_item / (batches_per_epoch * batch);
              if (e != epoch) reshuffle(epoch = e);
              item = item_in_epoch;
              file_idx = order[(size_t)item];  // resolve while order is valid
              next_item++;
              break;
            }
          }
          cv_free.wait(lk);
        }
      }
      float* dst = bufs[(size_t)(gb % depth)].data() +
                   (size_t)(item % batch) * segment;
      load_item(e, item, file_idx, dst);
      if ((*filled)[(size_t)(gb % depth)].fetch_add(1) + 1 == batch) {
        std::lock_guard<std::mutex> lk(mu);
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* wavloader_create(const char** paths, int n_files, long long segment,
                       unsigned int expect_rate, float mixture_prob, int batch,
                       unsigned long long seed, int n_threads, int proc_index,
                       int proc_count, int depth, long long epoch_base) {
  if (n_files <= 0 || batch <= 0 || segment <= 0 || depth <= 0) return nullptr;
  Loader* L = new Loader();
  L->files.reserve(n_files);
  for (int i = 0; i < n_files; i++) L->files.emplace_back(paths[i]);
  L->lengths = new std::vector<std::atomic<int64_t>>(n_files);
  for (auto& a : *L->lengths) a.store(-1);
  L->segment = segment;
  L->expect_rate = expect_rate;
  L->mixture_prob = mixture_prob;
  L->batch = batch;
  L->seed = seed;
  L->proc_index = proc_index;
  L->proc_count = proc_count < 1 ? 1 : proc_count;
  L->depth = depth;
  L->epoch_base = epoch_base;
  L->bufs.assign(depth, std::vector<float>((size_t)batch * segment));
  L->filled = new std::vector<std::atomic<int>>(depth);
  for (auto& a : *L->filled) a.store(0);
  L->slot_batch.assign(depth, -1);
  L->reshuffle(L->epoch = 0);
  if (L->batches_per_epoch <= 0) {
    delete L->filled;
    delete L->lengths;
    delete L;
    return nullptr;
  }
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; i++)
    L->threads.emplace_back([L] { L->worker(); });
  return L;
}

long long wavloader_batches_per_epoch(void* h) {
  return ((Loader*)h)->batches_per_epoch;
}

// Count of noise substitutions served so far (corrupt header, mismatched
// sample rate, or failed read). Monotonic; poll after wavloader_next.
long long wavloader_fallbacks(void* h) {
  return ((Loader*)h)->fallbacks.load(std::memory_order_relaxed);
}

// Blocks until the next batch is complete; copies [batch, segment] floats
// into `out`. Returns the global batch index (epoch = idx / batches_per_epoch).
long long wavloader_next(void* h, float* out) {
  Loader* L = (Loader*)h;
  int64_t gb;
  int slot;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    gb = L->next_batch_to_hand;
    slot = (int)(gb % L->depth);
    L->cv_ready.wait(lk, [&] {
      return L->slot_batch[slot] == gb &&
             (*L->filled)[slot].load() == L->batch;
    });
  }
  memcpy(out, L->bufs[slot].data(),
         (size_t)L->batch * L->segment * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    (*L->filled)[slot].store(0);
    L->slot_batch[slot] = -1;
    L->next_batch_to_hand = gb + 1;
    L->cv_free.notify_all();
  }
  return gb;
}

void wavloader_destroy(void* h) {
  Loader* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_free.notify_all();
  }
  for (auto& t : L->threads) t.join();
  delete L->filled;
  delete L->lengths;
  delete L;
}

}  // extern "C"
