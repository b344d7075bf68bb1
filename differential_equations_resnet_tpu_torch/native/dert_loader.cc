// Native (C++) threaded prefetching batch loader for DERT record shards.
//
// The role tf.data's C++ runtime plays in the reference
// (dataset_utils/tfrecord_dataset_creator.py: parallel TFRecord reads +
// host-side prefetch) is played here by a small purpose-built loader:
//
//   - N worker threads claim shards from a deterministic per-epoch
//     permutation (seeded; reshuffled every epoch like the reference's
//     file-level dataset.shuffle) and parse raw fixed-shape records into a
//     bounded ring buffer (backpressure via condition variables).
//   - The consumer (`dert_loader_next`) assembles fixed-size batches,
//     optionally through a reservoir shuffle buffer (record-level
//     dataset.shuffle equivalent).
//
// Only encoding-0 (raw uint8 array) records of one uniform (h, w, c) shape
// are supported — the training-ingest hot path.  Decode-on-read formats go
// through the Python reader.
//
// Build: g++ -O3 -shared -fPIC -pthread dert_loader.cc -o libdert_loader.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>

namespace {

constexpr char kMagic[4] = {'D', 'E', 'R', 'T'};
constexpr uint32_t kVersion = 1;

constexpr int64_t kErrOpen = -1;
constexpr int64_t kErrMagic = -2;
constexpr int64_t kErrVersion = -3;
constexpr int64_t kErrTruncated = -4;
constexpr int64_t kErrCrc = -5;
constexpr int64_t kErrShape = -6;
constexpr int64_t kErrEncoding = -7;

uint32_t* crc_table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j)
        crc = (crc & 1) ? (crc >> 1) ^ 0xEDB88320u : crc >> 1;
      table[i] = crc;
    }
    init = true;
  }
  return table;
}

uint32_t crc32_ieee(const uint8_t* data, size_t len) {
  const uint32_t* table = crc_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

template <typename T>
T read_le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Record {
  std::vector<uint8_t> image;
  int64_t label;
};

struct Loader {
  std::vector<std::string> paths;
  int32_t h, w, c;
  uint64_t image_bytes;
  int64_t batch;
  uint64_t max_index;  // stop after this many shard reads (0 = infinite)
  bool shuffle_files;
  bool verify;
  uint64_t seed;

  std::mutex mu;
  std::condition_variable cv_space;  // producers wait for ring space
  std::condition_variable cv_data;   // consumer waits for records
  std::deque<Record> ring;
  size_t ring_cap;
  int64_t error = 0;     // first worker error (sticky)
  int active = 0;        // workers still running
  bool stop = false;     // close() requested

  std::atomic<uint64_t> next_index{0};  // global shard counter (epochs roll)
  std::vector<std::thread> workers;

  // Consumer-side reservoir shuffle buffer.
  std::vector<Record> reservoir;
  size_t shuffle_buffer;
  std::mt19937_64 consumer_rng;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_space.notify_all();
    cv_data.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

// Shard path for global index i: epoch = i / n, position = i % n, with a
// fresh deterministic permutation per epoch (file-level shuffle).
size_t shard_for_index(const Loader& L, uint64_t i) {
  const size_t n = L.paths.size();
  const uint64_t epoch = i / n;
  std::vector<size_t> order(n);
  for (size_t j = 0; j < n; ++j) order[j] = j;
  std::mt19937_64 rng(L.seed * 0x9E3779B97F4A7C15ull + epoch + 1);
  std::shuffle(order.begin(), order.end(), rng);
  return order[i % n];
}

int64_t parse_shard(Loader* L, const std::string& path,
                    std::vector<Record>* out) {
  struct stat st;
  // Regular files only — fopen+ftell on a directory "succeeds" with
  // LONG_MAX on Linux.
  if (stat(path.c_str(), &st) != 0 || !S_ISREG(st.st_mode)) return kErrOpen;
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return kErrOpen;
  long size = static_cast<long>(st.st_size);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), fp);
  std::fclose(fp);
  if (got != buf.size() || buf.size() < 8) return kErrTruncated;
  if (std::memcmp(buf.data(), kMagic, 4) != 0) return kErrMagic;
  if (read_le<uint32_t>(buf.data() + 4) != kVersion) return kErrVersion;

  size_t off = 8;
  while (off + 12 <= buf.size()) {
    uint64_t payload_len = read_le<uint64_t>(buf.data() + off);
    uint32_t crc = read_le<uint32_t>(buf.data() + off + 8);
    off += 12;
    // payload_len is attacker/corruption-controlled (the CRC covers the
    // payload, not this header): bound it BEFORE any pointer arithmetic.
    if (payload_len > buf.size() - off) return kErrTruncated;
    const uint8_t* p = buf.data() + off;
    off += payload_len;
    if (L->verify && crc32_ieee(p, payload_len) != crc) return kErrCrc;

    // Fixed fields: u32 label | u16 name_len | name | u8 enc | 3x u16 shape
    // | u64 data_len | data.  Every offset must stay within payload_len.
    if (payload_len < 6) return kErrTruncated;
    uint32_t label = read_le<uint32_t>(p);
    uint16_t name_len = read_le<uint16_t>(p + 4);
    uint64_t header_len = 6ull + name_len + 15ull;
    if (payload_len < header_len) return kErrTruncated;
    p += 6 + name_len;
    uint8_t encoding = *p;
    uint16_t rh = read_le<uint16_t>(p + 1);
    uint16_t rw = read_le<uint16_t>(p + 3);
    uint16_t rc = read_le<uint16_t>(p + 5);
    uint64_t data_len = read_le<uint64_t>(p + 7);
    p += 15;
    if (data_len > payload_len - header_len) return kErrTruncated;
    if (encoding != 0) return kErrEncoding;
    if (rh != L->h || rw != L->w || rc != L->c || data_len != L->image_bytes)
      return kErrShape;

    Record r;
    r.image.assign(p, p + L->image_bytes);
    r.label = static_cast<int64_t>(label);
    out->push_back(std::move(r));
  }
  return static_cast<int64_t>(out->size());
}

void worker_main(Loader* L) {
  const uint64_t n = L->paths.size();
  bool running = true;
  while (running) {
    uint64_t i = L->next_index.fetch_add(1);
    if (L->max_index && i >= L->max_index) break;
    const std::string& path =
        L->paths[L->shuffle_files ? shard_for_index(*L, i) : i % n];

    std::vector<Record> records;
    int64_t rc = parse_shard(L, path, &records);
    std::unique_lock<std::mutex> lock(L->mu);
    if (rc < 0) {
      if (L->error == 0) L->error = rc;
      break;
    }
    for (auto& r : records) {
      L->cv_space.wait(lock, [L] {
        return L->stop || L->ring.size() < L->ring_cap;
      });
      if (L->stop) {
        running = false;
        break;
      }
      L->ring.push_back(std::move(r));
      L->cv_data.notify_one();
    }
  }
  std::lock_guard<std::mutex> lock(L->mu);
  --L->active;
  L->cv_data.notify_all();
}

// Pop one record (ring or via the reservoir shuffle). Caller holds the lock.
// Returns false when the stream is exhausted.
bool pop_record(Loader* L, std::unique_lock<std::mutex>& lock, Record* out) {
  for (;;) {
    L->cv_data.wait(lock, [L] {
      return L->stop || L->error != 0 || !L->ring.empty() || L->active == 0;
    });
    if (L->stop || L->error != 0) return false;
    if (!L->ring.empty()) {
      Record r = std::move(L->ring.front());
      L->ring.pop_front();
      L->cv_space.notify_one();
      if (L->shuffle_buffer > 1) {
        if (L->reservoir.size() < L->shuffle_buffer) {
          L->reservoir.push_back(std::move(r));
          continue;  // keep filling
        }
        size_t j = L->consumer_rng() % L->reservoir.size();
        *out = std::move(L->reservoir[j]);
        L->reservoir[j] = std::move(r);
        return true;
      }
      *out = std::move(r);
      return true;
    }
    // Producers finished; drain the reservoir.
    if (!L->reservoir.empty()) {
      size_t j = L->consumer_rng() % L->reservoir.size();
      *out = std::move(L->reservoir[j]);
      L->reservoir[j] = std::move(L->reservoir.back());
      L->reservoir.pop_back();
      return true;
    }
    return false;  // fully exhausted
  }
}

}  // namespace

extern "C" {

// num_epochs: passes over the shard list (0 = repeat forever).
void* dert_loader_open(const char** paths, int64_t n_paths, int32_t h,
                       int32_t w, int32_t c, int64_t batch,
                       int64_t num_epochs, int32_t shuffle_files,
                       int32_t verify_crc, int32_t num_threads,
                       int64_t shuffle_buffer, uint64_t seed,
                       int64_t ring_capacity) {
  if (n_paths <= 0 || batch <= 0) return nullptr;
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->h = h;
  L->w = w;
  L->c = c;
  L->image_bytes = static_cast<uint64_t>(h) * w * c;
  L->batch = batch;
  L->max_index =
      num_epochs > 0 ? static_cast<uint64_t>(num_epochs) * n_paths : 0;
  L->shuffle_files = shuffle_files != 0;
  L->verify = verify_crc != 0;
  L->seed = seed;
  L->shuffle_buffer = shuffle_buffer > 1 ? static_cast<size_t>(shuffle_buffer) : 0;
  L->consumer_rng.seed(seed ^ 0xD1B54A32D192ED03ull);
  L->ring_cap = ring_capacity > 0 ? static_cast<size_t>(ring_capacity) : 4096;
  int threads = num_threads > 0 ? num_threads : 2;
  if (L->max_index &&
      static_cast<uint64_t>(threads) > L->max_index)
    threads = static_cast<int>(L->max_index);
  L->active = threads;
  for (int t = 0; t < threads; ++t)
    L->workers.emplace_back(worker_main, L);
  return L;
}

// Fill up to `batch` records. Returns the count (possibly a short final
// batch), 0 at end-of-data (repeat=false), or a negative error code.
int64_t dert_loader_next(void* handle, uint8_t* images, int64_t* labels) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  int64_t n = 0;
  Record r;
  while (n < L->batch && pop_record(L, lock, &r)) {
    std::memcpy(images + n * L->image_bytes, r.image.data(), L->image_bytes);
    labels[n] = r.label;
    ++n;
  }
  if (L->error != 0 && n == 0) return L->error;
  return n;
}

void dert_loader_close(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
