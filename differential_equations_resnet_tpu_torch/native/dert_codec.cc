// Native (C++) codec for the DERT sharded binary record format.
//
// The hot training-ingest path reads shards of fixed-shape raw uint8 image
// records; this codec parses a whole shard in one pass into caller-provided
// buffers (no per-record Python overhead).  Format defined in
// differential_equations_resnet_tpu/data/records.py:
//
//   file:    magic "DERT" | u32 version | records...
//   record:  u64 payload_len | u32 crc32(payload) | payload
//   payload: u32 label | u16 name_len | name | u8 encoding |
//            u16 h | u16 w | u16 c | u64 data_len | data
//
// All little-endian.  CRC-32 is the IEEE/zlib polynomial so Python's
// zlib.crc32 and this implementation agree.
//
// Build: g++ -O3 -shared -fPIC dert_codec.cc -o libdert.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <sys/stat.h>

namespace {

constexpr char kMagic[4] = {'D', 'E', 'R', 'T'};
constexpr uint32_t kVersion = 1;

// Error codes (negative returns).
constexpr int64_t kErrOpen = -1;
constexpr int64_t kErrMagic = -2;
constexpr int64_t kErrVersion = -3;
constexpr int64_t kErrTruncated = -4;
constexpr int64_t kErrCrc = -5;
constexpr int64_t kErrShape = -6;
constexpr int64_t kErrEncoding = -7;
constexpr int64_t kErrWrite = -8;

uint32_t* crc_table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) {
        crc = (crc & 1) ? (crc >> 1) ^ 0xEDB88320u : crc >> 1;
      }
      table[i] = crc;
    }
    init = true;
  }
  return table;
}

uint32_t crc32_ieee(const uint8_t* data, size_t len) {
  const uint32_t* table = crc_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) {
    crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}

template <typename T>
T read_le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));  // little-endian hosts only (x86/ARM LE)
  return v;
}

template <typename T>
void write_le(std::vector<uint8_t>* out, T v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out->insert(out->end(), p, p + sizeof(T));
}

struct File {
  FILE* fp;
  explicit File(FILE* f) : fp(f) {}
  ~File() {
    if (fp) std::fclose(fp);
  }
};

}  // namespace

extern "C" {

// Number of records in a shard (validates framing, not CRCs).
int64_t dert_count(const char* path) {
  File f(std::fopen(path, "rb"));
  if (!f.fp) return kErrOpen;
  char magic[4];
  uint32_t version;
  if (std::fread(magic, 1, 4, f.fp) != 4 || std::memcmp(magic, kMagic, 4) != 0)
    return kErrMagic;
  if (std::fread(&version, 4, 1, f.fp) != 1 || version != kVersion)
    return kErrVersion;
  int64_t count = 0;
  uint8_t header[12];
  while (std::fread(header, 1, 12, f.fp) == 12) {
    uint64_t payload_len = read_le<uint64_t>(header);
    if (std::fseek(f.fp, static_cast<long>(payload_len), SEEK_CUR) != 0)
      return kErrTruncated;
    ++count;
  }
  return count;
}

// Bulk-read raw (encoding 0) records with uniform shape (h, w, c) into
// caller buffers: images (max_n*h*w*c u8), labels (max_n i64).
// Returns the number of records read, or a negative error code.
int64_t dert_read_raw(const char* path, uint8_t* images, int64_t* labels,
                      int64_t max_n, int32_t h, int32_t w, int32_t c,
                      int32_t verify_crc) {
  File f(std::fopen(path, "rb"));
  if (!f.fp) return kErrOpen;
  char magic[4];
  uint32_t version;
  if (std::fread(magic, 1, 4, f.fp) != 4 || std::memcmp(magic, kMagic, 4) != 0)
    return kErrMagic;
  if (std::fread(&version, 4, 1, f.fp) != 1 || version != kVersion)
    return kErrVersion;

  // payload_len lies outside the CRC, and the fields inside the payload are
  // only as long as the payload: bound each before it is used (as
  // dert_loader.cc does), so a corrupt or crafted shard is an error and not
  // a huge allocation or a read past the payload.
  struct stat st;
  if (fstat(fileno(f.fp), &st) != 0) return kErrOpen;
  uint64_t remaining = static_cast<uint64_t>(st.st_size) - 8;

  const uint64_t image_bytes = static_cast<uint64_t>(h) * w * c;
  std::vector<uint8_t> payload;
  int64_t n = 0;
  uint8_t header[12];
  while (n < max_n && std::fread(header, 1, 12, f.fp) == 12) {
    uint64_t payload_len = read_le<uint64_t>(header);
    uint32_t crc = read_le<uint32_t>(header + 8);
    remaining -= 12;
    if (payload_len > remaining) return kErrTruncated;
    remaining -= payload_len;
    payload.resize(payload_len);
    if (std::fread(payload.data(), 1, payload_len, f.fp) != payload_len)
      return kErrTruncated;
    if (verify_crc && crc32_ieee(payload.data(), payload_len) != crc)
      return kErrCrc;

    if (payload_len < 6) return kErrTruncated;
    const uint8_t* p = payload.data();
    uint32_t label = read_le<uint32_t>(p);
    uint16_t name_len = read_le<uint16_t>(p + 4);
    const uint64_t header_len = 6ull + name_len + 15ull;
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
    if (rh != h || rw != w || rc != c || data_len != image_bytes)
      return kErrShape;
    std::memcpy(images + n * image_bytes, p, image_bytes);
    labels[n] = static_cast<int64_t>(label);
    ++n;
  }
  return n;
}

// Write n raw records (uniform shape, empty filenames) as one shard.
int64_t dert_write_raw(const char* path, const uint8_t* images,
                       const int64_t* labels, int64_t n, int32_t h, int32_t w,
                       int32_t c) {
  File f(std::fopen(path, "wb"));
  if (!f.fp) return kErrOpen;
  if (std::fwrite(kMagic, 1, 4, f.fp) != 4) return kErrWrite;
  uint32_t version = kVersion;
  if (std::fwrite(&version, 4, 1, f.fp) != 1) return kErrWrite;

  const uint64_t image_bytes = static_cast<uint64_t>(h) * w * c;
  std::vector<uint8_t> payload;
  payload.reserve(21 + image_bytes);
  for (int64_t i = 0; i < n; ++i) {
    payload.clear();
    write_le<uint32_t>(&payload, static_cast<uint32_t>(labels[i]));
    write_le<uint16_t>(&payload, 0);  // empty filename
    payload.push_back(0);             // encoding raw
    write_le<uint16_t>(&payload, static_cast<uint16_t>(h));
    write_le<uint16_t>(&payload, static_cast<uint16_t>(w));
    write_le<uint16_t>(&payload, static_cast<uint16_t>(c));
    write_le<uint64_t>(&payload, image_bytes);
    const uint8_t* img = images + i * image_bytes;
    payload.insert(payload.end(), img, img + image_bytes);

    uint64_t payload_len = payload.size();
    uint32_t crc = crc32_ieee(payload.data(), payload.size());
    if (std::fwrite(&payload_len, 8, 1, f.fp) != 1) return kErrWrite;
    if (std::fwrite(&crc, 4, 1, f.fp) != 1) return kErrWrite;
    if (std::fwrite(payload.data(), 1, payload.size(), f.fp) != payload.size())
      return kErrWrite;
  }
  return n;
}

}  // extern "C"
