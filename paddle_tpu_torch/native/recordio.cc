// Chunked record files: writer and scanner (the port's own copy of the
// JAX package's paddle_tpu/native/recordio.cc, byte for byte the same
// format, so either package reads the other's files).
//
// Reference: paddle/fluid/recordio/ (header.h:39 chunk layout, chunk.cc,
// scanner.cc) and python/paddle/fluid/recordio_writer.py. The writer emits
// "PTR1" chunks (below). The scanner also reads the reference's wire format
// (magic 0x01020304): chunks uncompressed or snappy-framed (kSnappy, the
// reference writer's default, recordio_writer.py:27), with zlib's crc32
// over the stored bytes; gzip chunks are refused. Both formats hold the
// same per-record [len u32][bytes] payload. No external library: the crc
// tables and the snappy decoder are below.
//
// File = sequence of chunks.
// Chunk = [magic u32 'PTR1'][num_records u32][payload_len u64][checksum u64]
//         [payload: num_records x (len u32, bytes)]
// Checksum: FNV-1a over the payload (no external deps).
// Reference chunk = [magic u32 0x01020304][num_records u32][crc32 u32]
//         [compressor u32][compress_size u32][payload] (header.cc:33).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x31525450;      // "PTR1" little-endian
constexpr uint32_t kRefMagic = 0x01020304;   // reference header.h kMagicNumber
constexpr uint32_t kRefNoCompress = 0;       // Compressor::kNoCompress
constexpr uint32_t kRefSnappy = 1;           // Compressor::kSnappy (DEFAULT
                                             // of recordio_writer.py:27)
constexpr uint64_t kFnvOffset = 1469598103934665603ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

uint64_t fnv1a(const char* data, size_t n) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

// Table-driven reflected CRC32, parameterized by polynomial. Tables build
// in magic-static constructors: thread-safe under the multi-threaded
// feeder (feeder.cc spawns N scanner threads).
struct CrcTable {
  uint32_t t[256];
  explicit CrcTable(uint32_t poly) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? poly ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

uint32_t CrcRun(const CrcTable& tbl, const char* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = tbl.t[(crc ^ static_cast<unsigned char>(data[i])) & 0xFF] ^
          (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// zlib-compatible CRC32 (the reference checksums chunks with zlib crc32,
// chunk.cc Crc32Stream).
uint32_t crc32_ieee(const char* data, size_t n) {
  static const CrcTable tbl(0xEDB88320u);
  return CrcRun(tbl, data, n);
}

// CRC-32C (Castagnoli, reflected poly 0x82F63B78) — the checksum of the
// snappy framing format (framing_format.txt §3), stored "masked".
uint32_t crc32c(const char* data, size_t n) {
  static const CrcTable tbl(0x82F63B78u);
  return CrcRun(tbl, data, n);
}

uint32_t MaskCrc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// Raw snappy block decompression (snappy format_description.txt): varint32
// uncompressed length, then a tag stream of literals and back-references.
// ~90 lines — the reference links the full snappy library for this, but
// the decoder side needs no external dep.
bool RawSnappyUncompress(const unsigned char* in, size_t n, std::string* out) {
  // corrupt preambles must not drive allocation: no legitimate recordio
  // chunk decompresses anywhere near this (writer chunks are ~1 MB)
  constexpr uint64_t kMaxUncompressed = 1ull << 30;
  size_t p = 0;
  uint64_t ulen = 0;
  int shift = 0;
  while (p < n) {  // varint32 preamble
    unsigned char b = in[p++];
    ulen |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 32) return false;
  }
  if (ulen > kMaxUncompressed) return false;
  out->clear();
  out->reserve(ulen);
  while (p < n) {
    unsigned char tag = in[p++];
    uint32_t type = tag & 3;
    if (type == 0) {  // literal
      uint32_t len = (tag >> 2) + 1;
      if (len > 60) {
        uint32_t nbytes = len - 60;  // 1..4 length bytes follow
        if (p + nbytes > n) return false;
        len = 0;
        for (uint32_t i = 0; i < nbytes; ++i)
          len |= static_cast<uint32_t>(in[p + i]) << (8 * i);
        len += 1;
        p += nbytes;
      }
      if (p + len > n) return false;
      out->append(reinterpret_cast<const char*>(in + p), len);
      p += len;
    } else {  // copy
      uint32_t len, offset;
      if (type == 1) {
        if (p >= n) return false;
        len = ((tag >> 2) & 7) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | in[p++];
      } else if (type == 2) {
        if (p + 2 > n) return false;
        len = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(in[p]) |
                 (static_cast<uint32_t>(in[p + 1]) << 8);
        p += 2;
      } else {
        if (p + 4 > n) return false;
        len = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(in[p]) |
                 (static_cast<uint32_t>(in[p + 1]) << 8) |
                 (static_cast<uint32_t>(in[p + 2]) << 16) |
                 (static_cast<uint32_t>(in[p + 3]) << 24);
        p += 4;
      }
      if (offset == 0 || offset > out->size()) return false;
      size_t from = out->size() - offset;
      // byte-by-byte: copies may overlap their own output (RLE)
      for (uint32_t i = 0; i < len; ++i) out->push_back((*out)[from + i]);
    }
  }
  return out->size() == ulen;
}

// Snappy FRAMING format (framing_format.txt) — what the reference's
// snappystream (hoxnox) writes inside a kSnappy chunk: a stream-identifier
// chunk then compressed/uncompressed data chunks with masked CRC-32C of
// the UNCOMPRESSED data. Returns false on structural corruption.
bool SnappyFramedUncompress(const std::vector<char>& in, std::string* out) {
  const unsigned char* buf = reinterpret_cast<const unsigned char*>(in.data());
  size_t n = in.size(), p = 0;
  out->clear();
  std::string block;
  while (p < n) {
    if (p + 4 > n) return false;
    unsigned char type = buf[p];
    uint32_t len = static_cast<uint32_t>(buf[p + 1]) |
                   (static_cast<uint32_t>(buf[p + 2]) << 8) |
                   (static_cast<uint32_t>(buf[p + 3]) << 16);
    p += 4;
    if (p + len > n) return false;
    if (type == 0xff) {  // stream identifier "sNaPpY"
      if (len != 6 || std::memcmp(buf + p, "sNaPpY", 6) != 0) return false;
    } else if (type == 0x00 || type == 0x01) {  // compressed / uncompressed
      if (len < 4) return false;
      uint32_t stored = static_cast<uint32_t>(buf[p]) |
                        (static_cast<uint32_t>(buf[p + 1]) << 8) |
                        (static_cast<uint32_t>(buf[p + 2]) << 16) |
                        (static_cast<uint32_t>(buf[p + 3]) << 24);
      const unsigned char* data = buf + p + 4;
      size_t dlen = len - 4;
      if (type == 0x00) {
        if (!RawSnappyUncompress(data, dlen, &block)) return false;
      } else {
        block.assign(reinterpret_cast<const char*>(data), dlen);
      }
      uint32_t crc = crc32c(block.data(), block.size());
      // spec-masked CRC-32C only: the reference snappystream writer always
      // masks, and accepting raw CRCs would halve corruption detection
      if (stored != MaskCrc(crc)) return false;
      out->append(block);
    } else if (type == 0xfe || (type >= 0x80 && type <= 0xfd)) {
      // padding / reserved skippable: ignore payload
    } else {
      return false;  // reserved unskippable
    }
    p += len;
  }
  return true;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<char> payload;
  uint32_t num_records = 0;
  uint32_t max_records_per_chunk = 1000;
  size_t max_chunk_bytes = 1 << 20;

  int FlushChunk() {
    if (num_records == 0) return 0;
    uint64_t len = payload.size();
    uint64_t sum = fnv1a(payload.data(), payload.size());
    if (fwrite(&kMagic, 4, 1, f) != 1) return -1;
    if (fwrite(&num_records, 4, 1, f) != 1) return -1;
    if (fwrite(&len, 8, 1, f) != 1) return -1;
    if (fwrite(&sum, 8, 1, f) != 1) return -1;
    if (len && fwrite(payload.data(), 1, len, f) != len) return -1;
    payload.clear();
    num_records = 0;
    return 0;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<char> payload;
  size_t cursor = 0;
  uint32_t remaining = 0;
  std::string record;

  // loads the next chunk; returns 0 ok, -1 EOF, -2 corrupt,
  // -3 unsupported compression (reference snappy/gzip chunks)
  int LoadChunk() {
    uint32_t magic = 0, n = 0;
    if (fread(&magic, 4, 1, f) != 1) return -1;
    if (magic == kRefMagic) return LoadRefChunk();
    if (magic != kMagic) return -2;
    uint64_t len = 0, sum = 0;
    if (fread(&n, 4, 1, f) != 1) return -2;
    if (fread(&len, 8, 1, f) != 1) return -2;
    if (fread(&sum, 8, 1, f) != 1) return -2;
    payload.resize(len);
    if (len && fread(payload.data(), 1, len, f) != len) return -2;
    if (fnv1a(payload.data(), len) != sum) return -2;
    cursor = 0;
    remaining = n;
    return 0;
  }

  // reference wire format (header.cc:33): num_records, crc32(payload),
  // compressor, compress_size — payload records are [len u32][bytes], the
  // same layout as PTR1 chunks, so only the header differs. kSnappy (the
  // recordio_writer.py DEFAULT) payloads hold the snappy framing format;
  // the zlib crc32 covers the COMPRESSED bytes (chunk.cc Crc32Stream runs
  // over the post-compression stream).
  int LoadRefChunk() {
    uint32_t n = 0, crc = 0, comp = 0, size = 0;
    if (fread(&n, 4, 1, f) != 1) return -2;
    if (fread(&crc, 4, 1, f) != 1) return -2;
    if (fread(&comp, 4, 1, f) != 1) return -2;
    if (fread(&size, 4, 1, f) != 1) return -2;
    if (comp != kRefNoCompress && comp != kRefSnappy) return -3;
    payload.resize(size);
    if (size && fread(payload.data(), 1, size, f) != size) return -2;
    if (crc32_ieee(payload.data(), size) != crc) return -2;
    if (comp == kRefSnappy) {
      std::string raw;
      if (!SnappyFramedUncompress(payload, &raw)) return -2;
      payload.assign(raw.begin(), raw.end());
    }
    cursor = 0;
    remaining = n;
    return 0;
  }
};

}  // namespace

extern "C" {

void* pttrio_writer_open(const char* path, int max_records_per_chunk,
                        long max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  if (max_records_per_chunk > 0)
    w->max_records_per_chunk = static_cast<uint32_t>(max_records_per_chunk);
  if (max_chunk_bytes > 0)
    w->max_chunk_bytes = static_cast<size_t>(max_chunk_bytes);
  return w;
}

int pttrio_writer_write(void* handle, const char* data, long len) {
  Writer* w = static_cast<Writer*>(handle);
  uint32_t l = static_cast<uint32_t>(len);
  const char* lp = reinterpret_cast<const char*>(&l);
  w->payload.insert(w->payload.end(), lp, lp + 4);
  w->payload.insert(w->payload.end(), data, data + len);
  w->num_records++;
  if (w->num_records >= w->max_records_per_chunk ||
      w->payload.size() >= w->max_chunk_bytes) {
    return w->FlushChunk();
  }
  return 0;
}

int pttrio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = w->FlushChunk();
  fclose(w->f);
  delete w;
  return rc;
}

void* pttrio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// Returns record length (>=0) with *out pointing at an internal buffer valid
// until the next call; -1 on EOF; -2 on corruption.
long pttrio_scanner_next(void* handle, const char** out) {
  // exceptions (bad_alloc on corrupt sizes) must not unwind through the
  // ctypes FFI frame — report corruption instead
  try {
    Scanner* s = static_cast<Scanner*>(handle);
    while (s->remaining == 0) {
      int rc = s->LoadChunk();
      if (rc != 0) return rc;
    }
    if (s->cursor + 4 > s->payload.size()) return -2;
    uint32_t len = 0;
    memcpy(&len, s->payload.data() + s->cursor, 4);
    s->cursor += 4;
    if (s->cursor + len > s->payload.size()) return -2;
    s->record.assign(s->payload.data() + s->cursor, len);
    s->cursor += len;
    s->remaining--;
    *out = s->record.data();
    return static_cast<long>(len);
  } catch (...) {
    return -2;
  }
}

void pttrio_scanner_close(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
