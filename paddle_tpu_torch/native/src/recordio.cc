// Chunked record file format — the TPU-native equivalent of the
// recordio files the reference's Go master partitions into tasks
// (reference: go/master/service.go:106 partition; go/cmd/master/master.go
// chunk-per-task flag). C ABI so Python binds via ctypes.
//
// File layout: a sequence of chunks.
//   chunk  := magic(u32) nrec(u32) body_len(u64) crc32(u32) body
//   body   := nrec * ( len(u32) bytes )
// Chunks are the unit of task partitioning: a reader can be opened on a
// [begin, end) chunk range so each task touches only its slice.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50544B52;  // "PTKR"

uint32_t crc32_update(uint32_t crc, const unsigned char* buf, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < len; i++) crc = table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<std::string> pending;
  size_t records_per_chunk = 1000;
  bool error = false;

  void flush_chunk() {
    if (pending.empty()) return;
    std::string body;
    for (const auto& r : pending) {
      uint32_t len = static_cast<uint32_t>(r.size());
      body.append(reinterpret_cast<const char*>(&len), 4);
      body.append(r);
    }
    uint32_t nrec = static_cast<uint32_t>(pending.size());
    uint64_t body_len = body.size();
    uint32_t crc = crc32_update(
        0, reinterpret_cast<const unsigned char*>(body.data()), body.size());
    if (fwrite(&kMagic, 4, 1, f) != 1 || fwrite(&nrec, 4, 1, f) != 1 ||
        fwrite(&body_len, 8, 1, f) != 1 || fwrite(&crc, 4, 1, f) != 1 ||
        (body_len && fwrite(body.data(), body.size(), 1, f) != 1)) {
      error = true;
    }
    pending.clear();
  }
};

struct Reader {
  FILE* f = nullptr;
  int64_t chunk_begin = 0, chunk_end = -1;  // -1 = unbounded
  int64_t chunk_idx = 0;
  std::vector<std::string> records;
  size_t rec_idx = 0;
  bool error = false;

  bool load_next_chunk() {
    for (;;) {
      if (chunk_end >= 0 && chunk_idx >= chunk_end) return false;
      uint32_t magic, nrec, crc;
      uint64_t body_len;
      if (fread(&magic, 4, 1, f) != 1) return false;  // eof
      if (magic != kMagic || fread(&nrec, 4, 1, f) != 1 ||
          fread(&body_len, 8, 1, f) != 1 || fread(&crc, 4, 1, f) != 1) {
        error = true;
        return false;
      }
      int64_t idx = chunk_idx++;
      if (idx < chunk_begin) {
        // seek past unwanted chunk bodies: O(slice) I/O per ranged task
        if (fseek(f, static_cast<long>(body_len), SEEK_CUR) != 0) {
          error = true;
          return false;
        }
        continue;
      }
      std::string body(body_len, '\0');
      if (body_len && fread(&body[0], body_len, 1, f) != 1) {
        error = true;
        return false;
      }
      if (crc32_update(0, reinterpret_cast<const unsigned char*>(body.data()),
                       body.size()) != crc) {
        error = true;
        return false;
      }
      records.clear();
      rec_idx = 0;
      size_t off = 0;
      for (uint32_t i = 0; i < nrec; i++) {
        if (off + 4 > body.size()) { error = true; return false; }
        uint32_t len;
        memcpy(&len, body.data() + off, 4);
        off += 4;
        if (off + len > body.size()) { error = true; return false; }
        records.emplace_back(body.data() + off, len);
        off += len;
      }
      return !records.empty() || nrec == 0;
    }
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, int records_per_chunk) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  if (records_per_chunk > 0) w->records_per_chunk = records_per_chunk;
  return w;
}

int rio_write(void* h, const char* data, uint64_t len) {
  auto* w = static_cast<Writer*>(h);
  w->pending.emplace_back(data, len);
  if (w->pending.size() >= w->records_per_chunk) w->flush_chunk();
  return w->error ? -1 : 0;
}

int rio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  w->flush_chunk();
  int rc = w->error ? -1 : 0;
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_reader_open(const char* path, int64_t chunk_begin,
                      int64_t chunk_end) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->chunk_begin = chunk_begin < 0 ? 0 : chunk_begin;
  r->chunk_end = chunk_end;
  return r;
}

// Returns record length, with *data pointing at storage valid until the
// next call; -1 on EOF, -2 on corruption.
int64_t rio_next(void* h, const char** data) {
  auto* r = static_cast<Reader*>(h);
  while (r->rec_idx >= r->records.size()) {
    if (!r->load_next_chunk()) return r->error ? -2 : -1;
  }
  const std::string& rec = r->records[r->rec_idx++];
  *data = rec.data();
  return static_cast<int64_t>(rec.size());
}

void rio_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  fclose(r->f);
  delete r;
}

int64_t rio_count_chunks(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  for (;;) {
    uint32_t magic, nrec, crc;
    uint64_t body_len;
    if (fread(&magic, 4, 1, f) != 1) break;
    if (magic != kMagic || fread(&nrec, 4, 1, f) != 1 ||
        fread(&body_len, 8, 1, f) != 1 || fread(&crc, 4, 1, f) != 1) {
      n = -2;
      break;
    }
    if (fseek(f, static_cast<long>(body_len), SEEK_CUR) != 0) {
      n = -2;
      break;
    }
    n++;
  }
  fclose(f);
  return n;
}

}  // extern "C"
