// packio: mmap-backed packed-shard dataset IO (the port's own copy of
// the JAX package's shard library; the file format is the same, so a
// shard written by either package reads back in the other).
//
// A shard is a single immutable file:
//
//   [u64 magic][u64 count][index: count * {u64 key_off, u64 key_len,
//    u64 val_off, u64 val_len}][key bytes...][value blobs...]
//
// Readers mmap the file once; packio_get returns a pointer straight
// into the page cache (no copy, no locking: shards are immutable).
// Host code with a plain C interface, loaded with ctypes by
// mrefsr_tpu_torch/data/packio.py, which builds it with g++ at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4f49'4b43'4150'0001ull;  // "PACKIO" v1

struct IndexEntry {
  uint64_t key_off;
  uint64_t key_len;
  uint64_t val_off;
  uint64_t val_len;
};

struct Writer {
  FILE* f = nullptr;
  std::string path;
  std::vector<std::string> keys;
  std::vector<std::pair<uint64_t, uint64_t>> vals;  // (off, len)
  uint64_t cursor = 0;  // bytes of value blobs written so far
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::unordered_map<std::string, std::pair<uint64_t, uint64_t>> index;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------- writer
void* packio_create(const char* path) {
  auto* w = new Writer();
  w->path = path;
  w->f = std::fopen((w->path + ".tmp").c_str(), "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  return w;
}

int packio_add(void* handle, const char* key, const uint8_t* data,
               uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  if (std::fwrite(data, 1, len, w->f) != len) return -1;
  w->keys.emplace_back(key);
  w->vals.emplace_back(w->cursor, len);
  w->cursor += len;
  return 0;
}

// Assemble the final shard: header + index + keys + blob file contents.
int packio_finish(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  std::fclose(w->f);
  w->f = nullptr;

  const uint64_t count = w->keys.size();
  uint64_t keys_bytes = 0;
  for (const auto& k : w->keys) keys_bytes += k.size();
  const uint64_t header = 2 * sizeof(uint64_t);
  const uint64_t index_bytes = count * sizeof(IndexEntry);
  const uint64_t keys_base = header + index_bytes;
  const uint64_t vals_base = keys_base + keys_bytes;

  FILE* out = std::fopen(w->path.c_str(), "wb");
  if (!out) return -1;
  uint64_t head[2] = {kMagic, count};
  std::fwrite(head, sizeof(uint64_t), 2, out);

  uint64_t key_cursor = keys_base;
  for (uint64_t i = 0; i < count; ++i) {
    IndexEntry e{key_cursor, w->keys[i].size(),
                 vals_base + w->vals[i].first, w->vals[i].second};
    std::fwrite(&e, sizeof(IndexEntry), 1, out);
    key_cursor += w->keys[i].size();
  }
  for (const auto& k : w->keys)
    std::fwrite(k.data(), 1, k.size(), out);

  // append blobs from the tmp file in 8 MiB chunks
  FILE* tmp = std::fopen((w->path + ".tmp").c_str(), "rb");
  if (!tmp) {
    std::fclose(out);
    return -1;
  }
  std::vector<uint8_t> buf(8u << 20);
  size_t n;
  while ((n = std::fread(buf.data(), 1, buf.size(), tmp)) > 0)
    std::fwrite(buf.data(), 1, n, out);
  std::fclose(tmp);
  std::fclose(out);
  std::remove((w->path + ".tmp").c_str());
  delete w;
  return 0;
}

// ------------------------------------------------------------- reader
void* packio_open(const char* path) {
  auto* r = new Reader();
  r->fd = ::open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, r->size, PROT_READ, MAP_SHARED, r->fd, 0);
  if (m == MAP_FAILED) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->base = static_cast<const uint8_t*>(m);

  const uint64_t* head = reinterpret_cast<const uint64_t*>(r->base);
  if (r->size < 16 || head[0] != kMagic) {
    munmap(const_cast<uint8_t*>(r->base), r->size);
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  const uint64_t count = head[1];
  const auto* idx =
      reinterpret_cast<const IndexEntry*>(r->base + 16);
  r->index.reserve(count);
  for (uint64_t i = 0; i < count; ++i) {
    std::string key(reinterpret_cast<const char*>(r->base)
                        + idx[i].key_off,
                    idx[i].key_len);
    r->index.emplace(std::move(key),
                     std::make_pair(idx[i].val_off, idx[i].val_len));
  }
  return r;
}

uint64_t packio_count(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? r->index.size() : 0;
}

// Returns a pointer into the mmap (valid until packio_close) and sets
// *len; nullptr if the key is absent.
const uint8_t* packio_get(void* handle, const char* key, uint64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return nullptr;
  auto it = r->index.find(key);
  if (it == r->index.end()) {
    *len = 0;
    return nullptr;
  }
  *len = it->second.second;
  return r->base + it->second.first;
}

// Copy all keys, newline-separated, into the caller buffer (returns the
// needed size; call with buf=nullptr first to size it).
uint64_t packio_keys(void* handle, char* buf, uint64_t buf_len) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return 0;
  uint64_t need = 0;
  for (const auto& kv : r->index) need += kv.first.size() + 1;
  if (!buf || buf_len < need) return need;
  char* p = buf;
  for (const auto& kv : r->index) {
    std::memcpy(p, kv.first.data(), kv.first.size());
    p += kv.first.size();
    *p++ = '\n';
  }
  return need;
}

void packio_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
