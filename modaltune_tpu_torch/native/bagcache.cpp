// Packed feature-bag cache: native reader for the training hot path.
//
// The reference's data layer torch.load()s one pickle per slide per step
// (data_utils/datasets.py:218,234) — Python-side decode of ~150 MB bags.
// This replaces it with a single memory-mapped container holding every
// bag contiguously (fp32 features + coords), an O(1) index, and a
// zero-copy/memcpy read path with optional random subsampling done
// natively (the sorted-subsample semantics of datasets.py:274-281).
//
// File layout (little endian):
//   [0]   magic  "MTBC1\0\0\0"                      (8 bytes)
//   [8]   u64 n_bags
//   [16]  u64 feat_dim
//   [24]  per bag: u64 offset (bytes, from file start), u64 length (rows)
//   [...] payload per bag: features fp32 [len, feat_dim]
//                          coords   fp32 [len, 2]
//
// Exposed C API (ctypes):
//   void* bc_open(const char* path);
//   void  bc_close(void* h);
//   long  bc_count(void* h);
//   long  bc_dim(void* h);
//   long  bc_len(void* h, long i);
//   int   bc_read(void* h, long i, float* feat_out, float* coord_out);
//   int   bc_read_subsample(void* h, long i, long threshold, u64 seed,
//                           float* feat_out, float* coord_out,
//                           long* n_out);   // sorted random subsample

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'M', 'T', 'B', 'C', '1', 0, 0, 0};

struct Header {
  char magic[8];
  uint64_t n_bags;
  uint64_t feat_dim;
};

struct Entry {
  uint64_t offset;
  uint64_t length;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_bags = 0;
  uint64_t dim = 0;
  const Entry* index = nullptr;
};

// splitmix64: deterministic, seedable PRNG for subsampling
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

void* bc_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (long)sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const Header* h = reinterpret_cast<const Header*>(mem);
  if (memcmp(h->magic, kMagic, 8) != 0) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Cache* c = new Cache();
  c->fd = fd;
  c->base = reinterpret_cast<const uint8_t*>(mem);
  c->size = st.st_size;
  c->n_bags = h->n_bags;
  c->dim = h->feat_dim;
  c->index = reinterpret_cast<const Entry*>(c->base + sizeof(Header));
  return c;
}

void bc_close(void* handle) {
  if (!handle) return;
  Cache* c = static_cast<Cache*>(handle);
  munmap(const_cast<uint8_t*>(c->base), c->size);
  ::close(c->fd);
  delete c;
}

long bc_count(void* handle) {
  return handle ? (long)static_cast<Cache*>(handle)->n_bags : -1;
}

long bc_dim(void* handle) {
  return handle ? (long)static_cast<Cache*>(handle)->dim : -1;
}

long bc_len(void* handle, long i) {
  Cache* c = static_cast<Cache*>(handle);
  if (!c || i < 0 || (uint64_t)i >= c->n_bags) return -1;
  return (long)c->index[i].length;
}

int bc_read(void* handle, long i, float* feat_out, float* coord_out) {
  Cache* c = static_cast<Cache*>(handle);
  if (!c || i < 0 || (uint64_t)i >= c->n_bags) return -1;
  const Entry& e = c->index[i];
  const float* feat =
      reinterpret_cast<const float*>(c->base + e.offset);
  const float* coords = feat + e.length * c->dim;
  memcpy(feat_out, feat, e.length * c->dim * sizeof(float));
  memcpy(coord_out, coords, e.length * 2 * sizeof(float));
  return 0;
}

// Sorted random subsample to `threshold` rows (Fisher-Yates partial
// shuffle over indices, then sort — matches the reference's
// randperm[:threshold].sort() semantics with a different RNG).
int bc_read_subsample(void* handle, long i, long threshold, uint64_t seed,
                      float* feat_out, float* coord_out, long* n_out) {
  Cache* c = static_cast<Cache*>(handle);
  if (!c || i < 0 || (uint64_t)i >= c->n_bags) return -1;
  const Entry& e = c->index[i];
  const long n = (long)e.length;
  const float* feat =
      reinterpret_cast<const float*>(c->base + e.offset);
  const float* coords = feat + e.length * c->dim;
  if (threshold <= 0 || n <= threshold) {
    memcpy(feat_out, feat, n * c->dim * sizeof(float));
    memcpy(coord_out, coords, n * 2 * sizeof(float));
    *n_out = n;
    return 0;
  }
  std::vector<uint32_t> idx(n);
  for (long j = 0; j < n; ++j) idx[j] = (uint32_t)j;
  uint64_t s = seed ^ (0xabcdef12345678ULL + (uint64_t)i);
  for (long j = 0; j < threshold; ++j) {
    const long r = j + (long)(splitmix64(s) % (uint64_t)(n - j));
    std::swap(idx[j], idx[r]);
  }
  idx.resize(threshold);
  std::sort(idx.begin(), idx.end());
  const long d = (long)c->dim;
  for (long j = 0; j < threshold; ++j) {
    memcpy(feat_out + j * d, feat + (long)idx[j] * d, d * sizeof(float));
    coord_out[j * 2] = coords[(long)idx[j] * 2];
    coord_out[j * 2 + 1] = coords[(long)idx[j] * 2 + 1];
  }
  *n_out = threshold;
  return 0;
}

}  // extern "C"
