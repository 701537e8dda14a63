// Read-only LMDB environment parser (no liblmdb dependency).
//
// The LSUN datasets ship as LMDB databases (reference
// `workspace/data/dataset.py:28-185` opens them via the `lmdb` python
// package). Neither the package nor liblmdb is available in this image, so
// this implements the documented on-disk format directly: memory-map
// `data.mdb`, pick the newer of the two meta pages, and serve point reads /
// ordered key scans by walking the main database's B+tree. Read-only and
// single-snapshot by design — exactly the access pattern of the data
// pipeline (the reference also opens with readonly=1, lock=0).
//
// On-disk format (LMDB 0.9 "data version 1", 64-bit):
//   page header (16 bytes): pgno u64 | pad u16 | flags u16 | lower u16,
//     upper u16 (or overflow-page count u32)
//   meta page (pages 0 and 1): header, then magic 0xBEEFC0DE u32, version
//     u32, address u64, mapsize u64, dbs[2] (48 bytes each: pad u32, flags
//     u16, depth u16, branch_pages u64, leaf_pages u64, overflow_pages u64,
//     entries u64, root u64), last_pg u64, txnid u64. dbs[0] is the free
//     DB; its `pad` field holds the page size, dbs[1] is the main DB.
//   node (branch/leaf): lo u16 | hi u16 | flags u16 | ksize u16 | key...
//     branch: child pgno = lo | hi<<16 | flags<<32
//     leaf:   value size = lo | hi<<16; F_BIGDATA(0x01) => payload is a u64
//             overflow pgno, value bytes start at that page's header end and
//             run contiguously across its `pages` overflow pages.
//   Keys are compared as unsigned bytes, shorter-is-smaller on prefix ties.
//
// C ABI (ctypes binding: damc_tpu/data/native_lmdb.py):
//   void*    damc_lmdb_open(const char* path, char* err, size_t errlen)
//   uint64_t damc_lmdb_entries(void* env)
//   int      damc_lmdb_get(void* env, const uint8_t* key, size_t klen,
//                          const uint8_t** val, uint64_t* vlen)
//   int64_t  damc_lmdb_keys_size(void* env)   // total key bytes (caches scan)
//   int64_t  damc_lmdb_keys_fill(void* env, uint8_t* blob, uint32_t* lens)
//   void     damc_lmdb_error(void* env, char* buf, size_t buflen)
//   void     damc_lmdb_close(void* env)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr size_t kPageHdr = 16;
constexpr uint64_t kInvalidPgno = ~0ULL;

constexpr uint16_t P_BRANCH = 0x01, P_LEAF = 0x02, P_OVERFLOW = 0x04,
                   P_META = 0x08, P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01, F_DUPDATA = 0x04;

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t file_size = 0;
  uint32_t psize = 0;
  uint16_t depth = 0;
  uint64_t entries = 0;
  uint64_t root = kInvalidPgno;
  std::string err;
  // ctypes releases the GIL around foreign calls, so concurrent reads are
  // real: the scan cache is built once under a mutex, and the (error-path
  // only) err string is written under the same lock.
  std::mutex mu;
  std::atomic<bool> keys_cached{false};
  std::string key_blob;
  std::vector<uint32_t> key_lens;

  ~Env() {
    if (map) munmap(const_cast<uint8_t*>(map), file_size);
    if (fd >= 0) close(fd);
  }

  bool fail(const std::string& m) {
    std::lock_guard<std::mutex> lk(mu);
    err = m;
    return false;
  }

  const uint8_t* page(uint64_t pgno) {
    // Division-based bound: (pgno + 1) * psize can wrap uint64 for corrupt
    // 48-bit pgnos (branch nodes encode up to 2^48), defeating a
    // multiplication check.
    if (pgno == kInvalidPgno || psize == 0 || pgno >= file_size / psize) return nullptr;
    return map + pgno * psize;
  }

  bool open(const char* path) {
    struct stat st;
    std::string file = path;
    if (stat(path, &st) != 0) return fail("cannot stat " + file);
    if (S_ISDIR(st.st_mode)) {
      file += "/data.mdb";
      if (stat(file.c_str(), &st) != 0) return fail("no data.mdb under " + std::string(path));
    }
    fd = ::open(file.c_str(), O_RDONLY);
    if (fd < 0) return fail("cannot open " + file);
    file_size = (size_t)st.st_size;
    if (file_size < 2 * 512) return fail("file too small for two meta pages: " + file);
    void* m = mmap(nullptr, file_size, PROT_READ, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return fail("mmap failed: " + file);
    map = (const uint8_t*)m;

    // Both meta candidates live at byte offsets 0 and psize; psize itself is
    // recorded inside the meta (dbs[0].pad). Probe with the minimum page
    // size, then re-read meta 1 at the recorded size.
    const uint8_t* best = nullptr;
    uint64_t best_txn = 0;
    uint32_t ps = 0;
    for (int attempt = 0; attempt < 2; ++attempt) {
      uint32_t stride = (attempt == 0 || ps == 0) ? 4096 : ps;
      best = nullptr;
      for (int i = 0; i < 2; ++i) {
        const uint8_t* p = map + (size_t)i * stride;
        if ((size_t)(p - map) + kPageHdr + 136 > file_size) continue;
        const uint8_t* meta = p + kPageHdr;
        if (rd<uint32_t>(meta + 0) != kMagic) continue;
        if (rd<uint32_t>(meta + 4) != kVersion) continue;
        uint64_t txn = rd<uint64_t>(meta + 128);
        if (!best || txn >= best_txn) {
          best = meta;
          best_txn = txn;
        }
      }
      if (!best) return fail("no valid LMDB meta page (bad magic/version): " + file);
      ps = rd<uint32_t>(best + 24);  // dbs[0].pad == page size
      if (ps == 4096 || attempt == 1) break;
      if (ps < 512 || ps > (1u << 20) || (ps & (ps - 1)))
        return fail("implausible page size in meta: " + std::to_string(ps));
    }
    // Re-validate after the loop: attempt 1 re-reads ps from the
    // newer-stride meta and must not accept a corrupt value verbatim.
    if (ps < 512 || ps > (1u << 20) || (ps & (ps - 1)))
      return fail("implausible page size in meta: " + std::to_string(ps));
    psize = ps;
    const uint8_t* main_db = best + 72;
    depth = rd<uint16_t>(main_db + 6);
    entries = rd<uint64_t>(main_db + 32);
    root = rd<uint64_t>(main_db + 40);
    if (root != kInvalidPgno && !page(root)) return fail("main DB root out of range");
    return true;
  }

  static int cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
    int c = std::memcmp(a, b, alen < blen ? alen : blen);
    if (c) return c;
    return alen < blen ? -1 : (alen > blen ? 1 : 0);
  }

  size_t nkeys(const uint8_t* p) {
    // Clamp against psize: a corrupt `lower` (up to 0xFFFF) would otherwise
    // send node() reading ptr-array slots far past the page / mmap end.
    uint16_t lower = rd<uint16_t>(p + 12);
    if (lower < kPageHdr || lower > psize) return 0;
    return (lower - kPageHdr) >> 1;
  }

  const uint8_t* node(const uint8_t* p, size_t i, bool* ok) {
    uint16_t off = rd<uint16_t>(p + kPageHdr + 2 * i);
    if (off < kPageHdr || (size_t)off + 8 > psize) {
      *ok = false;
      return nullptr;
    }
    return p + off;
  }

  // Descend to the leaf that would contain `key`. Every failure path sets
  // env err (via fail) so the Python binding's OSError names the corruption
  // instead of surfacing an empty message.
  const uint8_t* find_leaf(const uint8_t* key, size_t klen) {
    const uint8_t* p = page(root);
    if (!p) {
      fail("root page out of range during descent");
      return nullptr;
    }
    for (int level = 0; level < 64; ++level) {
      uint16_t flags = rd<uint16_t>(p + 10);
      if (flags & P_LEAF) return p;
      if (!(flags & P_BRANCH)) {
        fail("unexpected page flags during descent (not branch/leaf)");
        return nullptr;
      }
      size_t n = nkeys(p);
      if (n == 0) {
        fail("empty branch page during descent");
        return nullptr;
      }
      // Node 0's key is implicit -inf; binary search for the last node
      // whose key <= target.
      size_t lo = 1, hi = n, best = 0;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        bool ok = true;
        const uint8_t* nd = node(p, mid, &ok);
        if (!ok) {
          fail("branch node offset out of range during descent");
          return nullptr;
        }
        uint16_t ks = rd<uint16_t>(nd + 6);
        if ((size_t)(nd - p) + 8 + ks > psize) {
          fail("branch node key exceeds page during descent");
          return nullptr;
        }
        if (cmp(nd + 8, ks, key, klen) <= 0) {
          best = mid;
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      bool ok = true;
      const uint8_t* nd = node(p, best, &ok);
      if (!ok) {
        fail("branch node offset out of range during descent");
        return nullptr;
      }
      uint64_t child = (uint64_t)rd<uint16_t>(nd + 0) |
                       ((uint64_t)rd<uint16_t>(nd + 2) << 16) |
                       ((uint64_t)rd<uint16_t>(nd + 4) << 32);
      p = page(child);
      if (!p) {
        fail("child page out of range during descent");
        return nullptr;
      }
    }
    fail("B+tree too deep during descent (cycle?)");
    return nullptr;
  }

  // val/vlen point into the map (zero-copy); caller copies.
  int get(const uint8_t* key, size_t klen, const uint8_t** val, uint64_t* vlen) {
    if (root == kInvalidPgno) return 0;
    const uint8_t* leaf = find_leaf(key, klen);
    if (!leaf) return -1;
    if (rd<uint16_t>(leaf + 10) & P_LEAF2) {
      fail("LEAF2 (DUPFIXED) pages unsupported");
      return -1;
    }
    size_t n = nkeys(leaf);
    size_t lo = 0, hi = n;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      bool ok = true;
      const uint8_t* nd = node(leaf, mid, &ok);
      if (!ok) {
        fail("leaf node offset out of range");
        return -1;
      }
      uint16_t ks = rd<uint16_t>(nd + 6);
      if ((size_t)(nd - leaf) + 8 + ks > psize) {
        fail("leaf node key exceeds page");
        return -1;
      }
      int c = cmp(nd + 8, ks, key, klen);
      if (c == 0) return read_value(nd, val, vlen) ? 1 : -1;
      if (c < 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    return 0;
  }

  bool read_value(const uint8_t* nd, const uint8_t** val, uint64_t* vlen) {
    uint16_t nflags = rd<uint16_t>(nd + 4);
    uint16_t ks = rd<uint16_t>(nd + 6);
    uint64_t dsize = (uint64_t)rd<uint16_t>(nd + 0) | ((uint64_t)rd<uint16_t>(nd + 2) << 16);
    const uint8_t* data = nd + 8 + ks;
    if (nflags & F_DUPDATA) return fail("duplicate-key (DUPSORT) values unsupported");
    if (nflags & F_BIGDATA) {
      if ((size_t)(data - map) + 8 > file_size) return fail("overflow pgno out of range");
      uint64_t ovpg = rd<uint64_t>(data);
      const uint8_t* op = page(ovpg);
      if (!op) return fail("overflow page out of range");
      if (!(rd<uint16_t>(op + 10) & P_OVERFLOW)) return fail("expected overflow page");
      uint32_t npages = rd<uint32_t>(op + 12);
      uint64_t total_pages = file_size / psize;
      if (npages == 0 || ovpg >= total_pages || npages > total_pages - ovpg ||
          dsize > (uint64_t)npages * psize - kPageHdr)
        return fail("overflow run exceeds file");
      *val = op + kPageHdr;
      *vlen = dsize;
      return true;
    }
    if ((size_t)(data - map) + dsize > file_size) return fail("value exceeds file");
    *val = data;
    *vlen = dsize;
    return true;
  }

  // In-order key scan (caches blob + lengths on the handle).
  bool scan_keys() {
    if (keys_cached.load(std::memory_order_acquire)) return true;
    std::lock_guard<std::mutex> lk(scan_mu);
    if (keys_cached.load(std::memory_order_acquire)) return true;
    key_blob.clear();
    key_lens.clear();
    if (root != kInvalidPgno && !walk(root, 0)) return false;
    // The binding sizes its buffers from the meta's entry count; a corrupt
    // tree must fail here rather than overrun them.
    if (key_lens.size() != entries)
      return fail("scanned key count " + std::to_string(key_lens.size()) +
                  " != meta entries " + std::to_string(entries));
    keys_cached.store(true, std::memory_order_release);
    return true;
  }
  std::mutex scan_mu;

  bool walk(uint64_t pgno, int level) {
    if (level > 64) return fail("B+tree too deep (cycle?)");
    const uint8_t* p = page(pgno);
    if (!p) return fail("page out of range during scan");
    uint16_t flags = rd<uint16_t>(p + 10);
    size_t n = nkeys(p);
    if (flags & P_LEAF2) return fail("LEAF2 pages unsupported");
    for (size_t i = 0; i < n; ++i) {
      bool ok = true;
      const uint8_t* nd = node(p, i, &ok);
      if (!ok) return fail("node offset out of range");
      if (flags & P_BRANCH) {
        uint64_t child = (uint64_t)rd<uint16_t>(nd + 0) |
                         ((uint64_t)rd<uint16_t>(nd + 2) << 16) |
                         ((uint64_t)rd<uint16_t>(nd + 4) << 32);
        if (!walk(child, level + 1)) return false;
      } else if (flags & P_LEAF) {
        uint16_t ks = rd<uint16_t>(nd + 6);
        if ((size_t)(nd + 8 - map) + ks > file_size) return fail("key exceeds file");
        key_blob.append((const char*)(nd + 8), ks);
        key_lens.push_back(ks);
      } else {
        return fail("unexpected page flags during scan");
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* damc_lmdb_open(const char* path, char* err, size_t errlen) {
  Env* env = new Env();
  if (!env->open(path)) {
    if (err && errlen) std::snprintf(err, errlen, "%s", env->err.c_str());
    delete env;
    return nullptr;
  }
  return env;
}

uint64_t damc_lmdb_entries(void* h) { return ((Env*)h)->entries; }

int damc_lmdb_get(void* h, const uint8_t* key, size_t klen, const uint8_t** val,
                  uint64_t* vlen) {
  return ((Env*)h)->get(key, klen, val, vlen);
}

int64_t damc_lmdb_keys_size(void* h) {
  Env* env = (Env*)h;
  if (!env->scan_keys()) return -1;
  return (int64_t)env->key_blob.size();
}

int64_t damc_lmdb_keys_fill(void* h, uint8_t* blob, uint32_t* lens) {
  Env* env = (Env*)h;
  if (!env->scan_keys()) return -1;
  std::memcpy(blob, env->key_blob.data(), env->key_blob.size());
  std::memcpy(lens, env->key_lens.data(), env->key_lens.size() * sizeof(uint32_t));
  return (int64_t)env->key_lens.size();
}

void damc_lmdb_error(void* h, char* buf, size_t buflen) {
  // Snapshot under the same lock fail() writes under: returning c_str()
  // raced concurrent error writes from other reader threads (the string's
  // buffer can be reallocated mid-copy on the Python side).
  Env* env = (Env*)h;
  std::lock_guard<std::mutex> lk(env->mu);
  if (buf && buflen) std::snprintf(buf, buflen, "%s", env->err.c_str());
}

void damc_lmdb_close(void* h) { delete (Env*)h; }

}  // extern "C"
