// Native batch-preparation engine for the DAMC data pipeline.
//
// The reference's data path is a single-threaded torchvision DataLoader with
// num_workers=0 (train_gen_recon.py:109) — per-sample Python transforms on
// the critical path. This engine instead prepares whole training batches
// (epoch shuffling, random horizontal flip, uint8 -> float32 [-1, 1]
// normalization) with a pool of C++ worker threads and a prefetch ring, so
// the host-side feed never stalls the TPU step.
//
// Exposed as a plain C API consumed from Python via ctypes
// (damc_tpu/data/native_loader.py). The image store is a caller-owned
// contiguous uint8 array (N, H, W, C); the loader never copies it.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libbatch_loader.so batch_loader.cpp

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<float> data;
  std::vector<int64_t> indices;
};
// Batches are claimed under the mutex in a deterministic order but finish
// in scheduler-dependent order across workers; the ready buffer is keyed by
// claim sequence and the consumer waits for the NEXT sequence number, so a
// fixed seed yields the exact same batch stream regardless of thread count
// (matching the single-threaded NumPy Loader).

struct Loader {
  const uint8_t* images = nullptr;
  int64_t n = 0;
  int64_t sample_elems = 0;  // H * W * C
  int64_t row_elems = 0;     // W * C (for horizontal flip)
  int64_t channels = 0;
  int batch_size = 0;
  bool shuffle = true;
  bool flip = false;
  bool drop_last = true;
  int prefetch_depth = 4;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::map<uint64_t, Batch> ready;  // keyed by claim sequence
  std::atomic<bool> stop{false};
  uint64_t claim_seq = 0;  // next sequence to hand to a worker (guarded by mu)
  uint64_t serve_seq = 0;  // next sequence the consumer expects (guarded by mu)

  // Work distribution state (guarded by mu).
  std::vector<int64_t> order;
  std::mt19937_64 rng;
  int64_t cursor = 0;  // next sample offset within the epoch

  Loader(const uint8_t* imgs, int64_t n_, int64_t h, int64_t w, int64_t c,
         int bs, bool shuf, bool flp, bool drop, uint64_t seed, int threads,
         int depth)
      : images(imgs),
        n(n_),
        sample_elems(h * w * c),
        row_elems(w * c),
        channels(c),
        batch_size(bs),
        shuffle(shuf),
        flip(flp),
        drop_last(drop),
        prefetch_depth(depth),
        rng(seed) {
    order.resize(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    if (shuffle) std::shuffle(order.begin(), order.end(), rng);
    int nt = threads > 0 ? threads : 4;
    for (int t = 0; t < nt; ++t) {
      workers.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_producer.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) t.join();
  }

  // Claim the next batch worth of indices; wraps epochs (infinite stream).
  bool ClaimIndices(std::vector<int64_t>* idx, uint64_t* flip_seed,
                    uint64_t* seq) {
    std::lock_guard<std::mutex> lock(mu);
    if (stop) return false;
    if (cursor + batch_size > n) {
      // next epoch (drop_last semantics: the tail is discarded)
      if (shuffle) std::shuffle(order.begin(), order.end(), rng);
      cursor = 0;
    }
    idx->assign(order.begin() + cursor, order.begin() + cursor + batch_size);
    cursor += batch_size;
    *flip_seed = rng();
    *seq = claim_seq++;
    return true;
  }

  void WorkerLoop() {
    while (true) {
      {
        // Backpressure: wait until the ring has room.
        std::unique_lock<std::mutex> lock(mu);
        cv_producer.wait(lock, [this] {
          return stop || (int)ready.size() < prefetch_depth;
        });
        if (stop) return;
      }
      std::vector<int64_t> idx;
      uint64_t flip_seed, seq;
      if (!ClaimIndices(&idx, &flip_seed, &seq)) return;

      Batch b;
      b.indices = idx;
      b.data.resize((size_t)batch_size * sample_elems);
      std::mt19937_64 frng(flip_seed);
      constexpr float kScale = 2.0f / 255.0f;
      const int64_t rows = sample_elems / row_elems;
      for (int i = 0; i < batch_size; ++i) {
        const uint8_t* src = images + idx[i] * sample_elems;
        float* dst = b.data.data() + (size_t)i * sample_elems;
        bool do_flip = flip && (frng() & 1);
        if (!do_flip) {
          for (int64_t e = 0; e < sample_elems; ++e)
            dst[e] = src[e] * kScale - 1.0f;
        } else {
          for (int64_t r = 0; r < rows; ++r) {
            const uint8_t* srow = src + r * row_elems;
            float* drow = dst + r * row_elems;
            const int64_t w = row_elems / channels;
            for (int64_t x = 0; x < w; ++x) {
              const uint8_t* spix = srow + (w - 1 - x) * channels;
              float* dpix = drow + x * channels;
              for (int64_t ch = 0; ch < channels; ++ch)
                dpix[ch] = spix[ch] * kScale - 1.0f;
            }
          }
        }
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        if (stop) return;
        ready.emplace(seq, std::move(b));
      }
      cv_consumer.notify_all();
    }
  }

  // Blocking pop of the next prepared batch into caller buffers.
  bool Next(float* out, int64_t* out_idx) {
    Batch b;
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_consumer.wait(lock, [this] {
        return stop || ready.count(serve_seq) != 0;
      });
      if (stop && ready.count(serve_seq) == 0) return false;
      auto it = ready.find(serve_seq);
      b = std::move(it->second);
      ready.erase(it);
      ++serve_seq;
    }
    cv_producer.notify_all();
    std::memcpy(out, b.data.data(), b.data.size() * sizeof(float));
    if (out_idx)
      std::memcpy(out_idx, b.indices.data(),
                  b.indices.size() * sizeof(int64_t));
    return true;
  }
};

}  // namespace

extern "C" {

void* damc_loader_create(const uint8_t* images, int64_t n, int64_t h,
                         int64_t w, int64_t c, int batch_size, int shuffle,
                         int flip, int drop_last, uint64_t seed, int threads,
                         int prefetch_depth) {
  // h/w/c must be positive: the worker computes sample_elems / row_elems,
  // and a zero-extent store would hit a hardware integer divide-by-zero
  // (SIGFPE kills the whole interpreter, not just the loader).
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return nullptr;
  if (batch_size <= 0 || batch_size > n) return nullptr;
  // drop_last=false is NOT implemented by this engine (fixed-size output
  // buffers; the tail would need a short batch). Reject it so callers fall
  // back to the NumPy Loader instead of silently getting drop_last
  // semantics anyway.
  if (!drop_last) return nullptr;
  if (prefetch_depth < 1) prefetch_depth = 1;
  return new Loader(images, n, h, w, c, batch_size, shuffle != 0, flip != 0,
                    drop_last != 0, seed, threads, prefetch_depth);
}

int damc_loader_next(void* handle, float* out, int64_t* out_indices) {
  if (!handle) return 0;
  return static_cast<Loader*>(handle)->Next(out, out_indices) ? 1 : 0;
}

void damc_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
