// Native host-side data pipeline for bayesian_torch_tpu_torch (the port's
// copy of bayesian_torch_tpu/data/csrc/loader.cpp; the same epoch order).
//
// The reference delegates batching/shuffling/prefetch to torch's C++
// DataLoader worker machinery; this is the host-side equivalent: a small
// C++ library (loaded via ctypes) that shuffles per epoch, gathers and
// optionally normalizes batches on background threads, and hands them
// to Python through a bounded reorder buffer so host batch prep
// overlaps device compute. Epochs are deterministic per seed.
//
// C ABI only: loaded with ctypes, built without Python or torch headers.

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
  std::vector<float> x;
  std::vector<int32_t> y;
};

struct Loader {
  // dataset view (borrowed; Python keeps the arrays alive)
  const float* x = nullptr;
  const int32_t* y = nullptr;
  int64_t n = 0;
  int64_t item_size = 0;  // floats per example
  int64_t batch_size = 0;
  bool shuffle = true;
  bool drop_last = true;
  float scale = 1.0f;  // x_out = (x - shift) * scale
  float shift = 0.0f;
  uint64_t seed = 0;

  // epoch state
  std::vector<int64_t> order;
  std::atomic<int64_t> next_claim{0};
  int64_t num_batches = 0;
  int64_t epoch = 0;

  // reorder buffer: batch_index -> Batch
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::map<int64_t, Batch> ready;
  size_t max_ready = 4;
  int64_t pop_cursor = 0;

  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void reshuffle() {
    order.resize(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed +
                          static_cast<uint64_t>(epoch) * 0x9E3779B9ULL);
      for (int64_t i = n - 1; i > 0; --i) {
        std::uniform_int_distribution<int64_t> d(0, i);
        std::swap(order[i], order[d(rng)]);
      }
    }
  }

  Batch produce(int64_t b) const {
    Batch batch;
    int64_t start = b * batch_size;
    int64_t count = std::min(batch_size, n - start);
    batch.x.resize(count * item_size);
    batch.y.resize(count);
    for (int64_t i = 0; i < count; ++i) {
      int64_t src = order[start + i];
      const float* src_ptr = x + src * item_size;
      float* dst = batch.x.data() + i * item_size;
      if (scale == 1.0f && shift == 0.0f) {
        std::memcpy(dst, src_ptr, item_size * sizeof(float));
      } else {
        for (int64_t j = 0; j < item_size; ++j)
          dst[j] = (src_ptr[j] - shift) * scale;
      }
      batch.y[i] = y ? y[src] : 0;
    }
    return batch;
  }

  void worker() {
    for (;;) {
      if (stop.load()) return;
      int64_t b = next_claim.fetch_add(1);
      if (b >= num_batches) return;
      Batch batch = produce(b);
      std::unique_lock<std::mutex> lk(mu);
      // always admit the batch the consumer is waiting for, otherwise
      // respect the buffer bound (prevents reorder deadlock)
      cv_push.wait(lk, [&] {
        return stop.load() || ready.size() < max_ready ||
               b == pop_cursor;
      });
      if (stop.load()) return;
      ready.emplace(b, std::move(batch));
      cv_pop.notify_all();
    }
  }

  // epoch_seed makes the permutation a pure function of (seed,
  // epoch_seed) — required for deterministic --resume: a restarted
  // process must reproduce epoch k's batch order without having
  // iterated epochs 0..k-1 (an internal call counter would not)
  void start_epoch(int num_threads, int64_t epoch_seed) {
    join_workers();
    epoch = epoch_seed;
    reshuffle();
    num_batches = drop_last ? n / batch_size
                            : (n + batch_size - 1) / batch_size;
    next_claim.store(0);
    pop_cursor = 0;
    {
      std::lock_guard<std::mutex> lk(mu);
      ready.clear();
    }
    for (int t = 0; t < std::max(num_threads, 1); ++t)
      workers.emplace_back([this] { worker(); });
  }

  void join_workers() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
    stop.store(false);
  }

  int64_t pop(float* out_x, int32_t* out_y) {
    std::unique_lock<std::mutex> lk(mu);
    if (pop_cursor >= num_batches) return -1;
    cv_pop.wait(lk, [&] {
      return stop.load() || ready.count(pop_cursor) > 0;
    });
    if (stop.load()) return -1;
    auto it = ready.find(pop_cursor);
    Batch batch = std::move(it->second);
    ready.erase(it);
    ++pop_cursor;
    cv_push.notify_all();
    lk.unlock();
    std::memcpy(out_x, batch.x.data(), batch.x.size() * sizeof(float));
    std::memcpy(out_y, batch.y.data(), batch.y.size() * sizeof(int32_t));
    return static_cast<int64_t>(batch.y.size());
  }
};

}  // namespace

extern "C" {

void* bt_loader_create(const float* x, const int32_t* y, int64_t n,
                       int64_t item_size, int64_t batch_size, int shuffle,
                       int drop_last, float scale, float shift,
                       uint64_t seed, int64_t queue_depth) {
  auto* l = new Loader();
  l->x = x;
  l->y = y;
  l->n = n;
  l->item_size = item_size;
  l->batch_size = batch_size;
  l->shuffle = shuffle != 0;
  l->drop_last = drop_last != 0;
  l->scale = scale;
  l->shift = shift;
  l->seed = seed;
  l->max_ready = static_cast<size_t>(queue_depth > 0 ? queue_depth : 4);
  return l;
}

int64_t bt_loader_num_batches(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  return l->drop_last ? l->n / l->batch_size
                      : (l->n + l->batch_size - 1) / l->batch_size;
}

void bt_loader_start_epoch(void* handle, int num_threads,
                           int64_t epoch_seed) {
  static_cast<Loader*>(handle)->start_epoch(num_threads, epoch_seed);
}

// returns the number of examples written, or -1 when the epoch is done
int64_t bt_loader_next(void* handle, float* out_x, int32_t* out_y) {
  return static_cast<Loader*>(handle)->pop(out_x, out_y);
}

void bt_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->join_workers();
  delete l;
}

}  // extern "C"
