// Native scenario-stream data loader.
//
// Runtime component with no reference counterpart (the reference
// generates data in PHP userland one rand() call at a time,
// /root/reference/src/initializers.c:517-590): large MPC sweeps (BASELINE
// config #5, 65k scenarios) need disturbance/initial-state batches produced
// CONCURRENTLY with device compute. This is a multi-threaded ring-buffer
// generator: worker threads fill 64-byte-aligned fp32 slots (xoshiro128+ +
// Box-Muller, deterministic per (seed, batch_index)), the Python side maps
// ready slots zero-copy via numpy and hands them to jax.device_put while the
// next batch generates in the background.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Xoshiro128 {
  uint32_t s[4];
  explicit Xoshiro128(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed;
    for (int i = 0; i < 4; i++) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = static_cast<uint32_t>((t ^ (t >> 31)) >> 16);
    }
  }
  static uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }
  uint32_t next() {
    uint32_t result = s[0] + s[3];
    uint32_t t = s[1] << 9;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 11);
    return result;
  }
  float uniform01() {  // [0, 1)
    return (next() >> 8) * (1.0f / 16777216.0f);
  }
};

enum class Dist : int32_t { kNormal = 0, kUniform = 1 };

struct Slot {
  float* data = nullptr;
  std::atomic<int64_t> batch_index{-1};  // which batch this slot holds
  bool ready = false;
  bool in_use = false;
};

struct Stream {
  int64_t batch = 0;        // scenarios per batch
  int64_t dim = 0;          // flattened per-scenario size
  uint64_t seed = 0;
  Dist dist = Dist::kNormal;
  float scale = 1.0f;
  int n_slots = 0;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for a ready slot
  std::condition_variable cv_free;    // producer waits for a free slot
  int64_t next_to_produce = 0;        // batch index to generate next
  int64_t next_to_consume = 0;        // batch index the consumer wants next
  bool stopping = false;

  ~Stream() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    for (auto& s : slots) free(s.data);
  }
};

void fill_batch(Stream* st, float* dst, int64_t batch_index) {
  // Deterministic per (seed, batch_index) regardless of thread scheduling.
  const int64_t total = st->batch * st->dim;
  Xoshiro128 rng(st->seed * 0x9e3779b97f4a7c15ULL + static_cast<uint64_t>(batch_index) + 1);
  if (st->dist == Dist::kUniform) {
    // centered uniform U[-scale, scale)
    for (int64_t i = 0; i < total; i++)
      dst[i] = st->scale * (2.0f * rng.uniform01() - 1.0f);
  } else {
    // Box-Muller, pairwise
    int64_t i = 0;
    while (i < total) {
      float u1 = rng.uniform01();
      float u2 = rng.uniform01();
      if (u1 < 1e-12f) u1 = 1e-12f;
      float r = std::sqrt(-2.0f * std::log(u1));
      float a = 6.28318530718f * u2;
      dst[i++] = st->scale * r * std::cos(a);
      if (i < total) dst[i++] = st->scale * r * std::sin(a);
    }
  }
}

void worker_loop(Stream* st) {
  for (;;) {
    Slot* slot = nullptr;
    int64_t my_batch = -1;
    {
      std::unique_lock<std::mutex> lock(st->mu);
      st->cv_free.wait(lock, [&] {
        if (st->stopping) return true;
        for (auto& s : st->slots) {
          if (!s.ready && !s.in_use) return true;
        }
        return false;
      });
      if (st->stopping) return;
      for (auto& s : st->slots) {
        if (!s.ready && !s.in_use) {
          slot = &s;
          s.in_use = true;  // claimed for production
          my_batch = st->next_to_produce++;
          break;
        }
      }
    }
    fill_batch(st, slot->data, my_batch);
    {
      std::lock_guard<std::mutex> lock(st->mu);
      slot->batch_index.store(my_batch);
      slot->ready = true;
      slot->in_use = false;
    }
    st->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* nptpu_stream_create(int64_t batch, int64_t dim, uint64_t seed,
                          int32_t dist, float scale, int32_t n_slots,
                          int32_t n_threads) {
  auto* st = new Stream();
  st->batch = batch;
  st->dim = dim;
  st->seed = seed;
  st->dist = static_cast<Dist>(dist);
  st->scale = scale;
  st->n_slots = n_slots;
  st->slots = std::vector<Slot>(n_slots);
  for (auto& s : st->slots) {
    void* p = nullptr;
    if (posix_memalign(&p, 64, sizeof(float) * batch * dim) != 0) {
      delete st;
      return nullptr;
    }
    s.data = static_cast<float*>(p);
  }
  for (int i = 0; i < n_threads; i++) {
    st->workers.emplace_back(worker_loop, st);
  }
  return st;
}

// Blocks until the next sequential batch is ready; returns slot index and
// writes the batch index. Returns -1 on shutdown.
int32_t nptpu_stream_acquire(void* handle, int64_t* batch_index_out) {
  auto* st = static_cast<Stream*>(handle);
  std::unique_lock<std::mutex> lock(st->mu);
  int32_t found = -1;
  st->cv_ready.wait(lock, [&] {
    if (st->stopping) return true;
    for (int i = 0; i < st->n_slots; i++) {
      if (st->slots[i].ready &&
          st->slots[i].batch_index.load() == st->next_to_consume) {
        found = i;
        return true;
      }
    }
    return false;
  });
  if (st->stopping || found < 0) return -1;
  st->slots[found].in_use = true;  // consumer holds it
  *batch_index_out = st->next_to_consume++;
  return found;
}

float* nptpu_stream_data(void* handle, int32_t slot) {
  auto* st = static_cast<Stream*>(handle);
  return st->slots[slot].data;
}

void nptpu_stream_release(void* handle, int32_t slot) {
  auto* st = static_cast<Stream*>(handle);
  {
    std::lock_guard<std::mutex> lock(st->mu);
    st->slots[slot].ready = false;
    st->slots[slot].in_use = false;
    st->slots[slot].batch_index.store(-1);
  }
  st->cv_free.notify_all();
}

void nptpu_stream_destroy(void* handle) {
  delete static_cast<Stream*>(handle);
}

}  // extern "C"
