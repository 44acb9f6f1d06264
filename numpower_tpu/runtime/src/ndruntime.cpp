// numpower_tpu native runtime.
//
// Re-design of the reference's C runtime pieces:
//  - buffer registry / "GC engine" (/root/reference/src/buffer.c): growable
//    uuid -> slot table with allocation counters used for leak accounting
//    (buffer.c:15-18, add_to_buffer buffer.c:91-121, buffer_ndarray_free
//    buffer.c:61-75). Here the registry tracks *host-side wrapper objects*
//    and their byte footprints — device memory itself is owned by XLA; what
//    the framework owes the user is the same live-object / leak telemetry
//    the reference surfaces via NDARRAY_BUFFERLEAK / vmemcheck
//    (numpower.c:5268-5277, gpu_alloc.c:36-40).
//  - vmalloc/vfree alignment shims (/root/reference/src/gpu_alloc.c:11-33):
//    here a 4096-aligned host staging allocator for zero-copy H2D feeds.
//  - fast tensor IO: a writev-based .npy writer and an mmap reader that
//    replace NDArray_Save/Load's raw struct fwrite (ndarray.c:1356-1404).
//
// Built as a plain shared library; bound from Python via ctypes (no pybind11
// in this image).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

struct Registry {
  std::mutex mu;
  std::unordered_map<uint64_t, uint64_t> live;  // uuid -> nbytes
  std::atomic<uint64_t> next_uuid{1};
  std::atomic<uint64_t> total_registered{0};
  std::atomic<uint64_t> total_freed{0};
  std::atomic<uint64_t> live_bytes{0};
  std::atomic<uint64_t> peak_bytes{0};
};

Registry& reg() {
  static Registry* r = new Registry();
  return *r;
}

}  // namespace

extern "C" {

// --- buffer registry (buffer.c analogue) -----------------------------------

uint64_t nptpu_register(uint64_t nbytes) {
  Registry& r = reg();
  uint64_t id = r.next_uuid.fetch_add(1, std::memory_order_relaxed);
  {
    std::lock_guard<std::mutex> lock(r.mu);
    r.live.emplace(id, nbytes);
  }
  r.total_registered.fetch_add(1, std::memory_order_relaxed);
  uint64_t lb = r.live_bytes.fetch_add(nbytes, std::memory_order_relaxed) + nbytes;
  uint64_t peak = r.peak_bytes.load(std::memory_order_relaxed);
  while (lb > peak &&
         !r.peak_bytes.compare_exchange_weak(peak, lb, std::memory_order_relaxed)) {
  }
  return id;
}

int nptpu_unregister(uint64_t uuid, uint64_t nbytes) {
  Registry& r = reg();
  {
    std::lock_guard<std::mutex> lock(r.mu);
    auto it = r.live.find(uuid);
    if (it == r.live.end()) return -1;  // double free / unknown uuid
    r.live.erase(it);
  }
  r.total_freed.fetch_add(1, std::memory_order_relaxed);
  r.live_bytes.fetch_sub(nbytes, std::memory_order_relaxed);
  return 0;
}

// out[0]=total_registered out[1]=total_freed out[2]=live_count
// out[3]=live_bytes out[4]=peak_bytes  (buffer_dump analogue, buffer.c:15-33)
void nptpu_stats(uint64_t* out) {
  Registry& r = reg();
  out[0] = r.total_registered.load();
  out[1] = r.total_freed.load();
  {
    std::lock_guard<std::mutex> lock(r.mu);
    out[2] = static_cast<uint64_t>(r.live.size());
  }
  out[3] = r.live_bytes.load();
  out[4] = r.peak_bytes.load();
}

// vmemcheck analogue (gpu_alloc.c:36-40): returns live (leaked) count.
uint64_t nptpu_leak_check() {
  Registry& r = reg();
  std::lock_guard<std::mutex> lock(r.mu);
  return static_cast<uint64_t>(r.live.size());
}

void nptpu_reset_stats() {
  Registry& r = reg();
  std::lock_guard<std::mutex> lock(r.mu);
  r.live.clear();
  r.total_registered.store(0);
  r.total_freed.store(0);
  r.live_bytes.store(0);
  r.peak_bytes.store(0);
}

// --- aligned staging allocator (gpu_alloc.c vmalloc/vfree analogue) --------

void* nptpu_aligned_alloc(uint64_t nbytes, uint64_t alignment) {
  if (alignment == 0) alignment = 4096;
  void* p = nullptr;
  if (posix_memalign(&p, alignment, nbytes) != 0) return nullptr;
  return p;
}

void nptpu_aligned_free(void* p) { free(p); }

// --- fast .npy IO (NDArray_Save/Load replacement) --------------------------

// Single writev of header+payload; returns 0 on success.
int nptpu_npy_save(const char* path, const void* header, uint64_t header_len,
                   const void* data, uint64_t nbytes) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  struct iovec iov[2];
  iov[0].iov_base = const_cast<void*>(header);
  iov[0].iov_len = header_len;
  iov[1].iov_base = const_cast<void*>(data);
  iov[1].iov_len = nbytes;
  uint64_t total = header_len + nbytes;
  uint64_t written = 0;
  int iov_idx = 0;
  while (written < total) {
    ssize_t n = writev(fd, &iov[iov_idx], 2 - iov_idx);
    if (n < 0) {
      close(fd);
      return -2;
    }
    written += static_cast<uint64_t>(n);
    // Advance iovecs past what was written.
    uint64_t adv = static_cast<uint64_t>(n);
    while (iov_idx < 2 && adv >= iov[iov_idx].iov_len) {
      adv -= iov[iov_idx].iov_len;
      iov_idx++;
    }
    if (iov_idx < 2 && adv > 0) {
      iov[iov_idx].iov_base = static_cast<char*>(iov[iov_idx].iov_base) + adv;
      iov[iov_idx].iov_len -= adv;
    }
  }
  close(fd);
  return 0;
}

// mmap the file and copy payload into dst (dst sized nbytes). Offset is the
// npy data offset. Returns 0 on success.
int nptpu_npy_read(const char* path, uint64_t offset, void* dst, uint64_t nbytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < offset + nbytes) {
    close(fd);
    return -2;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    close(fd);
    return -3;
  }
  std::memcpy(dst, static_cast<char*>(m) + offset, nbytes);
  munmap(m, st.st_size);
  close(fd);
  return 0;
}

}  // extern "C"
