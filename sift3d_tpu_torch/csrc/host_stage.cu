// Host-to-device copy of a contiguous block of pageable host memory
// through pinned staging buffers, the whole loop in native code: the copy
// behind ops/upload.py's uploads of volume stacks that need no change of
// type.
//
// sift3d_stage_copy(src, dst, nbytes, chunk, threads, device, stream)
// copies nbytes from src (host) to dst (device memory of `device`),
// queuing each device copy on `stream`. `threads` host threads, the
// caller's among them, take the chunk-byte pieces of the block from a
// shared counter. Each owns two pinned buffers of `chunk` bytes: for a
// piece it waits for the last device copy out of its next buffer (an
// event), copies the piece in with memcpy, and queues the buffer's copy
// to the device on `stream` and the buffer's event after it. The call
// returns once every copy is queued, not done: the caller orders later
// work after an event it records on `stream`.
//
// The pinned buffers and their events are made on first use and kept
// for later calls; they are made again when chunk, threads or device
// change, after every copy out of the old ones is done. Calls run one at
// a time (a mutex). Nothing here touches a Python object, so under
// ctypes the call runs without the interpreter's lock, and another
// Python thread that launches work meanwhile does not slow the copy.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kBuffersPerThread = 2;

struct Staging {
  int device = -1;
  size_t chunk = 0;
  int threads = 0;
  char* pinned = nullptr;            // threads * kBuffersPerThread buffers
  std::vector<cudaEvent_t> events;   // the last device copy out of each
};

std::mutex g_mutex;
Staging g_staging;

cudaError_t release(Staging& s) {
  cudaError_t err = cudaSuccess;
  for (cudaEvent_t e : s.events) {
    cudaError_t e1 = cudaEventSynchronize(e);
    cudaError_t e2 = cudaEventDestroy(e);
    if (err == cudaSuccess) err = e1 != cudaSuccess ? e1 : e2;
  }
  s.events.clear();
  if (s.pinned != nullptr) {
    cudaError_t e = cudaFreeHost(s.pinned);
    if (err == cudaSuccess) err = e;
    s.pinned = nullptr;
  }
  s.device = -1;
  return err;
}

// Buffers and events for (device, chunk, threads), made again where the
// kept ones were made for others. The caller's current device is
// `device` on return.
cudaError_t prepare(Staging& s, int device, size_t chunk, int threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (s.device == device && s.chunk == chunk && s.threads == threads) {
    return cudaSuccess;
  }
  err = release(s);
  if (err != cudaSuccess) return err;
  const int nbufs = threads * kBuffersPerThread;
  err = cudaHostAlloc(reinterpret_cast<void**>(&s.pinned),
                      static_cast<size_t>(nbufs) * chunk,
                      cudaHostAllocPortable);
  if (err != cudaSuccess) {
    s.pinned = nullptr;
    return err;
  }
  s.events.reserve(nbufs);
  for (int i = 0; i < nbufs; ++i) {
    cudaEvent_t e;
    err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (err != cudaSuccess) {
      release(s);
      return err;
    }
    s.events.push_back(e);
  }
  s.device = device;
  s.chunk = chunk;
  s.threads = threads;
  return cudaSuccess;
}

}  // namespace

extern "C" int sift3d_stage_copy(const void* src, void* dst, size_t nbytes,
                                 size_t chunk, int threads, int device,
                                 void* stream) {
  if (nbytes == 0) return 0;
  if (chunk == 0 || threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> lock(g_mutex);
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Staging& s = g_staging;
  err = prepare(s, device, chunk, threads);
  if (err != cudaSuccess) return static_cast<int>(err);

  const char* from = static_cast<const char*>(src);
  char* to = static_cast<char*>(dst);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t pieces = (nbytes + chunk - 1) / chunk;
  std::atomic<size_t> next{0};
  std::atomic<int> failed{0};

  auto work = [&](int t) {
    cudaError_t e = cudaSetDevice(device);
    for (int use = 0; e == cudaSuccess && failed.load() == 0; ++use) {
      const size_t k = next.fetch_add(1);
      if (k >= pieces) break;
      const int j = t * kBuffersPerThread + use % kBuffersPerThread;
      char* buf = s.pinned + static_cast<size_t>(j) * chunk;
      const size_t off = k * chunk;
      const size_t n = std::min(chunk, nbytes - off);
      e = cudaEventSynchronize(s.events[j]);
      if (e != cudaSuccess) break;
      std::memcpy(buf, from + off, n);
      e = cudaMemcpyAsync(to + off, buf, n, cudaMemcpyHostToDevice, st);
      if (e == cudaSuccess) e = cudaEventRecord(s.events[j], st);
    }
    if (e != cudaSuccess) {
      int expected = 0;
      failed.compare_exchange_strong(expected, static_cast<int>(e));
    }
  };

  const int helpers = static_cast<int>(
      std::min<size_t>(static_cast<size_t>(threads), pieces)) - 1;
  std::vector<std::thread> pool;
  pool.reserve(helpers);
  for (int t = 1; t <= helpers; ++t) pool.emplace_back(work, t);
  work(0);
  for (std::thread& th : pool) th.join();
  cudaSetDevice(caller_device);
  return failed.load();
}
