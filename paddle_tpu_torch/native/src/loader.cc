// Threaded prefetching record loader over recordio files — the native
// data-loader of the runtime (the reference's async DoubleBuffer
// DataProvider, reference: gserver/dataproviders/DataProvider.h:249,
// pulled OUT of the trainer process loop: N worker threads read+decode
// chunks while Python consumes decoded records from a bounded queue).
//
// C ABI:
//   ldr_open(paths, n_paths, n_threads, capacity)  -> handle
//   ldr_next(handle, &data) -> len | -1 end | -2 error  (data is a
//       malloc'd copy the caller releases with ldr_free)
//   ldr_free(data)
//   ldr_close(handle)
//
// Files are partitioned round-robin across threads; record order is
// deterministic (file order) with n_threads=1 and interleaved otherwise
// (the reference's multi-threaded providers make the same trade).

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// recordio.cc's C ABI (compiled into the same .so)
extern "C" {
void* rio_reader_open(const char* path, int64_t begin, int64_t end);
int64_t rio_next(void* h, const char** data);
void rio_reader_close(void* h);
}

namespace {

struct Loader {
  std::deque<std::string> queue;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  size_t capacity = 1024;
  int live_producers = 0;
  bool failed = false;
  bool closing = false;
  std::vector<std::thread> threads;

  void produce(const std::vector<std::string>& paths) {
    for (const auto& p : paths) {
      void* r = rio_reader_open(p.c_str(), 0, -1);
      if (!r) {
        std::lock_guard<std::mutex> g(mu);
        failed = true;
        not_empty.notify_all();
        break;
      }
      const char* data = nullptr;
      int64_t n;
      bool stop = false;
      while ((n = rio_next(r, &data)) >= 0) {
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [&] { return queue.size() < capacity || closing; });
        if (closing) { stop = true; break; }
        queue.emplace_back(data, static_cast<size_t>(n));
        not_empty.notify_one();
      }
      if (n == -2) {
        std::lock_guard<std::mutex> g(mu);
        failed = true;
        not_empty.notify_all();
        stop = true;
      }
      rio_reader_close(r);
      if (stop) break;
    }
    std::lock_guard<std::mutex> g(mu);
    if (--live_producers == 0) not_empty.notify_all();
  }
};

}  // namespace

extern "C" {

void* ldr_open(const char** paths, int n_paths, int n_threads,
               int capacity) {
  if (n_paths <= 0 || n_threads <= 0) return nullptr;
  auto* l = new Loader();
  if (capacity > 0) l->capacity = static_cast<size_t>(capacity);
  if (n_threads > n_paths) n_threads = n_paths;
  std::vector<std::vector<std::string>> parts(n_threads);
  for (int i = 0; i < n_paths; i++)
    parts[i % n_threads].emplace_back(paths[i]);
  l->live_producers = n_threads;
  for (int i = 0; i < n_threads; i++)
    l->threads.emplace_back([l, part = parts[i]] { l->produce(part); });
  return l;
}

int64_t ldr_next(void* h, char** out) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->not_empty.wait(lk, [&] {
    return !l->queue.empty() || l->live_producers == 0 || l->failed;
  });
  if (l->failed) return -2;
  if (l->queue.empty()) return -1;  // all producers done
  std::string rec = std::move(l->queue.front());
  l->queue.pop_front();
  l->not_full.notify_one();
  lk.unlock();
  char* buf = static_cast<char*>(malloc(rec.size() ? rec.size() : 1));
  memcpy(buf, rec.data(), rec.size());
  *out = buf;
  return static_cast<int64_t>(rec.size());
}

void ldr_free(char* data) { free(data); }

void ldr_close(void* h) {
  auto* l = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> g(l->mu);
    l->closing = true;
    l->not_full.notify_all();
  }
  for (auto& t : l->threads) t.join();
  delete l;
}

}  // extern "C"
