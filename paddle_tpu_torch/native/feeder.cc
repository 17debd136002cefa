// The threaded multi-file record feeder (the port's own copy of the JAX
// package's paddle_tpu/native/feeder.cc, its ByteQueue and ptfeed_*).
//
// Reference: the AsyncExecutor's thread-per-file DataFeed loop
// (framework/data_feed.h:49, Init -> SetFileList -> Start -> Next) and the
// bounded queue of reader/blocking_queue.h. N threads take the files in
// turn, scan each one's records into one bounded queue, and the caller
// pops them; the last worker to finish closes the queue. As in the JAX
// package, a worker skips a file it cannot open and stops a file at its
// first corrupt chunk without a word (the scanner alone raises on those).
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* pttrio_scanner_open(const char* path);
long pttrio_scanner_next(void* handle, const char** out);
void pttrio_scanner_close(void* handle);
}

namespace {

class ByteQueue {
 public:
  explicit ByteQueue(size_t capacity) : cap_(capacity) {}

  // false once the queue is closed
  bool Push(std::string rec) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(rec));
    not_empty_.notify_one();
    return true;
  }

  // false once the queue is closed and drained
  bool Pop(std::string* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  size_t cap_;
  bool closed_ = false;
  std::deque<std::string> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

struct Feeder {
  ByteQueue queue;
  std::vector<std::string> files;
  std::atomic<size_t> next_file{0};
  std::atomic<int> live_workers{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;
  std::string current;  // the last popped record, handed to the caller

  explicit Feeder(size_t cap) : queue(cap) {}

  void Work() {
    while (!stop.load()) {
      size_t idx = next_file.fetch_add(1);
      if (idx >= files.size()) break;
      void* sc = pttrio_scanner_open(files[idx].c_str());
      if (!sc) continue;
      const char* data = nullptr;
      long len;
      while (!stop.load() && (len = pttrio_scanner_next(sc, &data)) >= 0) {
        if (!queue.Push(std::string(data, static_cast<size_t>(len)))) break;
      }
      pttrio_scanner_close(sc);
    }
    if (live_workers.fetch_sub(1) == 1) queue.Close();
  }
};

}  // namespace

extern "C" {

void* pttfeed_create(const char** files, int nfiles, int nthreads,
                     long queue_capacity) {
  Feeder* f = new Feeder(queue_capacity);
  for (int i = 0; i < nfiles; ++i) f->files.emplace_back(files[i]);
  if (nthreads < 1) nthreads = 1;
  f->live_workers = nthreads;
  for (int i = 0; i < nthreads; ++i) {
    f->threads.emplace_back([f] { f->Work(); });
  }
  return f;
}

// The next record's length (>= 0; *out valid until the next call), or -1
// once every file is drained. Blocks while the queue is empty.
long pttfeed_next(void* handle, const char** out) {
  Feeder* f = static_cast<Feeder*>(handle);
  if (!f->queue.Pop(&f->current)) return -1;
  *out = f->current.data();
  return static_cast<long>(f->current.size());
}

// Stops the workers (a half-read feeder too), joins them and frees it.
void pttfeed_destroy(void* handle) {
  Feeder* f = static_cast<Feeder*>(handle);
  f->stop.store(true);
  f->queue.Close();
  for (auto& t : f->threads) {
    if (t.joinable()) t.join();
  }
  delete f;
}

}  // extern "C"
