// Threaded batch loader: the port's native host-side data pipeline.
//
// A copy of the JAX package's facenet_tpu/native/loader.cc with this
// header changed and nothing else. Python owns the *policy* (epoch order,
// shuffling, P×K sampling); this owns the *mechanism* (parallel decode
// into batch buffers that ctypes hands to numpy without a copy, and from
// there to torch).
//
// Concurrency model: one loader = one thread pool + a bounded queue of
// batch requests. submit() enqueues an index list; workers decode images
// of in-flight batches in parallel (work stealing at image granularity);
// wait() blocks until the oldest submitted batch is fully decoded and
// returns its buffer. With depth >= 2 the host decodes batch N+1 while
// the device runs step N.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int fn_decode_image(const char* path, int height, int width,
                               int mode, uint8_t* out);

namespace facenet_native {

struct Batch {
  std::vector<int> indices;        // dataset indices to decode
  std::vector<uint8_t> buffer;     // [n, h, w, 3]
  std::vector<int32_t> ok;         // per-image decode status
  std::atomic<int> next_image{0};  // work-stealing cursor
  std::atomic<int> done_images{0};
  int n = 0;
  bool complete = false;
};

class Loader {
 public:
  Loader(std::vector<std::string> paths, int height, int width, int mode,
         int num_threads, int queue_depth)
      : paths_(std::move(paths)),
        height_(height),
        width_(width),
        mode_(mode),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth) {
    if (num_threads < 1) num_threads = 1;
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Loader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    cv_space_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Enqueue a batch of dataset indices. Blocks if queue_depth batches are
  // already in flight (backpressure keeps memory bounded). Returns 1 on
  // success, 0 if the loader is stopping (so the caller's in-flight
  // accounting stays correct). An empty batch (n == 0) is born complete —
  // no worker ever touches it, so Wait() must not depend on one.
  int Submit(const int* indices, int n) {
    auto batch = std::make_shared<Batch>();
    batch->indices.assign(indices, indices + n);
    batch->n = n;
    batch->buffer.resize(static_cast<size_t>(n) * height_ * width_ * 3);
    batch->ok.assign(n, 0);
    batch->complete = (n == 0);
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [this] {
        return stop_ || static_cast<int>(queue_.size()) < queue_depth_;
      });
      if (stop_) return 0;
      queue_.push_back(std::move(batch));
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    return 1;
  }

  // Block until the oldest batch is complete; copy it out. Returns the
  // number of images, or -1 if nothing was in flight.
  int Wait(uint8_t* out_buffer, int32_t* out_ok) {
    std::shared_ptr<Batch> batch;
    {
      std::unique_lock<std::mutex> lk(mu_);
      if (queue_.empty()) return -1;
      cv_done_.wait(lk, [this] { return stop_ || queue_.front()->complete; });
      if (stop_ && !queue_.front()->complete) return -1;
      batch = std::move(queue_.front());
      queue_.pop_front();
    }
    cv_space_.notify_all();
    std::memcpy(out_buffer, batch->buffer.data(), batch->buffer.size());
    std::memcpy(out_ok, batch->ok.data(), batch->ok.size() * sizeof(int32_t));
    return batch->n;
  }

  int height() const { return height_; }
  int width() const { return width_; }

 private:
  void WorkerLoop() {
    for (;;) {
      // Workers hold a shared_ptr so a batch popped by Wait() while a
      // worker is between images cannot be freed under it.
      std::shared_ptr<Batch> batch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this, &batch] {
          if (stop_) return true;
          for (auto& b : queue_) {
            if (b->next_image.load(std::memory_order_relaxed) < b->n) {
              batch = b;
              return true;
            }
          }
          return false;
        });
        if (stop_) return;
      }
      if (!batch) continue;

      // Decode images of this batch until its cursor runs out. The decode
      // itself runs outside the lock — this is where the time goes.
      for (;;) {
        const int i = batch->next_image.fetch_add(1);
        if (i >= batch->n) break;
        const int idx = batch->indices[i];
        uint8_t* dst = batch->buffer.data() +
                       static_cast<size_t>(i) * height_ * width_ * 3;
        int ok = 0;
        if (idx >= 0 && idx < static_cast<int>(paths_.size()))
          ok = fn_decode_image(paths_[idx].c_str(), height_, width_, mode_,
                               dst);
        if (!ok)
          std::memset(dst, 0, static_cast<size_t>(height_) * width_ * 3);
        batch->ok[i] = ok;

        if (batch->done_images.fetch_add(1) + 1 == batch->n) {
          {
            std::unique_lock<std::mutex> lk(mu_);
            batch->complete = true;
          }
          cv_done_.notify_all();
        }
      }
    }
  }

  std::vector<std::string> paths_;
  const int height_, width_, mode_, queue_depth_;

  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_, cv_space_;
  std::deque<std::shared_ptr<Batch>> queue_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace facenet_native

extern "C" {

void* fn_loader_create(const char** paths, int n_paths, int height, int width,
                       int mode, int num_threads, int queue_depth) {
  std::vector<std::string> p;
  p.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) p.emplace_back(paths[i]);
  return new facenet_native::Loader(std::move(p), height, width, mode,
                                    num_threads, queue_depth);
}

void fn_loader_destroy(void* loader) {
  delete static_cast<facenet_native::Loader*>(loader);
}

int fn_loader_submit(void* loader, const int* indices, int n) {
  return static_cast<facenet_native::Loader*>(loader)->Submit(indices, n);
}

int fn_loader_wait(void* loader, uint8_t* out_buffer, int32_t* out_ok) {
  return static_cast<facenet_native::Loader*>(loader)->Wait(out_buffer,
                                                            out_ok);
}

}  // extern "C"
