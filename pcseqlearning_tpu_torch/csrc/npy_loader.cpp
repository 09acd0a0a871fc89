// Native async .npy loader: a C++ thread pool that reads and decodes npy
// files off the Python thread, double-buffered per slot (the port's copy of
// the repository's csrc/npy_loader.cpp, whose code it keeps unchanged).
//
// Exposed to Python via ctypes (datasets/native_loader.py), with a plain C
// interface: create a pool, submit paths, wait for a ticket's array, read
// its error, release it.
//
// Supported payloads: C-contiguous little-endian arrays of f32/f64/i32/i64/u8
// with ndim <= 4 (covers every artifact the Waymo pipeline writes).
//
// Build: datasets/native_loader.py compiles it at first use with
// g++ -O3 -shared -fPIC -std=c++17 -pthread into pcseqlearning_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::vector<char> data;
  int64_t shape[4] = {0, 0, 0, 0};
  int32_t ndim = 0;
  int32_t dtype = -1;  // 0=f32 1=f64 2=i32 3=i64 4=u8
  int32_t status = 0;  // 0=pending 1=ready 2=error
  std::string error;
};

struct Job {
  std::string path;
  int64_t ticket;
};

class Pool {
 public:
  explicit Pool(int workers) : stop_(false) {
    for (int i = 0; i < workers; i++) {
      threads_.emplace_back([this] { this->Run(); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
    for (auto* a : results_) delete a;
  }

  int64_t Submit(const char* path) {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t ticket = next_ticket_++;
    results_.push_back(new Array());
    jobs_.push_back(Job{path, ticket});
    cv_.notify_one();
    return ticket;
  }

  Array* Wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return results_[ticket]->status != 0; });
    return results_[ticket];
  }

  void Release(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    delete results_[ticket];
    results_[ticket] = nullptr;
  }

 private:
  void Run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = jobs_.front();
        jobs_.pop_front();
      }
      Array* out;
      {
        std::unique_lock<std::mutex> lk(mu_);
        out = results_[job.ticket];
      }
      // decode outside the lock, but publish the status transition under
      // mu_ so Wait()'s predicate read is properly synchronized
      int32_t status = LoadNpy(job.path, out);
      {
        std::unique_lock<std::mutex> lk(mu_);
        out->status = status;
        done_cv_.notify_all();
      }
    }
  }

  static int32_t Fail(Array* out, const std::string& msg) {
    out->error = msg;
    return 2;
  }

  // returns the status code (1 ready / 2 error); the caller publishes it
  // into out->status under the pool mutex
  static int32_t LoadNpy(const std::string& path, Array* out) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return Fail(out, "open failed: " + path);
    char magic[8];
    if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
      fclose(f);
      return Fail(out, "bad magic: " + path);
    }
    int major = magic[6];
    uint32_t header_len = 0;
    if (major == 1) {
      uint16_t h16;
      if (fread(&h16, 2, 1, f) != 1) { fclose(f); return Fail(out, "short header"); }
      header_len = h16;
    } else {
      if (fread(&header_len, 4, 1, f) != 1) { fclose(f); return Fail(out, "short header"); }
    }
    std::string header(header_len, '\0');
    if (fread(&header[0], 1, header_len, f) != header_len) {
      fclose(f);
      return Fail(out, "short header body");
    }
    // dtype
    size_t dp = header.find("'descr'");
    if (dp == std::string::npos) { fclose(f); return Fail(out, "no descr"); }
    size_t q1 = header.find('\'', dp + 7);
    size_t q2 = header.find('\'', q1 + 1);
    std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
    size_t itemsize = 0;
    if (descr == "<f4") { out->dtype = 0; itemsize = 4; }
    else if (descr == "<f8") { out->dtype = 1; itemsize = 8; }
    else if (descr == "<i4") { out->dtype = 2; itemsize = 4; }
    else if (descr == "<i8") { out->dtype = 3; itemsize = 8; }
    else if (descr == "|u1") { out->dtype = 4; itemsize = 1; }
    else { fclose(f); return Fail(out, "unsupported dtype " + descr); }
    if (header.find("'fortran_order': True") != std::string::npos) {
      fclose(f);
      return Fail(out, "fortran order unsupported");
    }
    // shape
    size_t sp = header.find("'shape'");
    size_t p1 = header.find('(', sp);
    size_t p2 = header.find(')', p1);
    std::string shape_str = header.substr(p1 + 1, p2 - p1 - 1);
    out->ndim = 0;
    int64_t total = 1;
    const char* s = shape_str.c_str();
    while (*s) {
      while (*s == ' ' || *s == ',') s++;
      if (!*s) break;
      if (out->ndim >= 4) {  // >4-D arrays are unsupported, not truncated
        fclose(f);
        return Fail(out, "ndim > 4 unsupported: " + path);
      }
      char* end = nullptr;
      int64_t dim = strtoll(s, &end, 10);
      if (end == s) {  // non-numeric junk: stop rather than spin
        fclose(f);
        return Fail(out, "bad shape tuple: " + path);
      }
      s = end;
      out->shape[out->ndim++] = dim;
      total *= dim;
    }
    if (out->ndim == 0) {  // scalar
      out->ndim = 1;
      out->shape[0] = 1;
    }
    out->data.resize(total * itemsize);
    if (total > 0 && fread(out->data.data(), itemsize, total, f) != static_cast<size_t>(total)) {
      fclose(f);
      return Fail(out, "short payload: " + path);
    }
    fclose(f);
    return 1;
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<Job> jobs_;
  std::vector<Array*> results_;
  std::vector<std::thread> threads_;
  std::atomic<int64_t> next_ticket_{0};
  bool stop_;
};

}  // namespace

extern "C" {

void* npy_pool_create(int workers) { return new Pool(workers); }
void npy_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int64_t npy_submit(void* pool, const char* path) {
  return static_cast<Pool*>(pool)->Submit(path);
}

// returns status (1 ready / 2 error); fills shape/ndim/dtype and data ptr
int32_t npy_wait(void* pool, int64_t ticket, void** data, int64_t* shape,
                 int32_t* ndim, int32_t* dtype) {
  Array* a = static_cast<Pool*>(pool)->Wait(ticket);
  if (a->status == 1) {
    *data = a->data.data();
    memcpy(shape, a->shape, sizeof(a->shape));
    *ndim = a->ndim;
    *dtype = a->dtype;
  }
  return a->status;
}

const char* npy_error(void* pool, int64_t ticket) {
  Array* a = static_cast<Pool*>(pool)->Wait(ticket);
  return a->error.c_str();
}

void npy_release(void* pool, int64_t ticket) {
  static_cast<Pool*>(pool)->Release(ticket);
}

}  // extern "C"
