// spnc: native async netCDF-classic (CDF-2, 64-bit offset) writer.
//
// The port's own copy of the JAX package's csrc/spnc/spnc.cpp, built by
// sp_coupler_tpu_torch/io/spnc.py with g++ (host code, no CUDA). It stands
// in for the reference LES's own per-instance netCDF output path (DALES
// writes surf_xy / cross-section files per work dir, reference
// README.md:108-111): the coupled-step loop enqueues float buffers and
// returns immediately; a background worker thread serializes them to disk
// with pwrite at offsets computed from the classic netCDF layout, so IO
// never blocks device compute.
//
// Scope: float32 variables, one unlimited (record) dimension, per-variable
// "units" attributes — exactly what the cross-section/statistics files
// need. File format: CDF-2 as specified by the NetCDF classic format spec.
//
// C API (ctypes-friendly):
//   h  = spnc_create(path)
//   id = spnc_def_dim(h, name, len)        // len 0 => record dimension
//   vid= spnc_def_var(h, name, units, ndims, int32* dimids)
//   spnc_enddef(h)                          // writes header, starts worker
//   spnc_put(h, vid, rec, float* data, n)   // async; copies data
//   spnc_flush(h)                           // drain queue + update numrecs
//   spnc_close(h)
//   spnc_queue_depth(h)                     // observability
//
// Thread-safety: spnc_put may be called from any one producer thread;
// worker drains FIFO. spnc_flush/close join the queue.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Dim {
  std::string name;
  uint32_t len;  // 0 = record dim
};

struct Var {
  std::string name;
  std::string units;
  std::vector<int> dimids;
  bool is_record = false;
  uint64_t vsize = 0;   // bytes per record (or total if non-record), padded
  uint64_t begin = 0;   // file offset of first element
};

struct Job {
  int vid;
  uint64_t rec;
  std::vector<float> data;
};

// big-endian helpers (netCDF classic is big-endian)
inline void put_u32(std::string* b, uint32_t v) {
  char c[4] = {char(v >> 24), char(v >> 16), char(v >> 8), char(v)};
  b->append(c, 4);
}
inline void put_u64(std::string* b, uint64_t v) {
  put_u32(b, uint32_t(v >> 32));
  put_u32(b, uint32_t(v & 0xffffffffu));
}
inline void put_name(std::string* b, const std::string& s) {
  put_u32(b, uint32_t(s.size()));
  b->append(s);
  while (b->size() % 4) b->push_back('\0');
}

struct File {
  int fd = -1;
  std::vector<Dim> dims;
  std::vector<Var> vars;
  int rec_dimid = -1;
  uint64_t recsize = 0;     // bytes per record over all record vars
  uint64_t numrecs = 0;
  uint64_t data_start = 0;  // offset where non-record data begins
  uint64_t rec_start = 0;   // offset where record data begins
  bool defined = false;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Job> queue;
  bool stop = false;

  ~File() { close(); }

  uint64_t elems_per_record(const Var& v) const {
    uint64_t n = 1;
    for (int d : v.dimids)
      if (d != rec_dimid) n *= dims[d].len;
    return n;
  }

  void build_header(std::string* h) const {
    h->append("CDF\x02", 4);
    put_u32(h, uint32_t(numrecs));
    // dim list
    if (dims.empty()) { put_u32(h, 0); put_u32(h, 0); }
    else {
      put_u32(h, 0x0A);
      put_u32(h, uint32_t(dims.size()));
      for (const auto& d : dims) { put_name(h, d.name); put_u32(h, d.len); }
    }
    // global attributes: absent
    put_u32(h, 0); put_u32(h, 0);
    // var list
    if (vars.empty()) { put_u32(h, 0); put_u32(h, 0); }
    else {
      put_u32(h, 0x0B);
      put_u32(h, uint32_t(vars.size()));
      for (const auto& v : vars) {
        put_name(h, v.name);
        put_u32(h, uint32_t(v.dimids.size()));
        for (int d : v.dimids) put_u32(h, uint32_t(d));
        // variable attributes: units (NC_CHAR = 2)
        if (v.units.empty()) { put_u32(h, 0); put_u32(h, 0); }
        else {
          put_u32(h, 0x0C);
          put_u32(h, 1);
          put_name(h, "units");
          put_u32(h, 2);
          put_name(h, v.units);
        }
        put_u32(h, 5);                     // NC_FLOAT
        put_u32(h, uint32_t(v.vsize));     // vsize (spec: may overflow, ok)
        put_u64(h, v.begin);               // 64-bit offset (CDF-2)
      }
    }
  }

  void write_header() {
    std::string h;
    build_header(&h);
    ::pwrite(fd, h.data(), h.size(), 0);
  }

  void enddef() {
    // layout: header | non-record vars | records
    std::string h;
    build_header(&h);  // first pass to size the header (begins still 0)
    uint64_t off = (h.size() + 3) & ~uint64_t(3);
    for (auto& v : vars) {
      uint64_t n = elems_per_record(v) * 4;
      v.vsize = (n + 3) & ~uint64_t(3);
      if (!v.is_record) { v.begin = off; off += v.vsize; }
    }
    rec_start = off;
    uint64_t r = rec_start;
    recsize = 0;
    for (auto& v : vars)
      if (v.is_record) { v.begin = r; r += v.vsize; recsize += v.vsize; }
    write_header();
    defined = true;
    worker = std::thread([this] { run(); });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      const Var& v = vars[job.vid];
      uint64_t off = v.begin + (v.is_record ? job.rec * recsize : 0);
      // data stored big-endian
      std::vector<uint32_t> be(job.data.size());
      for (size_t i = 0; i < job.data.size(); ++i) {
        uint32_t u;
        memcpy(&u, &job.data[i], 4);
        be[i] = __builtin_bswap32(u);
      }
      ::pwrite(fd, be.data(), be.size() * 4, off);
      if (v.is_record && job.rec + 1 > numrecs) {
        numrecs = job.rec + 1;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (queue.empty()) cv.notify_all();
      }
    }
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return queue.empty(); });
    lk.unlock();
    // update numrecs in the header
    uint32_t nr = uint32_t(numrecs);
    char c[4] = {char(nr >> 24), char(nr >> 16), char(nr >> 8), char(nr)};
    ::pwrite(fd, c, 4, 4);
    ::fsync(fd);
  }

  void close() {
    if (fd < 0) return;
    if (worker.joinable()) {
      flush();
      {
        std::lock_guard<std::mutex> lk(mu);
        stop = true;
      }
      cv.notify_all();
      worker.join();
    }
    ::close(fd);
    fd = -1;
  }
};

}  // namespace

extern "C" {

void* spnc_create(const char* path) {
  int fd = ::open(path, O_CREAT | O_TRUNC | O_RDWR, 0644);
  if (fd < 0) return nullptr;
  File* f = new File();
  f->fd = fd;
  return f;
}

int32_t spnc_def_dim(void* h, const char* name, uint32_t len) {
  File* f = static_cast<File*>(h);
  if (f->defined) return -1;
  f->dims.push_back({name, len});
  if (len == 0) f->rec_dimid = int(f->dims.size()) - 1;
  return int32_t(f->dims.size()) - 1;
}

int32_t spnc_def_var(void* h, const char* name, const char* units,
                     int32_t ndims, const int32_t* dimids) {
  File* f = static_cast<File*>(h);
  if (f->defined) return -1;
  Var v;
  v.name = name;
  v.units = units ? units : "";
  for (int i = 0; i < ndims; ++i) {
    v.dimids.push_back(dimids[i]);
    if (dimids[i] == f->rec_dimid) v.is_record = true;
  }
  f->vars.push_back(std::move(v));
  return int32_t(f->vars.size()) - 1;
}

int32_t spnc_enddef(void* h) {
  static_cast<File*>(h)->enddef();
  return 0;
}

int32_t spnc_put(void* h, int32_t vid, uint64_t rec, const float* data,
                 uint64_t n) {
  File* f = static_cast<File*>(h);
  if (!f->defined || vid < 0 || size_t(vid) >= f->vars.size()) return -1;
  Job job;
  job.vid = vid;
  job.rec = rec;
  job.data.assign(data, data + n);
  {
    std::lock_guard<std::mutex> lk(f->mu);
    f->queue.push_back(std::move(job));
  }
  f->cv.notify_all();
  return 0;
}

int64_t spnc_queue_depth(void* h) {
  File* f = static_cast<File*>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  return int64_t(f->queue.size());
}

int32_t spnc_flush(void* h) {
  static_cast<File*>(h)->flush();
  return 0;
}

int32_t spnc_close(void* h) {
  File* f = static_cast<File*>(h);
  f->close();
  delete f;
  return 0;
}

}  // extern "C"
