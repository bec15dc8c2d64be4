// Native streaming frame source: the read-side analog of the reference's
// kinect_frame_grabber (src/kinect_frame_grabber.cpp — C++ capture loop
// writing 640x480 float8 .bin clouds). Here: a background prefetch thread
// reads a directory's .bin cloud sequence into a fixed ring buffer so the
// Python side pops frames without ever blocking on disk I/O — the
// host-runtime piece of the odometry pipeline that stays native.
//
// C ABI (ctypes; see icp_tpu/sensors/stream.py):
//   fs_open(dir, n_points, ring)  -> handle (0 on failure)
//   fs_count(handle)              -> total frames discovered
//   fs_next(handle, out)          -> frame index >= 0, -1 at end of stream
//   fs_close(handle)
//
// Frames are 8 floats per point, little-endian, n_points per file
// (truncated/zero-padded to exactly n_points like icp_read_cloud).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  long index;
  std::vector<float> data;
};

struct Source {
  std::vector<std::string> files;
  long n_points = 0;
  size_t ring = 4;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<Frame> queue;  // FIFO, bounded by ring
  std::atomic<bool> stop{false};
  bool done = false;

  void run() {
    for (size_t i = 0; i < files.size() && !stop.load(); ++i) {
      Frame f;
      f.index = static_cast<long>(i);
      f.data.assign(static_cast<size_t>(n_points) * 8, 0.0f);
      FILE* fp = std::fopen(files[i].c_str(), "rb");
      if (fp) {
        size_t got = std::fread(f.data.data(), sizeof(float),
                                f.data.size(), fp);
        (void)got;  // short files stay zero-padded
        std::fclose(fp);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < ring || stop.load(); });
      if (stop.load()) break;
      queue.push_back(std::move(f));
      cv_pop.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* fs_open(const char* dir, long n_points, long ring) {
  DIR* d = opendir(dir);
  if (!d) return nullptr;
  auto* src = new Source();
  src->n_points = n_points;
  src->ring = ring > 0 ? static_cast<size_t>(ring) : 4;
  while (dirent* e = readdir(d)) {
    std::string name(e->d_name);
    if (name.size() > 4 && name.compare(name.size() - 4, 4, ".bin") == 0) {
      src->files.push_back(std::string(dir) + "/" + name);
    }
  }
  closedir(d);
  std::sort(src->files.begin(), src->files.end());
  src->worker = std::thread([src] { src->run(); });
  return src;
}

long fs_count(void* handle) {
  return static_cast<long>(static_cast<Source*>(handle)->files.size());
}

long fs_next(void* handle, float* out) {
  auto* src = static_cast<Source*>(handle);
  std::unique_lock<std::mutex> lk(src->mu);
  src->cv_pop.wait(lk, [&] { return !src->queue.empty() || src->done; });
  if (src->queue.empty()) return -1;  // end of stream
  Frame f = std::move(src->queue.front());
  src->queue.erase(src->queue.begin());
  src->cv_push.notify_one();
  lk.unlock();
  std::memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  return f.index;
}

void fs_close(void* handle) {
  auto* src = static_cast<Source*>(handle);
  src->stop.store(true);
  src->cv_push.notify_all();
  src->cv_pop.notify_all();
  if (src->worker.joinable()) src->worker.join();
  delete src;
}

}  // extern "C"
