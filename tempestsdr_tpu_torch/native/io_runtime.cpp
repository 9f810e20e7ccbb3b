// Native IO runtime: file pump thread + bounded byte ring buffer.
//
// Counterpart of the reference's native data path: the plugin
// reader thread (TSDRPlugin_RawFile.c:219-271, real-time tick-tock throttle
// :214-217,265-269) and the mutex/condvar circular buffer backpressure
// (TempestSDR/src/circbuff.c — bounded ring, overflow => drop, blocking
// consumer with timed waits).  Feeding happens off the Python GIL so disk IO
// overlaps device compute; the consumer (Python/ctypes) pulls fixed-size
// blocks and ships them straight to the device in the file's raw dtype.
//
// Overflow semantics mirror cb_add returning CB_FULL (circbuff.c:95-134):
// the incoming chunk is dropped whole and counted, so the consumer can apply
// the whole-frame drop compensation exactly like a hardware source reporting
// samples_dropped.
//
// Build: g++ -O2 -shared -fPIC -pthread io_runtime.cpp -o libtsdr_io.so

#include <atomic>
#include <chrono>
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

struct Ring {
  std::vector<uint8_t> buf;
  size_t head = 0;  // next write
  size_t tail = 0;  // next read
  size_t size = 0;  // bytes stored
  uint64_t written = 0;     // total bytes ever pushed successfully
  uint64_t read_total = 0;  // total bytes ever popped
  // Drop events positioned in the stream: a chunk dropped at write time sits
  // AFTER everything still buffered, so its count must not be released to
  // the consumer until the consumer has read all bytes that preceded it
  // (matches the UHD convention of reporting samples_dropped with the
  // delivery that follows the gap, TSDRPlugin_UHD.cpp:264-294).
  std::deque<std::pair<uint64_t, uint64_t>> drops;  // (stream pos, bytes)
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_data;
  std::condition_variable cv_space;

  explicit Ring(size_t cap) : buf(cap) {}

  size_t cap() const { return buf.size(); }

  // Producer: append n bytes. blocking=true waits for space (file replay —
  // backpressure is free); blocking=false drops the whole chunk and counts
  // it (CB_FULL semantics for live sources).
  bool push(const uint8_t* src, size_t n, bool blocking) {
    std::unique_lock<std::mutex> lk(mu);
    if (blocking) {
      while (n > cap() - size && !closed)
        cv_space.wait_for(lk, std::chrono::milliseconds(30));
      if (closed) return false;
    }
    if (n > cap() - size) {
      // coalesce consecutive drops at the same stream position (a stalled
      // consumer otherwise grows the deque unboundedly, one entry per
      // rejected chunk for hours)
      if (!drops.empty() && drops.back().first == written)
        drops.back().second += n;
      else
        drops.emplace_back(written, n);
      return false;
    }
    size_t first = std::min(n, cap() - head);
    std::memcpy(buf.data() + head, src, first);
    if (n > first) std::memcpy(buf.data(), src + first, n - first);
    head = (head + n) % cap();
    size += n;
    written += n;
    lk.unlock();
    cv_data.notify_one();
    return true;
  }

  // Consumer: read exactly n bytes (blocking with 30 ms timed waits like
  // threading.c:139) unless closed early; returns bytes read.
  size_t pop(uint8_t* dst, size_t n, bool blocking) {
    std::unique_lock<std::mutex> lk(mu);
    if (blocking) {
      while (size < n && !closed)
        cv_data.wait_for(lk, std::chrono::milliseconds(30));
    }
    size_t take = std::min(n, size);
    if (blocking && size >= n) take = n;
    size_t first = std::min(take, cap() - tail);
    std::memcpy(dst, buf.data() + tail, first);
    if (take > first) std::memcpy(dst + first, buf.data(), take - first);
    tail = (tail + take) % cap();
    size -= take;
    read_total += take;
    lk.unlock();
    cv_space.notify_one();
    return take;
  }

  // Record an EXTERNALLY-reported gap (e.g. a hardware source's
  // samples_dropped accompanying a plugin push, TSDRPlugin.h:49) at the
  // current write position: the gap precedes the data the producer is about
  // to push, so it matures exactly like a ring-overflow drop.
  void note_dropped(uint64_t n) {
    std::lock_guard<std::mutex> lk(mu);
    if (!drops.empty() && drops.back().first == written)
      drops.back().second += n;
    else
      drops.emplace_back(written, n);
  }

  // Release only MATURED drop counts: gaps the consumer has read PAST
  // (drop pos < read_total — at least one post-gap byte consumed).  The
  // strict inequality lets a consumer that calls take_dropped() right
  // after each block read attribute every gap to the first block that
  // contains post-gap data, the "delivery that follows the gap"
  // (TSDRPlugin_UHD.cpp:264-294): a gap exactly at a block boundary is
  // NOT released after the pre-gap block (pos == read_total), only after
  // the first block beyond it.
  uint64_t take_dropped() {
    std::lock_guard<std::mutex> lk(mu);
    uint64_t d = 0;
    while (!drops.empty() && drops.front().first < read_total) {
      d += drops.front().second;
      drops.pop_front();
    }
    return d;
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv_data.notify_all();
    cv_space.notify_all();
  }
};

struct FilePump {
  Ring* ring;
  std::string path;
  size_t chunk;
  bool loop;
  double bytes_per_sec;  // 0 = unthrottled (PERFORMANCE_BENCHMARK mode)
  long start_offset = 0;  // e.g. skip a WAV header
  std::atomic<bool> running{true};
  std::thread th;

  void run() {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      ring->close();
      return;
    }
    if (start_offset) std::fseek(f, start_offset, SEEK_SET);
    std::vector<uint8_t> tmp(chunk);
    auto deadline = std::chrono::steady_clock::now();
    while (running.load(std::memory_order_relaxed)) {
      size_t got = std::fread(tmp.data(), 1, chunk, f);
      if (got < chunk) {
        if (!loop) {
          if (got) ring->push(tmp.data(), got, true);
          break;
        }
        std::fseek(f, start_offset, SEEK_SET);
        size_t more = std::fread(tmp.data() + got, 1, chunk - got, f);
        got += more;
        if (got < chunk) break;  // file smaller than a chunk
      }
      if (bytes_per_sec > 0) {
        deadline += std::chrono::nanoseconds(
            (int64_t)(1e9 * (double)chunk / bytes_per_sec));
        std::this_thread::sleep_until(deadline);
      }
      ring->push(tmp.data(), got, true);
    }
    std::fclose(f);
    ring->close();
  }
};

}  // namespace

extern "C" {

void* tsdr_ring_create(size_t capacity_bytes) { return new Ring(capacity_bytes); }

void tsdr_ring_destroy(void* r) { delete static_cast<Ring*>(r); }

size_t tsdr_ring_read(void* r, uint8_t* dst, size_t n, int blocking) {
  return static_cast<Ring*>(r)->pop(dst, n, blocking != 0);
}

int tsdr_ring_write(void* r, const uint8_t* src, size_t n) {
  return static_cast<Ring*>(r)->push(src, n, false) ? 0 : 1;
}

// Blocking-capable write: blocking=1 waits for space (backpressure into the
// producer — drop-free replay through a paced plugin), blocking=0 is
// tsdr_ring_write (CB_FULL drop semantics).
int tsdr_ring_write2(void* r, const uint8_t* src, size_t n, int blocking) {
  return static_cast<Ring*>(r)->push(src, n, blocking != 0) ? 0 : 1;
}

void tsdr_ring_note_dropped(void* r, uint64_t bytes) {
  static_cast<Ring*>(r)->note_dropped(bytes);
}

uint64_t tsdr_ring_take_dropped(void* r) {
  return static_cast<Ring*>(r)->take_dropped();
}

void tsdr_ring_close(void* r) { static_cast<Ring*>(r)->close(); }

void* tsdr_filepump_start(const char* path, size_t chunk_bytes, int loop,
                          double bytes_per_sec, void* ring, long start_offset) {
  auto* p = new FilePump{static_cast<Ring*>(ring), path, chunk_bytes,
                         loop != 0, bytes_per_sec, start_offset};
  p->th = std::thread([p] { p->run(); });
  return p;
}

void tsdr_filepump_stop(void* pump) {
  auto* p = static_cast<FilePump*>(pump);
  p->running.store(false);
  p->ring->close();
  if (p->th.joinable()) p->th.join();
  delete p;
}

}  // extern "C"
