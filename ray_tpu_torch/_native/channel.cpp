// Native SPSC channel core: futex waits + GIL-free copies for the
// compiled-DAG shared-memory rings.
//
// Counterpart of the reference's C++ mutable-object channel runtime
// (reference: src/ray/core_worker/experimental_mutable_object_manager.h —
// the low-latency transport under compiled DAGs is native there too).  The
// pure-Python ring (ray_tpu_torch/experimental/channel.py) waits by spinning with
// sleep backoff: on a shared host that burns the core the actors need, and
// wakeups cost scheduler quanta.  Here both sides block on a SHARED futex
// word that producers/consumers bump on every publish, so a waiting peer
// wakes in microseconds and burns nothing.
//
// Layout (little-endian u64 unless noted), matching channel.py's header
// plus one native word:
//   [0]  head       (producer-owned)
//   [8]  tail       (consumer-owned)
//   [16] slot_size
//   [24] depth
//   [32] futex word (u32) — bumped by every publish, FUTEX_WAKE'd
//
// Functions return 0 on success, -1 on timeout.  ctypes releases the GIL
// around every call, so waits and memcpys never stall the Python loop.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <linux/futex.h>
#include <sched.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr size_t kHead = 0;
constexpr size_t kTail = 8;
constexpr size_t kFutex = 32;

inline std::atomic<uint64_t>* u64(void* base, size_t off) {
  return reinterpret_cast<std::atomic<uint64_t>*>(
      static_cast<char*>(base) + off);
}

inline std::atomic<uint32_t>* futex_word(void* base) {
  return reinterpret_cast<std::atomic<uint32_t>*>(
      static_cast<char*>(base) + kFutex);
}

int futex_wait(std::atomic<uint32_t>* addr, uint32_t expected,
               const timespec* ts) {
  return syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
                 expected, ts, nullptr, 0);
}

void futex_wake(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE, INT32_MAX,
          nullptr, nullptr, 0);
}

// Wait until pred() is true; returns 0, or -1 on timeout.  timeout_s < 0
// means wait forever.  Every futex sleep is capped at 50 ms: a pure-Python
// peer (native lib unavailable in that process) bumps the futex word but
// cannot FUTEX_WAKE, so a sleeping native waiter must re-poll on its own.
template <typename Pred>
int wait_until(void* base, double timeout_s, Pred pred) {
  // Spin only when another core could be publishing meanwhile: on a
  // single-core host a spinning waiter just burns the slice the peer needs
  // (measured: ~1.7 ms/roundtrip spinning vs ~60 us going straight to the
  // futex), so there we block immediately.
  static const long kCores = sysconf(_SC_NPROCESSORS_ONLN);
  const int spin = kCores > 1 ? 64 : 1;
  for (int i = 0; i < spin; i++) {
    if (pred()) return 0;
  }
  if (kCores > 1) {
    for (int i = 0; i < 64; i++) {
      sched_yield();
      if (pred()) return 0;
    }
  }
  timespec deadline{};
  if (timeout_s >= 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += static_cast<time_t>(timeout_s);
    deadline.tv_nsec +=
        static_cast<long>((timeout_s - static_cast<long>(timeout_s)) * 1e9);
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  auto* fw = futex_word(base);
  while (true) {
    uint32_t seen = fw->load(std::memory_order_acquire);
    if (pred()) return 0;
    double left = 0.050;
    if (timeout_s >= 0) {
      timespec now{};
      clock_gettime(CLOCK_MONOTONIC, &now);
      double remain = (deadline.tv_sec - now.tv_sec) +
                      (deadline.tv_nsec - now.tv_nsec) * 1e-9;
      if (remain <= 0) return -1;
      if (remain < left) left = remain;
    }
    timespec ts;
    ts.tv_sec = static_cast<time_t>(left);
    ts.tv_nsec = static_cast<long>((left - ts.tv_sec) * 1e9);
    // Re-check under the futex protocol: sleep only if nothing was
    // published since we sampled the word.
    futex_wait(fw, seen, &ts);
  }
}

void publish(void* base) {
  futex_word(base)->fetch_add(1, std::memory_order_release);
  futex_wake(futex_word(base));
}

}  // namespace

extern "C" {

// Producer: wait for ring room.
int ch_wait_writable(void* base, double timeout_s) {
  uint64_t depth = u64(base, 24)->load(std::memory_order_relaxed);
  return wait_until(base, timeout_s, [&] {
    uint64_t head = u64(base, kHead)->load(std::memory_order_acquire);
    uint64_t tail = u64(base, kTail)->load(std::memory_order_acquire);
    return head - tail < depth;
  });
}

// Producer: copy payload into the current slot and publish it.
// Returns -1 on timeout, -2 if the payload exceeds the slot size.
int ch_write(void* base, const char* payload, uint64_t n, double timeout_s) {
  uint64_t slot_size = u64(base, 16)->load(std::memory_order_relaxed);
  uint64_t depth = u64(base, 24)->load(std::memory_order_relaxed);
  if (n > slot_size) return -2;
  if (ch_wait_writable(base, timeout_s) != 0) return -1;
  uint64_t head = u64(base, kHead)->load(std::memory_order_relaxed);
  char* slot = static_cast<char*>(base) + 40 + (head % depth) * (8 + slot_size);
  std::memcpy(slot + 8, payload, n);
  std::memcpy(slot, &n, 8);
  u64(base, kHead)->store(head + 1, std::memory_order_release);
  publish(base);
  return 0;
}

// Consumer: wait for a message; on success writes its length to *len_out
// and returns 0 (the caller copies the payload out of the mapped slot).
int ch_wait_readable(void* base, double timeout_s, uint64_t* len_out) {
  int rc = wait_until(base, timeout_s, [&] {
    uint64_t head = u64(base, kHead)->load(std::memory_order_acquire);
    uint64_t tail = u64(base, kTail)->load(std::memory_order_acquire);
    return head > tail;
  });
  if (rc != 0) return rc;
  uint64_t slot_size = u64(base, 16)->load(std::memory_order_relaxed);
  uint64_t depth = u64(base, 24)->load(std::memory_order_relaxed);
  uint64_t tail = u64(base, kTail)->load(std::memory_order_relaxed);
  char* slot = static_cast<char*>(base) + 40 + (tail % depth) * (8 + slot_size);
  std::memcpy(len_out, slot, 8);
  return 0;
}

// Consumer: copy the current message out and advance the tail.
int ch_read(void* base, char* out, uint64_t cap, double timeout_s,
            uint64_t* len_out) {
  int rc = ch_wait_readable(base, timeout_s, len_out);
  if (rc != 0) return rc;
  uint64_t slot_size = u64(base, 16)->load(std::memory_order_relaxed);
  uint64_t depth = u64(base, 24)->load(std::memory_order_relaxed);
  uint64_t tail = u64(base, kTail)->load(std::memory_order_relaxed);
  char* slot = static_cast<char*>(base) + 40 + (tail % depth) * (8 + slot_size);
  uint64_t n = *len_out;
  if (n != UINT64_MAX && n > cap) return -3;
  if (n != UINT64_MAX) std::memcpy(out, slot + 8, n);
  u64(base, kTail)->store(tail + 1, std::memory_order_release);
  publish(base);
  return 0;
}

// Consumer half of the sentinel protocol: advance past a close frame.
void ch_advance_tail(void* base) {
  uint64_t tail = u64(base, kTail)->load(std::memory_order_relaxed);
  u64(base, kTail)->store(tail + 1, std::memory_order_release);
  publish(base);
}

void ch_wake(void* base) { publish(base); }

}  // extern "C"
