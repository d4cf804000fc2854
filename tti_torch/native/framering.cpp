// framering.cpp — host-side frame ring buffer + batch assembler.
//
// The feed path: camera capture threads push frames into a ring; the
// device-feed thread snapshots the freshest frame of each ring into one
// contiguous, pinned batch buffer that is then copied to the card. At the
// target rate (hundreds of frames/s x ~6 MB per 1080p frame) the copies must
// not hold the Python GIL, so they live here. Copy of tti/native/framering.cpp.
//
// Concurrency model: single-producer-per-ring seqlock slots. A writer bumps
// the slot sequence to odd, memcpys, bumps to even. Readers retry on a torn
// read. Multiple independent rings cover multi-camera setups (one producer
// each); the batch assembler reads any set of rings.
//
// Build (done by tti_torch/native/__init__.py at first use, into build/):
//   g++ -O3 -std=c++17 -shared -fPIC framering.cpp -o libtti_framering_<hash>.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Slot {
  std::atomic<uint64_t> seq{0};  // even = stable, odd = being written
  uint64_t frame_id = 0;         // monotonically increasing per ring
  int64_t timestamp_ns = 0;
};

struct Ring {
  int64_t capacity = 0;
  int64_t frame_bytes = 0;
  std::atomic<uint64_t> head{0};  // number of frames ever pushed
  std::atomic<uint64_t> dropped{0};
  std::vector<Slot> slots;
  std::vector<uint8_t> data;

  uint8_t* frame_ptr(int64_t slot) { return data.data() + slot * frame_bytes; }
};

}  // namespace

extern "C" {

void* tti_ring_create(int64_t capacity, int64_t frame_bytes) {
  if (capacity <= 0 || frame_bytes <= 0) return nullptr;
  auto* ring = new (std::nothrow) Ring();
  if (!ring) return nullptr;
  ring->capacity = capacity;
  ring->frame_bytes = frame_bytes;
  ring->slots = std::vector<Slot>(capacity);
  try {
    ring->data.resize(static_cast<size_t>(capacity) * frame_bytes);
  } catch (...) {
    delete ring;
    return nullptr;
  }
  return ring;
}

void tti_ring_destroy(void* handle) { delete static_cast<Ring*>(handle); }

// Push one frame (single producer per ring). Overwrites the oldest slot when
// full. head is PUBLISHED only after the slot write completes, so a reader
// that observes head > id also observes slot id fully written (release/acquire
// pairing on head) — publishing first would let a reader accept an unwritten
// slot as a clean frame.
void tti_ring_push(void* handle, const uint8_t* frame, int64_t timestamp_ns) {
  auto* ring = static_cast<Ring*>(handle);
  const uint64_t id = ring->head.load(std::memory_order_relaxed);
  Slot& slot = ring->slots[id % ring->capacity];
  slot.seq.fetch_add(1, std::memory_order_acq_rel);  // -> odd: writing
  std::memcpy(ring->frame_ptr(id % ring->capacity), frame, ring->frame_bytes);
  slot.frame_id = id;
  slot.timestamp_ns = timestamp_ns;
  slot.seq.fetch_add(1, std::memory_order_release);  // -> even: stable
  if (id >= static_cast<uint64_t>(ring->capacity)) {
    ring->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  ring->head.store(id + 1, std::memory_order_release);
}

uint64_t tti_ring_dropped(void* handle) {
  return static_cast<Ring*>(handle)->dropped.load(std::memory_order_relaxed);
}

uint64_t tti_ring_head(void* handle) {
  return static_cast<Ring*>(handle)->head.load(std::memory_order_acquire);
}

// Copy the newest `count` frames (oldest-first) into `out` (count*frame_bytes,
// caller-owned, contiguous). Returns the number of frames actually copied
// (< count when the ring holds fewer). Torn slots are retried.
int64_t tti_ring_snapshot(void* handle, uint8_t* out, int64_t count,
                          uint64_t* frame_ids) {
  auto* ring = static_cast<Ring*>(handle);
  const uint64_t head = ring->head.load(std::memory_order_acquire);
  const uint64_t available =
      head < static_cast<uint64_t>(ring->capacity) ? head : ring->capacity;
  const int64_t n = count < static_cast<int64_t>(available)
                        ? count
                        : static_cast<int64_t>(available);
  for (int64_t i = 0; i < n; ++i) {
    // Oldest-first of the newest n: ids head-n .. head-1.
    const uint64_t id = head - n + i;
    Slot& slot = ring->slots[id % ring->capacity];
    for (int attempt = 0; attempt < 1024; ++attempt) {
      const uint64_t seq0 = slot.seq.load(std::memory_order_acquire);
      if (seq0 & 1) continue;  // mid-write
      std::memcpy(out + i * ring->frame_bytes, ring->frame_ptr(id % ring->capacity),
                  ring->frame_bytes);
      const uint64_t id_seen = slot.frame_id;
      // Fence: the memcpy's loads must complete before seq is revalidated —
      // an acquire LOAD alone only orders later operations, so on weakly
      // ordered CPUs (aarch64) a torn frame could pass seq0 == seq1 without it.
      std::atomic_thread_fence(std::memory_order_acquire);
      const uint64_t seq1 = slot.seq.load(std::memory_order_relaxed);
      if (seq0 == seq1) {
        if (frame_ids) frame_ids[i] = id_seen;
        break;  // clean read (possibly of a newer overwrite — still a frame)
      }
    }
  }
  return n;
}

// Gather one frame from each of `n_rings` rings into a contiguous batch
// (stream-major). Returns a bitmask of rings that had at least one frame.
uint64_t tti_ring_gather_batch(void** handles, int64_t n_rings, uint8_t* out) {
  uint64_t ok_mask = 0;
  for (int64_t r = 0; r < n_rings; ++r) {
    auto* ring = static_cast<Ring*>(handles[r]);
    const int64_t copied =
        tti_ring_snapshot(handles[r], out + r * ring->frame_bytes, 1, nullptr);
    if (copied == 1) ok_mask |= (1ULL << r);
  }
  return ok_mask;
}

}  // extern "C"
