// executor.cpp — native real-time loop + telemetry ring buffer.
//
// The reference's runtime shell is rospy.Rate(10) + ROS pub/sub
// (`mavros_blaster_sim.py:35`, `getPose_scripts/`). This is the native
// equivalent for deployments without ROS: a monotonic fixed-rate ticker
// with deadline accounting (the reference prints wall time per tick and
// drops the data; we keep jitter/miss statistics), and a lock-free SPSC
// ring buffer for pose telemetry so the control thread never blocks on
// the transport thread (fixing the acknowledged lag race of
// `getPose_ext.py:27`).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct RateLoop {
  double period_s;
  Clock::time_point next;
  // stats
  uint64_t ticks = 0;
  uint64_t misses = 0;
  double worst_late_s = 0.0;
  double sum_late_s = 0.0;
};

struct PoseRing {
  // SPSC ring of fixed-size float64 records [stamp, px,py,pz, qw,qx,qy,qz]
  static constexpr int kRecord = 8;
  std::vector<double> data;
  uint64_t capacity;
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // advanced by consumer
};

}  // namespace

extern "C" {

// ---------- rate loop ----------

void* rt_rate_create(double hz) {
  auto* rl = new RateLoop();
  rl->period_s = 1.0 / hz;
  rl->next = Clock::now();
  return rl;
}

void rt_rate_destroy(void* h) { delete static_cast<RateLoop*>(h); }

// Sleep until the next tick boundary; returns lateness (s) of the wakeup
// relative to the deadline (0.0 when on time).
double rt_rate_sleep(void* h) {
  auto* rl = static_cast<RateLoop*>(h);
  rl->next += std::chrono::duration_cast<Clock::duration>(
      std::chrono::duration<double>(rl->period_s));
  auto now = Clock::now();
  double late = 0.0;
  if (now < rl->next) {
    std::this_thread::sleep_until(rl->next);
  } else {
    late = std::chrono::duration<double>(now - rl->next).count();
    rl->misses++;
    if (late > rl->worst_late_s) rl->worst_late_s = late;
    rl->sum_late_s += late;
    rl->next = now;  // re-anchor after a miss (no tick bursts)
  }
  rl->ticks++;
  return late;
}

void rt_rate_stats(void* h, uint64_t* ticks, uint64_t* misses,
                   double* worst_late_s, double* mean_late_s) {
  auto* rl = static_cast<RateLoop*>(h);
  *ticks = rl->ticks;
  *misses = rl->misses;
  *worst_late_s = rl->worst_late_s;
  *mean_late_s = rl->ticks ? rl->sum_late_s / rl->ticks : 0.0;
}

// ---------- pose ring buffer ----------

void* rt_ring_create(uint64_t capacity) {
  auto* r = new PoseRing();
  r->capacity = capacity;
  r->data.assign(capacity * PoseRing::kRecord, 0.0);
  return r;
}

void rt_ring_destroy(void* h) { delete static_cast<PoseRing*>(h); }

// Producer: push one record (overwrites oldest when full).
void rt_ring_push(void* h, const double* record) {
  auto* r = static_cast<PoseRing*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  std::memcpy(&r->data[(head % r->capacity) * PoseRing::kRecord], record,
              PoseRing::kRecord * sizeof(double));
  r->head.store(head + 1, std::memory_order_release);
}

// Consumer: copy the most recent record; returns 0 if empty, else the
// number of records ever written (monotone sequence number).
uint64_t rt_ring_latest(void* h, double* record) {
  auto* r = static_cast<PoseRing*>(h);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head == 0) return 0;
  // re-read until stable (producer may overwrite the slot mid-copy)
  for (;;) {
    uint64_t idx = (head - 1) % r->capacity;
    std::memcpy(record, &r->data[idx * PoseRing::kRecord],
                PoseRing::kRecord * sizeof(double));
    uint64_t head2 = r->head.load(std::memory_order_acquire);
    if (head2 == head || head2 - head < r->capacity) return head;
    head = head2;
  }
}

// Consumer: drain up to max_records into out (oldest first); returns count.
uint64_t rt_ring_drain(void* h, double* out, uint64_t max_records) {
  auto* r = static_cast<PoseRing*>(h);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  if (head - tail > r->capacity) tail = head - r->capacity;  // overwritten
  uint64_t n = head - tail;
  if (n > max_records) n = max_records;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t idx = (tail + i) % r->capacity;
    std::memcpy(out + i * PoseRing::kRecord,
                &r->data[idx * PoseRing::kRecord],
                PoseRing::kRecord * sizeof(double));
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
