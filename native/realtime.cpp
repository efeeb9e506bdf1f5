// Real-time host runtime: rate-scheduled control loops, a seqlock state
// exchange, and a UDP robot transport.
//
// Replacement for the reference's process runtime — three
// free-running threads over a racy shared struct plus raw UDP to the robot
// (reference: src/legged_ctrl/src/main.cpp:110-256,
// src/legged_ctrl/src/interfaces/HardwareInterface.cpp:7, :86-120).
// Differences by design:
//   * the shared state is exchanged through a seqlock (writers never block,
//     readers retry on torn reads) instead of unsynchronized fields — the
//     reference's "need to be aware of deadlock" comment class of bugs
//     (LeggedState.h:223-224) cannot occur;
//   * loops use absolute-deadline clock_nanosleep pacing (no drift) and
//     record jitter/overrun statistics;
//   * the compute engine (the JAX controller) talks to this runtime through
//     the seqlock mailbox asynchronously — the realtime side always has a
//     valid latest command to hold (PD hold semantics, like the reference's
//     Gazebo PD-at-send, GazeboInterface.cpp:99-118).
//
// Exposed as a C API for ctypes; no ROS, no external deps.

#include <arpa/inet.h>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <pthread.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr int kNumJoints = 12;
constexpr int kNumLegs = 4;

#pragma pack(push, 1)
// Wire format of the robot link (Unitree-low-level shaped; the reference
// uses unitree_legged_sdk's LowCmd/LowState over UDP,
// HardwareInterface.cpp:86-120, :137-160).
struct LowCmdPacket {
  uint32_t magic;          // 0x4C43304D "LC0M"
  uint32_t seq;
  float q[kNumJoints];
  float dq[kNumJoints];
  float kp[kNumJoints];
  float kd[kNumJoints];
  float tau[kNumJoints];
  uint32_t crc;
};

struct LowStatePacket {
  uint32_t magic;          // 0x4C53304D "LS0M"
  uint32_t seq;
  float quat[4];           // w x y z
  float gyro[3];
  float acc[3];
  float q[kNumJoints];
  float dq[kNumJoints];
  float tau_est[kNumJoints];
  float foot_force[kNumLegs];
  uint32_t crc;
};
#pragma pack(pop)

uint32_t crc32_simple(const uint8_t *data, size_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) {
    crc ^= data[i];
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ (0xEDB88320u & (~(crc & 1u) + 1u));
  }
  return ~crc;
}

// Seqlock-protected snapshot of a POD payload.
template <typename T>
class Seqlock {
 public:
  void write(const T &v) {
    uint32_t s = seq_.load(std::memory_order_relaxed);
    seq_.store(s + 1, std::memory_order_release);   // odd: write in progress
    std::atomic_thread_fence(std::memory_order_release);
    value_ = v;
    std::atomic_thread_fence(std::memory_order_release);
    seq_.store(s + 2, std::memory_order_release);
  }
  // Returns the sequence number of the snapshot (0 = never written).
  uint32_t read(T *out) const {
    while (true) {
      uint32_t s0 = seq_.load(std::memory_order_acquire);
      if (s0 & 1u) continue;
      std::atomic_thread_fence(std::memory_order_acquire);
      T v = value_;
      std::atomic_thread_fence(std::memory_order_acquire);
      uint32_t s1 = seq_.load(std::memory_order_acquire);
      if (s0 == s1) {
        *out = v;
        return s0;
      }
    }
  }

 private:
  std::atomic<uint32_t> seq_{0};
  T value_{};
};

struct CmdSnapshot {
  float q[kNumJoints], dq[kNumJoints], kp[kNumJoints], kd[kNumJoints],
      tau[kNumJoints];
};

struct StateSnapshot {
  float quat[4], gyro[3], acc[3];
  float q[kNumJoints], dq[kNumJoints], tau_est[kNumJoints];
  float foot_force[kNumLegs];
  uint64_t t_ns;
};

struct LoopStats {
  uint64_t iterations;
  uint64_t overruns;
  double max_jitter_us;
  double mean_jitter_us;
  uint64_t rx_packets;
  uint64_t tx_packets;
  uint64_t rx_crc_errors;
};

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

struct Runtime {
  Seqlock<CmdSnapshot> cmd;
  Seqlock<StateSnapshot> state;
  std::atomic<bool> running{false};
  pthread_t thread{};
  int sock = -1;
  sockaddr_in peer{};
  bool has_peer = false;
  uint64_t period_ns = 1250000;   // 800 Hz, reference LOW_LEVEL period
  LoopStats stats{};
  uint32_t tx_seq = 0;
};

void *loop_main(void *arg) {
  Runtime *rt = static_cast<Runtime *>(arg);
  uint64_t next = now_ns() + rt->period_ns;
  double jitter_sum = 0.0;

  while (rt->running.load(std::memory_order_acquire)) {
    // --- receive all pending robot state packets ---
    LowStatePacket pkt;
    while (true) {
      sockaddr_in from{};
      socklen_t fl = sizeof(from);
      ssize_t r = recvfrom(rt->sock, &pkt, sizeof(pkt), MSG_DONTWAIT,
                           (sockaddr *)&from, &fl);
      if (r != (ssize_t)sizeof(pkt)) break;
      if (pkt.magic != 0x4C53304Du) continue;
      uint32_t crc = pkt.crc;
      pkt.crc = 0;
      if (crc32_simple((const uint8_t *)&pkt, sizeof(pkt)) != crc) {
        rt->stats.rx_crc_errors++;
        continue;
      }
      StateSnapshot s;
      std::memcpy(s.quat, pkt.quat, sizeof(s.quat));
      std::memcpy(s.gyro, pkt.gyro, sizeof(s.gyro));
      std::memcpy(s.acc, pkt.acc, sizeof(s.acc));
      std::memcpy(s.q, pkt.q, sizeof(s.q));
      std::memcpy(s.dq, pkt.dq, sizeof(s.dq));
      std::memcpy(s.tau_est, pkt.tau_est, sizeof(s.tau_est));
      std::memcpy(s.foot_force, pkt.foot_force, sizeof(s.foot_force));
      s.t_ns = now_ns();
      rt->state.write(s);
      rt->stats.rx_packets++;
      if (!rt->has_peer) {
        rt->peer = from;
        rt->has_peer = true;
      }
    }

    // --- send the latest command ---
    if (rt->has_peer) {
      CmdSnapshot c;
      if (rt->cmd.read(&c) > 0) {
        LowCmdPacket out{};
        out.magic = 0x4C43304Du;
        out.seq = ++rt->tx_seq;
        std::memcpy(out.q, c.q, sizeof(out.q));
        std::memcpy(out.dq, c.dq, sizeof(out.dq));
        std::memcpy(out.kp, c.kp, sizeof(out.kp));
        std::memcpy(out.kd, c.kd, sizeof(out.kd));
        std::memcpy(out.tau, c.tau, sizeof(out.tau));
        out.crc = 0;
        out.crc = crc32_simple((const uint8_t *)&out, sizeof(out));
        sendto(rt->sock, &out, sizeof(out), 0, (sockaddr *)&rt->peer,
               sizeof(rt->peer));
        rt->stats.tx_packets++;
      }
    }

    // --- absolute-deadline pacing ---
    timespec ts;
    ts.tv_sec = next / 1000000000ull;
    ts.tv_nsec = next % 1000000000ull;
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr);
    uint64_t woke = now_ns();
    double jitter = (double)((int64_t)(woke - next)) / 1e3;   // us late
    if (jitter > rt->stats.max_jitter_us) rt->stats.max_jitter_us = jitter;
    if (jitter > (double)rt->period_ns / 1e3) rt->stats.overruns++;
    jitter_sum += jitter > 0 ? jitter : 0;
    rt->stats.iterations++;
    rt->stats.mean_jitter_us = jitter_sum / (double)rt->stats.iterations;
    next += rt->period_ns;
    if (woke > next + 100 * rt->period_ns)   // fell far behind: resync
      next = woke + rt->period_ns;
  }
  return nullptr;
}

}  // namespace

extern "C" {

void *rt_create(const char *bind_ip, int bind_port, uint64_t period_ns) {
  Runtime *rt = new Runtime();
  rt->period_ns = period_ns;
  rt->sock = socket(AF_INET, SOCK_DGRAM, 0);
  if (rt->sock < 0) {
    delete rt;
    return nullptr;
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)bind_port);
  addr.sin_addr.s_addr = bind_ip ? inet_addr(bind_ip) : INADDR_ANY;
  if (bind(rt->sock, (sockaddr *)&addr, sizeof(addr)) != 0) {
    close(rt->sock);
    delete rt;
    return nullptr;
  }
  return rt;
}

void rt_set_peer(void *h, const char *ip, int port) {
  Runtime *rt = static_cast<Runtime *>(h);
  rt->peer = {};
  rt->peer.sin_family = AF_INET;
  rt->peer.sin_port = htons((uint16_t)port);
  rt->peer.sin_addr.s_addr = inet_addr(ip);
  rt->has_peer = true;
}

int rt_start(void *h) {
  Runtime *rt = static_cast<Runtime *>(h);
  bool expected = false;
  if (!rt->running.compare_exchange_strong(expected, true)) return 1;
  return pthread_create(&rt->thread, nullptr, loop_main, rt);
}

void rt_stop(void *h) {
  Runtime *rt = static_cast<Runtime *>(h);
  if (rt->running.exchange(false)) pthread_join(rt->thread, nullptr);
}

void rt_destroy(void *h) {
  Runtime *rt = static_cast<Runtime *>(h);
  rt_stop(h);
  if (rt->sock >= 0) close(rt->sock);
  delete rt;
}

void rt_push_cmd(void *h, const float *q, const float *dq, const float *kp,
                 const float *kd, const float *tau) {
  Runtime *rt = static_cast<Runtime *>(h);
  CmdSnapshot c;
  std::memcpy(c.q, q, sizeof(c.q));
  std::memcpy(c.dq, dq, sizeof(c.dq));
  std::memcpy(c.kp, kp, sizeof(c.kp));
  std::memcpy(c.kd, kd, sizeof(c.kd));
  std::memcpy(c.tau, tau, sizeof(c.tau));
  rt->cmd.write(c);
}

// Returns the state snapshot sequence number (0 if none yet).
uint32_t rt_get_state(void *h, float *quat, float *gyro, float *acc,
                      float *q, float *dq, float *tau_est,
                      float *foot_force) {
  Runtime *rt = static_cast<Runtime *>(h);
  StateSnapshot s;
  uint32_t seq = rt->state.read(&s);
  if (seq == 0) return 0;
  std::memcpy(quat, s.quat, sizeof(s.quat));
  std::memcpy(gyro, s.gyro, sizeof(s.gyro));
  std::memcpy(acc, s.acc, sizeof(s.acc));
  std::memcpy(q, s.q, sizeof(s.q));
  std::memcpy(dq, s.dq, sizeof(s.dq));
  std::memcpy(tau_est, s.tau_est, sizeof(s.tau_est));
  std::memcpy(foot_force, s.foot_force, sizeof(s.foot_force));
  return seq;
}

void rt_get_stats(void *h, uint64_t *iterations, uint64_t *overruns,
                  double *max_jitter_us, double *mean_jitter_us,
                  uint64_t *rx, uint64_t *tx, uint64_t *crc_errors) {
  Runtime *rt = static_cast<Runtime *>(h);
  *iterations = rt->stats.iterations;
  *overruns = rt->stats.overruns;
  *max_jitter_us = rt->stats.max_jitter_us;
  *mean_jitter_us = rt->stats.mean_jitter_us;
  *rx = rt->stats.rx_packets;
  *tx = rt->stats.tx_packets;
  *crc_errors = rt->stats.rx_crc_errors;
}

// --- packet codec helpers (for simulators / tests speaking the protocol) --
int rt_encode_state(const float *quat, const float *gyro, const float *acc,
                    const float *q, const float *dq, const float *tau_est,
                    const float *foot_force, uint32_t seq, uint8_t *out,
                    int out_cap) {
  if (out_cap < (int)sizeof(LowStatePacket)) return -1;
  LowStatePacket p{};
  p.magic = 0x4C53304Du;
  p.seq = seq;
  std::memcpy(p.quat, quat, sizeof(p.quat));
  std::memcpy(p.gyro, gyro, sizeof(p.gyro));
  std::memcpy(p.acc, acc, sizeof(p.acc));
  std::memcpy(p.q, q, sizeof(p.q));
  std::memcpy(p.dq, dq, sizeof(p.dq));
  std::memcpy(p.tau_est, tau_est, sizeof(p.tau_est));
  std::memcpy(p.foot_force, foot_force, sizeof(p.foot_force));
  p.crc = 0;
  p.crc = crc32_simple((const uint8_t *)&p, sizeof(p));
  std::memcpy(out, &p, sizeof(p));
  return (int)sizeof(p);
}

int rt_decode_cmd(const uint8_t *buf, int len, float *q, float *dq,
                  float *kp, float *kd, float *tau, uint32_t *seq) {
  if (len != (int)sizeof(LowCmdPacket)) return -1;
  LowCmdPacket p;
  std::memcpy(&p, buf, sizeof(p));
  if (p.magic != 0x4C43304Du) return -2;
  uint32_t crc = p.crc;
  p.crc = 0;
  if (crc32_simple((const uint8_t *)&p, sizeof(p)) != crc) return -3;
  std::memcpy(q, p.q, sizeof(p.q));
  std::memcpy(dq, p.dq, sizeof(p.dq));
  std::memcpy(kp, p.kp, sizeof(p.kp));
  std::memcpy(kd, p.kd, sizeof(p.kd));
  std::memcpy(tau, p.tau, sizeof(p.tau));
  *seq = p.seq;
  return 0;
}

}  // extern "C"
