// ccv_runtime — native host runtime for the MPPI framework.
//
// The reference's C++ exists to host the controllers inside ROS: a fixed-rate
// loop (ros::Rate at src/diff_drive_mppi.cpp:334), pub/sub topic plumbing,
// and side-car CSV recorders (src/record_state.py). This library provides the
// equivalents around the JAX compute path:
//
//   * RateExecutor  — absolute-deadline periodic scheduler (clock_nanosleep)
//                     with measured-dt and deadline-miss accounting; the
//                     reference measures dt by wall clock each cycle
//                     (src/diff_drive_mppi.cpp:346-348) and silently slips.
//   * SpscRing      — wait-free single-producer/single-consumer ring with
//                     overwrite-oldest semantics, the equivalent of the
//                     reference's queue_size=1 subscriptions (latest state
//                     wins); used to decouple sensor IO from the solver.
//   * CsvRecorder   — background-thread buffered CSV writer so logging never
//                     blocks a control cycle.
//   * Oracle        — double-precision C++ implementation of the exact
//                     MPPI pipeline semantics (sampling is injected noise),
//                     used for cross-language parity testing and for honest
//                     measured CPU baselines (BASELINE.md derives the
//                     reference throughput ceiling analytically; this
//                     measures it).
//
// Plain C ABI, loaded from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <time.h>

extern "C" {

// ---------------------------------------------------------------------------
// RateExecutor
// ---------------------------------------------------------------------------

struct RateExecutor {
  double period_s;
  struct timespec next;
  bool started = false;
  // stats
  uint64_t cycles = 0;
  uint64_t misses = 0;
  double last_wall = 0.0;
  double last_dt = 0.0;
  double dt_sum = 0.0;
  double max_abs_jitter = 0.0;
};

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

void* ccv_rate_new(double hz) {
  auto* r = new RateExecutor();
  r->period_s = 1.0 / hz;
  return r;
}

// Sleep until the next absolute deadline; returns the measured dt since the
// previous call (first call returns the nominal period). Deadlines that have
// already passed count as misses and the schedule is re-anchored, so one
// overrun does not cascade.
double ccv_rate_sleep(void* h) {
  auto* r = static_cast<RateExecutor*>(h);
  if (!r->started) {
    clock_gettime(CLOCK_MONOTONIC, &r->next);
    r->started = true;
    r->last_wall = now_s();
  }
  long nsec = r->next.tv_nsec + (long)(r->period_s * 1e9);
  r->next.tv_sec += nsec / 1000000000L;
  r->next.tv_nsec = nsec % 1000000000L;

  struct timespec now_ts;
  clock_gettime(CLOCK_MONOTONIC, &now_ts);
  double deadline = r->next.tv_sec + r->next.tv_nsec * 1e-9;
  double now = now_ts.tv_sec + now_ts.tv_nsec * 1e-9;
  if (now > deadline) {
    r->misses++;
    r->next = now_ts;  // re-anchor
  } else {
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &r->next, nullptr);
  }
  double wall = now_s();
  r->last_dt = wall - r->last_wall;
  r->last_wall = wall;
  r->cycles++;
  r->dt_sum += r->last_dt;
  double jitter = r->last_dt - r->period_s;
  if (std::fabs(jitter) > r->max_abs_jitter) r->max_abs_jitter = std::fabs(jitter);
  return r->last_dt;
}

// out[0]=cycles out[1]=misses out[2]=mean_dt out[3]=max_abs_jitter
void ccv_rate_stats(void* h, double* out) {
  auto* r = static_cast<RateExecutor*>(h);
  out[0] = (double)r->cycles;
  out[1] = (double)r->misses;
  out[2] = r->cycles ? r->dt_sum / r->cycles : 0.0;
  out[3] = r->max_abs_jitter;
}

void ccv_rate_free(void* h) { delete static_cast<RateExecutor*>(h); }

// ---------------------------------------------------------------------------
// SpscRing — wait-free ring of fixed-size records, overwrite-oldest.
// ---------------------------------------------------------------------------

struct SpscRing {
  size_t elem_size;
  size_t capacity;  // power of two
  std::vector<uint8_t> buf;
  std::atomic<uint64_t> head{0};  // next write slot
  std::atomic<uint64_t> tail{0};  // next read slot
};

void* ccv_ring_new(size_t capacity_pow2, size_t elem_size) {
  auto* q = new SpscRing();
  size_t cap = 1;
  while (cap < capacity_pow2) cap <<= 1;
  q->capacity = cap;
  q->elem_size = elem_size;
  q->buf.resize(cap * elem_size);
  return q;
}

// Producer: always succeeds; drops the oldest unread record when full
// (latest-wins, like the reference's queue_size=1 topic subscriptions).
void ccv_ring_push(void* h, const void* data) {
  auto* q = static_cast<SpscRing*>(h);
  uint64_t head = q->head.load(std::memory_order_relaxed);
  uint64_t tail = q->tail.load(std::memory_order_acquire);
  if (head - tail == q->capacity) {
    q->tail.store(tail + 1, std::memory_order_release);  // drop oldest
  }
  std::memcpy(&q->buf[(head & (q->capacity - 1)) * q->elem_size], data,
              q->elem_size);
  q->head.store(head + 1, std::memory_order_release);
}

// Consumer: pop the oldest record; returns 0 if empty.
int ccv_ring_pop(void* h, void* out) {
  auto* q = static_cast<SpscRing*>(h);
  uint64_t tail = q->tail.load(std::memory_order_relaxed);
  if (tail == q->head.load(std::memory_order_acquire)) return 0;
  std::memcpy(out, &q->buf[(tail & (q->capacity - 1)) * q->elem_size],
              q->elem_size);
  q->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

// Consumer: read the newest record without consuming; returns its sequence
// number, or -1 if the ring has never been written.
int64_t ccv_ring_latest(void* h, void* out) {
  auto* q = static_cast<SpscRing*>(h);
  uint64_t head = q->head.load(std::memory_order_acquire);
  if (head == 0) return -1;
  std::memcpy(out, &q->buf[((head - 1) & (q->capacity - 1)) * q->elem_size],
              q->elem_size);
  return (int64_t)(head - 1);
}

size_t ccv_ring_size(void* h) {
  auto* q = static_cast<SpscRing*>(h);
  return q->head.load(std::memory_order_acquire) -
         q->tail.load(std::memory_order_acquire);
}

void ccv_ring_free(void* h) { delete static_cast<SpscRing*>(h); }

// ---------------------------------------------------------------------------
// CsvRecorder — background writer thread, bounded queue.
// ---------------------------------------------------------------------------

struct CsvRecorder {
  FILE* f;
  int ncols;
  std::vector<std::vector<double>> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool closing = false;

  void run() {
    std::vector<std::vector<double>> local;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return closing || !queue.empty(); });
        local.swap(queue);
        if (local.empty() && closing) break;
      }
      for (auto& row : local) {
        for (int i = 0; i < (int)row.size(); i++) {
          if (i) fputc(',', f);
          if (std::isnan(row[i]))
            ;  // empty cell
          else
            fprintf(f, "%.17g", row[i]);
        }
        fputc('\n', f);
      }
      local.clear();
    }
  }
};

void* ccv_csv_open(const char* path, const char* header, int ncols) {
  auto* r = new CsvRecorder();
  r->f = fopen(path, "w");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  r->ncols = ncols;
  fprintf(r->f, "%s\n", header);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

void ccv_csv_row(void* h, const double* values, int n) {
  auto* r = static_cast<CsvRecorder*>(h);
  std::vector<double> row(values, values + n);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->queue.push_back(std::move(row));
  }
  r->cv.notify_one();
}

void ccv_csv_close(void* h) {
  auto* r = static_cast<CsvRecorder*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closing = true;
  }
  r->cv.notify_one();
  r->worker.join();
  fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// Oracle — C++ restatement of the MPPI pipeline semantics (injected noise).
// Matches oracle/numpy_oracle.py exactly; see that module's docstring for the
// two documented divergences from the literal reference C++ (OOB index fix,
// min-baseline softmax).
// ---------------------------------------------------------------------------

// RATE_LIMITED: steering angle is a STATE (state[3]) and u[2] is its
// slewed rate — the framework's rate-limited steering family
// (models/rate_limited_steering.py; BASELINE.json "rate-limited
// steering" config). No counterpart in the reference nodes.
enum Model { UNICYCLE = 0, STEERING = 1, FULL_BODY = 2, RATE_LIMITED = 3 };

struct OracleParams {
  double control_noise;
  double lambda;
  double v_ref;
  double resolution;
  double dt;
  double path_weight;
  double v_weight;
  double zmp_weight;
  double roll_v_weight;
  double back_weight;
  double yaw_weight;
  double mass;
  double base2com;
  double inertia[3];
  double gravity_z;
  int steer_off;
  // RATE_LIMITED limits (ignored by other models)
  double steer_max;
  double rate_max;
};

static const double kDistCap = 100.0;

static inline double clampd(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One full control update. noise: (T-1, K, U) standard normals, row-major.
// u_prev: (T-1, U). path: (N, 2). Outputs u_opt (T-1, U) and costs (K).
void ccv_oracle_step(int model, int horizon, int num_samples, int u_dim,
                     const double* state, const double* u_prev,
                     const double* path, int path_len, const double* noise,
                     const double* u_min, const double* u_max,
                     const OracleParams* p, double* u_opt, double* costs_out) {
  const int T = horizon, K = num_samples, U = u_dim;
  const int tm1 = T - 1;

  // reference window (calc_RefPath semantics)
  int cur = 0;
  double best = kDistCap;
  for (int i = 0; i < path_len; i++) {
    double dx = state[0] - path[2 * i], dy = state[1] - path[2 * i + 1];
    double d = std::sqrt(dx * dx + dy * dy);
    if (d < best) {
      best = d;
      cur = i;
    }
  }
  std::vector<double> rx(T), ry(T), ryaw(T);
  double step = p->v_ref * p->dt / p->resolution;
  for (int i = 0; i < T; i++) {
    int idx = cur + (int)std::floor(i * step);
    if (idx > path_len - 1) idx = path_len - 1;
    rx[i] = path[2 * idx];
    ry[i] = path[2 * idx + 1];
  }
  for (int i = 0; i < T - 1; i++) ryaw[i] = std::atan2(ry[i + 1] - ry[i], rx[i + 1] - rx[i]);
  ryaw[T - 1] = ryaw[T - 2];

  std::vector<double> u(tm1 * U);
  std::vector<double> xs(T), ys(T), yaws(T), rolls(T), pitches(T), steers(T);
  std::vector<double> zmp_y(T > 2 ? T - 2 : 0);
  double min_cost = 1e300;

  // Centered expanded-form distance constants, shared with all parity arms
  // (ops/mindist.py module docstring): c = ref[0], 2*(ref-c), |ref-c|^2.
  const double cx = rx[0], cy = ry[0];
  std::vector<double> rcx2(T), rcy2(T), rn(T);
  for (int i = 0; i < T; i++) {
    double dx = rx[i] - cx, dy = ry[i] - cy;
    rcx2[i] = 2.0 * dx;
    rcy2[i] = 2.0 * dy;
    rn[i] = dx * dx + dy * dy;
  }

  for (int k = 0; k < K; k++) {
    // sampling: mean u_prev, injected noise, box clamp
    for (int t = 0; t < tm1; t++)
      for (int j = 0; j < U; j++) {
        double v = u_prev[t * U + j] +
                   noise[(size_t)t * K * U + (size_t)k * U + j] * p->control_noise;
        v = clampd(v, u_min[j], u_max[j]);
        if (p->steer_off && j == 2) v = 0.0;
        u[t * U + j] = v;
      }
    // rollout
    xs[0] = state[0];
    ys[0] = state[1];
    yaws[0] = state[2];
    if (model == FULL_BODY) {
      rolls[0] = state[3];
      pitches[0] = state[4];
    }
    if (model == RATE_LIMITED) steers[0] = state[3];
    for (int t = 0; t < tm1; t++) {
      // RATE_LIMITED integrates position with the CURRENT steering angle,
      // then slews it by the clipped commanded rate.
      double heading =
          model == UNICYCLE
              ? yaws[t]
              : (model == RATE_LIMITED ? yaws[t] + steers[t]
                                       : yaws[t] + u[t * U + 2]);
      xs[t + 1] = xs[t] + u[t * U] * std::cos(heading) * p->dt;
      ys[t + 1] = ys[t] + u[t * U] * std::sin(heading) * p->dt;
      yaws[t + 1] = yaws[t] + u[t * U + 1] * p->dt;
      if (model == FULL_BODY) {
        rolls[t + 1] = rolls[t] + u[t * U + 3] * p->dt;
        pitches[t + 1] = pitches[t] + u[t * U + 4] * p->dt;
      }
      if (model == RATE_LIMITED) {
        double rate = clampd(u[t * U + 2], -p->rate_max, p->rate_max);
        steers[t + 1] =
            clampd(steers[t] + rate * p->dt, -p->steer_max, p->steer_max);
      }
    }
    // cost
    double cost = 0.0;
    auto mind2 = [&](double x, double y) {
      // clamp(|pc|^2 + min_i (|rc_i|^2 - 2 pc . rc_i)): two FMAs + one min
      // per reference point, identical to ops/mindist.py and the kernel.
      double xc = x - cx, yc = y - cy;
      double pn = xc * xc + yc * yc;
      double m = std::numeric_limits<double>::infinity();
      for (int i = 0; i < T; i++) {
        double t = rn[i] - xc * rcx2[i] - yc * rcy2[i];
        if (t < m) m = t;
      }
      double d2 = pn + m;
      if (d2 < 0.0) d2 = 0.0;
      if (d2 > kDistCap * kDistCap) d2 = kDistCap * kDistCap;
      return d2;
    };
    if (model == FULL_BODY) {
      double dyaw = yaws[0] - ryaw[0];
      cost += p->yaw_weight * dyaw * dyaw;
      for (int t = 0; t < T - 2; t++) {
        // ZMP (zmp_y only enters the cost)
        double da = (u[(t + 1) * U] - u[t * U]) / p->dt;
        double ac = u[t * U] * u[t * U + 1];
        double d = u[t * U + 2];
        double ay = da * std::sin(d) + ac * std::cos(d);
        double hgx = p->inertia[0] * (u[(t + 1) * U + 3] - u[t * U + 3]) / p->dt;
        double com_y = -p->base2com * std::sin(rolls[t]);
        double com_z = p->base2com * std::cos(pitches[t]) * std::cos(rolls[t]);
        double bz = p->mass * p->gravity_z;
        double by = -p->mass * ay;
        double mo_x = com_y * bz - com_z * by - hgx;
        double zy = mo_x / bz;
        double dv = u[t * U] - p->v_ref;
        double drv = u[(t + 1) * U + 3] - u[t * U + 3];
        cost += p->path_weight * mind2(xs[t], ys[t]);
        cost += p->v_weight * dv * dv;
        cost += p->zmp_weight * zy * zy;
        cost += p->roll_v_weight * drv * drv;
        if (u[t * U] < 0.0) cost += p->back_weight * u[t * U] * u[t * U];
      }
    } else {
      for (int t = 0; t < T; t++) {
        cost += p->path_weight * mind2(xs[t], ys[t]);
        if (t < tm1) {
          double dv = u[t * U] - p->v_ref;
          cost += p->v_weight * dv * dv;
        }
      }
    }
    costs_out[k] = cost;
    if (cost < min_cost) min_cost = cost;
  }

  // min-baseline softmax + weighted update
  double sum = 0.0;
  std::vector<double> w(K);
  for (int k = 0; k < K; k++) {
    w[k] = std::exp(-(costs_out[k] - min_cost) / p->lambda);
    sum += w[k];
  }
  for (int t = 0; t < tm1; t++)
    for (int j = 0; j < U; j++) u_opt[t * U + j] = 0.0;
  for (int k = 0; k < K; k++) {
    double wk = w[k] / sum;
    for (int t = 0; t < tm1; t++)
      for (int j = 0; j < U; j++) {
        double v = u_prev[t * U + j] +
                   noise[(size_t)t * K * U + (size_t)k * U + j] * p->control_noise;
        v = clampd(v, u_min[j], u_max[j]);
        if (p->steer_off && j == 2) v = 0.0;
        u_opt[t * U + j] += wk * v;
      }
  }
}

// Measured CPU baseline: ns per full control update (serial, like the
// reference's loops), amortized over iters.
double ccv_oracle_bench_ns(int model, int horizon, int num_samples, int u_dim,
                           const double* state, const double* u_prev,
                           const double* path, int path_len,
                           const double* noise, const double* u_min,
                           const double* u_max, const OracleParams* p,
                           int iters) {
  std::vector<double> u_opt((horizon - 1) * u_dim);
  std::vector<double> costs(num_samples);
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; i++) {
    ccv_oracle_step(model, horizon, num_samples, u_dim, state, u_prev, path,
                    path_len, noise, u_min, u_max, p, u_opt.data(),
                    costs.data());
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

}  // extern "C"
