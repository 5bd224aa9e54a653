// Host-side trajectory store and CartPole pool of the port's host-stepped RL
// path (gcm_tpu_torch/data/host_buffer.py, gcm_tpu_torch/rl/native_env.py).
//
// The port's own copy of the JAX package's native/host_buffer.cpp, the same
// code, so that a sample is bitwise the JAX package's for the same episodes
// and seed: a lock-guarded episode ring buffer with a zero-padding batch
// sampler, bound to Python via ctypes. The sampler emits exactly the
// fixed-shape [B, T_max, F] + taus[B] layout SparseGCM consumes (zero-padded
// ragged windows), so device code never sees ragged data.
//
// Built at first use by gcm_tpu_torch/ops/_build.py::load_host
// (g++ -O3 -std=c++17 -fPIC -shared) into gcm_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <vector>

namespace {

struct Episode {
  std::vector<float> obs;      // T * obs_dim
  std::vector<int32_t> acts;   // T
  std::vector<float> rews;     // T
  int32_t T = 0;
};

struct ReplayBuffer {
  std::mutex mu;
  size_t capacity_steps;
  int obs_dim;
  size_t total_steps = 0;
  uint64_t appended_episodes = 0;
  std::deque<Episode> episodes;
};

}  // namespace

extern "C" {

void* rb_create(size_t capacity_steps, int obs_dim) {
  auto* rb = new ReplayBuffer();
  rb->capacity_steps = capacity_steps;
  rb->obs_dim = obs_dim;
  return rb;
}

void rb_destroy(void* h) { delete static_cast<ReplayBuffer*>(h); }

// Append one episode; evicts oldest episodes when over capacity.
// Returns the running episode counter.
int64_t rb_append_episode(void* h, const float* obs, const int32_t* acts,
                          const float* rews, int32_t T) {
  auto* rb = static_cast<ReplayBuffer*>(h);
  std::lock_guard<std::mutex> lock(rb->mu);
  Episode ep;
  ep.T = T;
  ep.obs.assign(obs, obs + static_cast<size_t>(T) * rb->obs_dim);
  ep.acts.assign(acts, acts + T);
  ep.rews.assign(rews, rews + T);
  rb->total_steps += T;
  rb->episodes.push_back(std::move(ep));
  while (rb->total_steps > rb->capacity_steps && rb->episodes.size() > 1) {
    rb->total_steps -= rb->episodes.front().T;
    rb->episodes.pop_front();
  }
  return static_cast<int64_t>(++rb->appended_episodes);
}

int32_t rb_num_episodes(void* h) {
  auto* rb = static_cast<ReplayBuffer*>(h);
  std::lock_guard<std::mutex> lock(rb->mu);
  return static_cast<int32_t>(rb->episodes.size());
}

int64_t rb_total_steps(void* h) {
  auto* rb = static_cast<ReplayBuffer*>(h);
  std::lock_guard<std::mutex> lock(rb->mu);
  return static_cast<int64_t>(rb->total_steps);
}

// Sample B episodes uniformly (with replacement) and write zero-padded
// fixed-shape batches: obs_out [B, T_max, F], act_out [B, T_max],
// rew_out [B, T_max], taus_out [B] = min(episode length, T_max).
// Episodes longer than T_max contribute their first T_max steps.
void rb_sample_batch(void* h, int32_t B, int32_t T_max, uint64_t seed,
                     float* obs_out, int32_t* act_out, float* rew_out,
                     int32_t* taus_out) {
  auto* rb = static_cast<ReplayBuffer*>(h);
  std::lock_guard<std::mutex> lock(rb->mu);
  const int F = rb->obs_dim;
  std::memset(obs_out, 0, sizeof(float) * B * T_max * F);
  std::memset(act_out, 0, sizeof(int32_t) * B * T_max);
  std::memset(rew_out, 0, sizeof(float) * B * T_max);
  std::memset(taus_out, 0, sizeof(int32_t) * B);
  if (rb->episodes.empty()) return;
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<size_t> pick(0, rb->episodes.size() - 1);
  for (int b = 0; b < B; ++b) {
    const Episode& ep = rb->episodes[pick(rng)];
    const int32_t tau = std::min(ep.T, T_max);
    taus_out[b] = tau;
    std::memcpy(obs_out + static_cast<size_t>(b) * T_max * F, ep.obs.data(),
                sizeof(float) * tau * F);
    std::memcpy(act_out + static_cast<size_t>(b) * T_max, ep.acts.data(),
                sizeof(int32_t) * tau);
    std::memcpy(rew_out + static_cast<size_t>(b) * T_max, ep.rews.data(),
                sizeof(float) * tau);
  }
}

// Pack a ragged edge list (lengths[i] edges each, concatenated sink/source
// rows) into the fixed [B, 2, max_edges] sentinel layout — the native
// counterpart of util.pack_hidden's per-batch loop (util.py:343-351).
// Returns the number of batches that overflowed (their tails truncated).
int32_t pack_edges(const int64_t* sinks, const int64_t* sources,
                   const int64_t* lengths, int32_t B, int32_t max_edges,
                   int32_t edge_fill, int64_t* out /* B*2*max_edges */) {
  int32_t overflowed = 0;
  size_t off = 0;
  for (int b = 0; b < B; ++b) {
    int64_t len = lengths[b];
    if (len > max_edges) {
      ++overflowed;
      len = max_edges;
    }
    int64_t* row_sink = out + static_cast<size_t>(b) * 2 * max_edges;
    int64_t* row_src = row_sink + max_edges;
    for (int64_t e = 0; e < max_edges; ++e) {
      row_sink[e] = e < len ? sinks[off + e] : edge_fill;
      row_src[e] = e < len ? sources[off + e] : edge_fill;
    }
    off += static_cast<size_t>(lengths[b]);
  }
  return overflowed;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native vectorized CartPole pool: the host side of the external-env
// training path (gcm_tpu_torch/rl/external.py), one C call a batch tick.
// Dynamics replicate gcm_tpu_torch/rl/env.py::CartPoleEnv (classic Gym
// Euler integration, auto-reset with uniform(-0.05, 0.05) init) in float32;
// tests/test_torch_port_host.py holds it to that env and to the JAX
// package's pool.

namespace {

struct EnvPool {
  int32_t n;
  int32_t horizon;
  bool masked_velocity;
  float reward_scale;
  std::mt19937_64 rng;
  // state-of-arrays, float32 to match the JAX env's dtype
  std::vector<float> x, x_dot, theta, theta_dot;
  std::vector<int32_t> t;

  static constexpr float kGravity = 9.8f;
  static constexpr float kMassCart = 1.0f;
  static constexpr float kMassPole = 0.1f;
  static constexpr float kLength = 0.5f;
  static constexpr float kForceMag = 10.0f;
  static constexpr float kTau = 0.02f;
  static constexpr float kXLimit = 2.4f;

  float theta_limit() const {
    return 12.0f * 2.0f * 3.14159265358979323846f / 360.0f;
  }

  void reset_one(int32_t i) {
    std::uniform_real_distribution<float> u(-0.05f, 0.05f);
    x[i] = u(rng);
    x_dot[i] = u(rng);
    theta[i] = u(rng);
    theta_dot[i] = u(rng);
    t[i] = 0;
  }

  void write_obs(float* obs_out) const {
    if (masked_velocity) {
      for (int32_t i = 0; i < n; ++i) {
        obs_out[i * 2 + 0] = x[i];
        obs_out[i * 2 + 1] = theta[i];
      }
    } else {
      for (int32_t i = 0; i < n; ++i) {
        obs_out[i * 4 + 0] = x[i];
        obs_out[i * 4 + 1] = x_dot[i];
        obs_out[i * 4 + 2] = theta[i];
        obs_out[i * 4 + 3] = theta_dot[i];
      }
    }
  }
};

}  // namespace

extern "C" {

void* ep_create(int32_t n, int32_t horizon, int32_t masked_velocity,
                float reward_scale, uint64_t seed) {
  auto* ep = new EnvPool();
  ep->n = n;
  ep->horizon = horizon;
  ep->masked_velocity = masked_velocity != 0;
  ep->reward_scale = reward_scale;
  ep->rng.seed(seed);
  ep->x.resize(n);
  ep->x_dot.resize(n);
  ep->theta.resize(n);
  ep->theta_dot.resize(n);
  ep->t.resize(n);
  return ep;
}

void ep_destroy(void* h) { delete static_cast<EnvPool*>(h); }

int32_t ep_obs_dim(void* h) {
  return static_cast<EnvPool*>(h)->masked_velocity ? 2 : 4;
}

void ep_reset(void* h, float* obs_out) {
  auto* ep = static_cast<EnvPool*>(h);
  for (int32_t i = 0; i < ep->n; ++i) ep->reset_one(i);
  ep->write_obs(obs_out);
}

// Test hook: overwrite the pool's physical state (t reset to 0).
void ep_set_state(void* h, const float* xs, const float* x_dots,
                  const float* thetas, const float* theta_dots) {
  auto* ep = static_cast<EnvPool*>(h);
  for (int32_t i = 0; i < ep->n; ++i) {
    ep->x[i] = xs[i];
    ep->x_dot[i] = x_dots[i];
    ep->theta[i] = thetas[i];
    ep->theta_dot[i] = theta_dots[i];
    ep->t[i] = 0;
  }
}

// One synchronous batch tick with auto-reset (HostEnvPool semantics: the
// returned obs of a finished env is the NEXT episode's first observation).
void ep_step(void* h, const int32_t* actions, float* obs_out,
             float* rew_out, uint8_t* done_out) {
  auto* ep = static_cast<EnvPool*>(h);
  const float total_mass = EnvPool::kMassCart + EnvPool::kMassPole;
  const float pml = EnvPool::kMassPole * EnvPool::kLength;
  const float th_lim = ep->theta_limit();
  for (int32_t i = 0; i < ep->n; ++i) {
    const float force =
        actions[i] == 1 ? EnvPool::kForceMag : -EnvPool::kForceMag;
    const float costh = std::cos(ep->theta[i]);
    const float sinth = std::sin(ep->theta[i]);
    const float temp =
        (force + pml * ep->theta_dot[i] * ep->theta_dot[i] * sinth) /
        total_mass;
    const float theta_acc =
        (EnvPool::kGravity * sinth - costh * temp) /
        (EnvPool::kLength *
         (4.0f / 3.0f - EnvPool::kMassPole * costh * costh / total_mass));
    const float x_acc = temp - pml * theta_acc * costh / total_mass;
    const float x = ep->x[i] + EnvPool::kTau * ep->x_dot[i];
    const float x_dot = ep->x_dot[i] + EnvPool::kTau * x_acc;
    const float theta = ep->theta[i] + EnvPool::kTau * ep->theta_dot[i];
    const float theta_dot = ep->theta_dot[i] + EnvPool::kTau * theta_acc;
    const int32_t t = ep->t[i] + 1;

    const bool fell = std::fabs(x) > EnvPool::kXLimit ||
                      std::fabs(theta) > th_lim;
    const bool done = fell || t >= ep->horizon;
    rew_out[i] = ep->reward_scale;
    done_out[i] = done ? 1 : 0;
    if (done) {
      ep->reset_one(i);
    } else {
      ep->x[i] = x;
      ep->x_dot[i] = x_dot;
      ep->theta[i] = theta;
      ep->theta_dot[i] = theta_dot;
      ep->t[i] = t;
    }
  }
  ep->write_obs(obs_out);
}

}  // extern "C"
