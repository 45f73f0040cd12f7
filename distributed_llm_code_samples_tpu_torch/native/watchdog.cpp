// Native watchdog — training-loop hang detection.
//
// The port's copy of the JAX package's native/watchdog.cpp, the same C ABI.
// The reference has no failure detection at all: no try/except around
// workers, no timeout on join (train_ffns.py:190-191, SURVEY.md section 5).
// This component supplies the missing piece for the runtime: a monitor
// thread armed with a deadline that the training loop must "kick" every
// step. If the deadline lapses (a wedged collective, a hung device, a
// deadlocked host thread), the watchdog latches `expired` — the Python
// supervisor (runtime/failure.py) polls it and triggers checkpoint-based
// recovery. Latching (rather than aborting the process) keeps policy in
// Python; the native layer only does the timing, immune to a GIL held by
// the hung code.
//
// Implementation note: raw pthreads + CLOCK_MONOTONIC rather than
// std::thread / std::condition_variable — this library is dlopen'd into
// processes that also load torch's wheels (which bundle their own C++
// runtime), and the pthread surface lives in libc with a stable ABI, so
// there is no C++-runtime coupling to worry about.
//
// C ABI only; bound via ctypes (runtime/native.py).

#include <pthread.h>
#include <time.h>

#include <cstdint>

namespace {

int64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

struct Watchdog {
  int64_t timeout_ms = 0;
  int64_t deadline_ms = 0;
  int expired = 0;  // guarded by mu; latched until the next kick
  int stop = 0;
  pthread_mutex_t mu;
  pthread_cond_t cv;  // initialized with a CLOCK_MONOTONIC condattr
  pthread_t th;
};

void* monitor(void* arg) {
  auto* W = static_cast<Watchdog*>(arg);
  pthread_mutex_lock(&W->mu);
  while (!W->stop) {
    if (now_ms() >= W->deadline_ms) {
      W->expired = 1;
      pthread_cond_wait(&W->cv, &W->mu);  // sleep until kick or destroy
    } else {
      timespec ts;
      ts.tv_sec = W->deadline_ms / 1000;
      ts.tv_nsec = (W->deadline_ms % 1000) * 1000000;
      pthread_cond_timedwait(&W->cv, &W->mu, &ts);
    }
  }
  pthread_mutex_unlock(&W->mu);
  return nullptr;
}

}  // namespace

extern "C" {

void* dlcs_watchdog_create(int timeout_ms) {
  auto* W = new Watchdog;
  W->timeout_ms = timeout_ms;
  W->deadline_ms = now_ms() + timeout_ms;
  pthread_mutex_init(&W->mu, nullptr);
  pthread_condattr_t attr;
  pthread_condattr_init(&attr);
  pthread_condattr_setclock(&attr, CLOCK_MONOTONIC);
  pthread_cond_init(&W->cv, &attr);
  pthread_condattr_destroy(&attr);
  if (pthread_create(&W->th, nullptr, monitor, W) != 0) {
    pthread_cond_destroy(&W->cv);
    pthread_mutex_destroy(&W->mu);
    delete W;
    return nullptr;
  }
  return W;
}

// Reset the deadline (call once per training step / heartbeat interval).
// Also clears a latched expiry so the watchdog can re-arm after recovery.
void dlcs_watchdog_kick(void* h) {
  auto* W = static_cast<Watchdog*>(h);
  pthread_mutex_lock(&W->mu);
  W->deadline_ms = now_ms() + W->timeout_ms;
  W->expired = 0;
  pthread_cond_signal(&W->cv);
  pthread_mutex_unlock(&W->mu);
}

// 1 if the deadline lapsed without a kick since arming.
int dlcs_watchdog_expired(void* h) {
  auto* W = static_cast<Watchdog*>(h);
  pthread_mutex_lock(&W->mu);
  int e = W->expired;
  pthread_mutex_unlock(&W->mu);
  return e;
}

void dlcs_watchdog_destroy(void* h) {
  auto* W = static_cast<Watchdog*>(h);
  pthread_mutex_lock(&W->mu);
  W->stop = 1;
  pthread_cond_signal(&W->cv);
  pthread_mutex_unlock(&W->mu);
  pthread_join(W->th, nullptr);
  pthread_cond_destroy(&W->cv);
  pthread_mutex_destroy(&W->mu);
  delete W;
}

}  // extern "C"
