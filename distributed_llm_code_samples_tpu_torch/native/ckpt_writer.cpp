// Native async checkpoint writer — file I/O off the training critical path.
//
// The port's copy of the JAX package's native/ckpt_writer.cpp, the same
// C ABI. The reference has no serialization at all (SURVEY.md section 5);
// the checkpoint subsystem (checkpoint.py) with the npz backend is
// synchronous Python I/O, and for large models the write stalls training
// for the full params-to-disk time. This component moves the write to a
// native worker pool: `submit` memcpy's the leaf buffers (so the caller may donate or
// mutate its arrays immediately) and returns; a worker thread writes each
// leaf to `<tmp_dir>/<name>.raw` and atomically `rename`s the staged
// directory to `final_dir` — the same publish protocol as the Python
// backends, so `latest_step` never observes a torn checkpoint. Training
// on segment N+1 overlaps the disk write of segment N.
//
// Same ABI stance as watchdog.cpp: raw pthreads + POSIX I/O, C ABI only,
// no C++ runtime coupling beyond operator new; bound via ctypes
// (runtime/native.py, which builds both files into one library).

#include <fcntl.h>
#include <pthread.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Job {
  std::string tmp_dir;
  std::string final_dir;
  std::vector<std::string> names;
  std::vector<std::vector<char>> bufs;
  Job* next = nullptr;
};

struct Writer {
  pthread_mutex_t mu;
  pthread_cond_t cv_submit;  // signals workers: job available / stopping
  pthread_cond_t cv_done;    // signals waiters: pending count dropped
  Job* head = nullptr;       // FIFO queue
  Job* tail = nullptr;
  int pending = 0;  // queued + in-flight jobs
  int errors = 0;   // failed jobs (tmp dir left behind for debugging)
  int stop = 0;
  std::vector<pthread_t> threads;
};

// write the whole buffer + fsync, retrying short writes; 0 on success
int write_file(const std::string& path, const char* data, size_t size) {
  int fd = open(path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  size_t off = 0;
  while (off < size) {
    ssize_t w = write(fd, data + off, size - off);
    if (w < 0) {
      if (errno == EINTR) continue;
      close(fd);
      return -1;
    }
    off += static_cast<size_t>(w);
  }
  // data must be on disk BEFORE the publish rename: a journaled rename
  // with unflushed pages would survive a crash as a published-but-torn
  // step — exactly what the protocol exists to rule out
  if (fsync(fd) != 0) {
    close(fd);
    return -1;
  }
  return close(fd);
}

int fsync_dir(const std::string& dir) {
  int fd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (fd < 0) return -1;
  int rc = fsync(fd);
  close(fd);
  return rc;
}

int run_job(Job* j) {
  // the checkpoint layer may pre-create the tmp dir (it stages meta.json
  // there before submitting the arrays) — EEXIST is expected
  if (mkdir(j->tmp_dir.c_str(), 0755) != 0 && errno != EEXIST) return -1;
  for (size_t i = 0; i < j->names.size(); ++i) {
    std::string path = j->tmp_dir + "/" + j->names[i] + ".raw";
    if (write_file(path, j->bufs[i].data(), j->bufs[i].size()) != 0)
      return -1;
  }
  if (fsync_dir(j->tmp_dir) != 0) return -1;  // dir entries durable
  // atomic publish — after this, latest_step sees the complete step
  if (rename(j->tmp_dir.c_str(), j->final_dir.c_str()) != 0) return -1;
  // make the rename itself durable in the parent directory
  size_t slash = j->final_dir.find_last_of('/');
  std::string parent = slash == std::string::npos
                           ? std::string(".")
                           : j->final_dir.substr(0, slash);
  return fsync_dir(parent);
}

void* worker(void* arg) {
  auto* W = static_cast<Writer*>(arg);
  pthread_mutex_lock(&W->mu);
  for (;;) {
    while (W->head == nullptr && !W->stop)
      pthread_cond_wait(&W->cv_submit, &W->mu);
    if (W->head == nullptr && W->stop) break;
    Job* j = W->head;
    W->head = j->next;
    if (W->head == nullptr) W->tail = nullptr;
    pthread_mutex_unlock(&W->mu);

    int rc = run_job(j);

    pthread_mutex_lock(&W->mu);
    if (rc != 0) W->errors++;
    W->pending--;
    pthread_cond_broadcast(&W->cv_done);
    delete j;
  }
  pthread_mutex_unlock(&W->mu);
  return nullptr;
}

}  // namespace

extern "C" {

void* dlcs_ckpt_writer_create(int n_threads) {
  auto* W = new Writer;
  pthread_mutex_init(&W->mu, nullptr);
  pthread_cond_init(&W->cv_submit, nullptr);
  pthread_cond_init(&W->cv_done, nullptr);
  if (n_threads < 1) n_threads = 1;
  W->threads.resize(n_threads);
  for (int i = 0; i < n_threads; ++i)
    pthread_create(&W->threads[i], nullptr, worker, W);
  return W;
}

// Copies every buffer before returning: the caller's arrays are free the
// moment this returns (donation-safe).
void dlcs_ckpt_writer_submit(void* w, const char* tmp_dir,
                             const char* final_dir, const char** names,
                             const void** ptrs, const int64_t* sizes,
                             int n) {
  auto* W = static_cast<Writer*>(w);
  auto* j = new Job;
  j->tmp_dir = tmp_dir;
  j->final_dir = final_dir;
  j->names.reserve(n);
  j->bufs.reserve(n);
  for (int i = 0; i < n; ++i) {
    j->names.emplace_back(names[i]);
    j->bufs.emplace_back(static_cast<const char*>(ptrs[i]),
                         static_cast<const char*>(ptrs[i]) + sizes[i]);
  }
  pthread_mutex_lock(&W->mu);
  if (W->tail) W->tail->next = j; else W->head = j;
  W->tail = j;
  W->pending++;
  pthread_cond_signal(&W->cv_submit);
  pthread_mutex_unlock(&W->mu);
}

int dlcs_ckpt_writer_pending(void* w) {
  auto* W = static_cast<Writer*>(w);
  pthread_mutex_lock(&W->mu);
  int p = W->pending;
  pthread_mutex_unlock(&W->mu);
  return p;
}

// Block until every submitted job has been published (or failed).
void dlcs_ckpt_writer_wait(void* w) {
  auto* W = static_cast<Writer*>(w);
  pthread_mutex_lock(&W->mu);
  while (W->pending > 0) pthread_cond_wait(&W->cv_done, &W->mu);
  pthread_mutex_unlock(&W->mu);
}

int dlcs_ckpt_writer_errors(void* w) {
  auto* W = static_cast<Writer*>(w);
  pthread_mutex_lock(&W->mu);
  int e = W->errors;
  pthread_mutex_unlock(&W->mu);
  return e;
}

void dlcs_ckpt_writer_destroy(void* w) {
  auto* W = static_cast<Writer*>(w);
  pthread_mutex_lock(&W->mu);
  while (W->pending > 0) pthread_cond_wait(&W->cv_done, &W->mu);
  W->stop = 1;
  pthread_cond_broadcast(&W->cv_submit);
  pthread_mutex_unlock(&W->mu);
  for (pthread_t t : W->threads) pthread_join(t, nullptr);
  pthread_mutex_destroy(&W->mu);
  pthread_cond_destroy(&W->cv_submit);
  pthread_cond_destroy(&W->cv_done);
  delete W;
}

}  // extern "C"
