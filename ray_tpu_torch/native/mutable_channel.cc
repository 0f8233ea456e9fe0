// Mutable shared-memory channel: the native substrate for compiled-DAG
// channels on one host.
//
// Counterpart of the reference's native mutable objects
// (Ray's src/ray/core_worker/experimental_mutable_object_manager.h:44
// and the shared_memory_channel built on them): a fixed shm segment holding a
// circular byte ring with a process-shared mutex + condvars, so writer and
// reader block in the kernel (no polling) and payloads move with exactly one
// memcpy per side — no sockets, no store round-trips, no per-message object
// ids. Built as a shared library driven through ctypes
// (ray_tpu/dag/native_channel.py); Python↔C boundary is plain C.
//
// Layout: [Header][ring bytes]. Messages are [u32 len][payload] with wrap.
// One writer + one reader (the compiled-DAG edge contract).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055434841ULL;  // "RTPUCHA"

struct Header {
  uint64_t magic;
  uint64_t capacity;   // ring data bytes
  uint64_t head;       // read offset  (consumed bytes, monotonic)
  uint64_t tail;       // write offset (produced bytes, monotonic)
  uint32_t closed;
  pthread_mutex_t mu;
  pthread_cond_t nonempty;
  pthread_cond_t nonfull;
};

struct Channel {
  Header* h;
  uint8_t* data;
  uint64_t map_len;
};

uint64_t used(const Header* h) { return h->tail - h->head; }

void abs_deadline(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

void copy_in(Channel* c, uint64_t off, const uint8_t* src, uint64_t n) {
  uint64_t cap = c->h->capacity;
  uint64_t pos = off % cap;
  uint64_t first = (pos + n <= cap) ? n : cap - pos;
  memcpy(c->data + pos, src, first);
  if (n > first) memcpy(c->data, src + first, n - first);
}

void copy_out(Channel* c, uint64_t off, uint8_t* dst, uint64_t n) {
  uint64_t cap = c->h->capacity;
  uint64_t pos = off % cap;
  uint64_t first = (pos + n <= cap) ? n : cap - pos;
  memcpy(dst, c->data + pos, first);
  if (n > first) memcpy(dst + first, c->data, n - first);
}

}  // namespace

extern "C" {

// Create (O_EXCL) a channel of `capacity` ring bytes; returns handle or null.
void* mc_create(const char* name, uint64_t capacity) {
  uint64_t map_len = sizeof(Header) + capacity;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_len)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = static_cast<Header*>(mem);
  h->capacity = capacity;
  h->head = h->tail = 0;
  h->closed = 0;
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // a process can die mid-critical-section; robust mutexes let the peer
  // recover instead of deadlocking
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->nonempty, &ca);
  pthread_cond_init(&h->nonfull, &ca);
  h->magic = kMagic;  // last: marks fully-initialized
  auto* c = new Channel{h, reinterpret_cast<uint8_t*>(mem) + sizeof(Header),
                        map_len};
  return c;
}

void* mc_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(sizeof(Header))) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {  // creator not done initializing (or junk)
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* c = new Channel{h, reinterpret_cast<uint8_t*>(mem) + sizeof(Header),
                        static_cast<uint64_t>(st.st_size)};
  return c;
}

static int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // previous owner died holding the lock; state is still consistent for
    // our ring (offsets only advance after their copy completes)
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// pthread_cond_timedwait re-acquires the mutex on return, so the peer dying
// while we were blocked surfaces as EOWNERDEAD here too — it must be marked
// consistent exactly like lock_robust, or the next unlock/lock goes
// ENOTRECOVERABLE and wedges the channel for good.
static int timedwait_robust(pthread_cond_t* cv, Header* h,
                            const timespec* ts) {
  int rc = pthread_cond_timedwait(cv, &h->mu, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// Returns 0 ok, -1 timeout, -2 closed, -3 message larger than ring.
int mc_write(void* handle, const uint8_t* buf, uint64_t len, int timeout_ms) {
  auto* c = static_cast<Channel*>(handle);
  Header* h = c->h;
  uint64_t need = len + 4;
  if (need > h->capacity) return -3;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -2;
  while (h->capacity - used(h) < need && !h->closed) {
    if (timedwait_robust(&h->nonfull, h, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint32_t len32 = static_cast<uint32_t>(len);
  copy_in(c, h->tail, reinterpret_cast<uint8_t*>(&len32), 4);
  copy_in(c, h->tail + 4, buf, len);
  h->tail += need;
  pthread_cond_signal(&h->nonempty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Returns payload length (copied into out, up to out_cap), -1 timeout,
// -2 closed-and-drained, -4 out_cap too small (message left in place; call
// mc_next_len to size the buffer).
int64_t mc_read(void* handle, uint8_t* out, uint64_t out_cap,
                int timeout_ms) {
  auto* c = static_cast<Channel*>(handle);
  Header* h = c->h;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -2;
  while (used(h) == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    if (timedwait_robust(&h->nonempty, h, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  uint32_t len32 = 0;
  copy_out(c, h->head, reinterpret_cast<uint8_t*>(&len32), 4);
  if (len32 > out_cap) {
    pthread_mutex_unlock(&h->mu);
    return -4;
  }
  copy_out(c, h->head + 4, out, len32);
  h->head += len32 + 4;
  pthread_cond_signal(&h->nonfull);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len32);
}

// Length of the next queued message, -1 if empty, -2 closed-and-drained.
int64_t mc_next_len(void* handle) {
  auto* c = static_cast<Channel*>(handle);
  Header* h = c->h;
  if (lock_robust(h) != 0) return -2;
  int64_t out;
  if (used(h) == 0) {
    out = h->closed ? -2 : -1;
  } else {
    uint32_t len32 = 0;
    copy_out(c, h->head, reinterpret_cast<uint8_t*>(&len32), 4);
    out = static_cast<int64_t>(len32);
  }
  pthread_mutex_unlock(&h->mu);
  return out;
}

void mc_close_channel(void* handle) {
  auto* c = static_cast<Channel*>(handle);
  Header* h = c->h;
  if (lock_robust(h) == 0) {
    h->closed = 1;
    pthread_cond_broadcast(&h->nonempty);
    pthread_cond_broadcast(&h->nonfull);
    pthread_mutex_unlock(&h->mu);
  }
}

void mc_release(void* handle) {
  auto* c = static_cast<Channel*>(handle);
  munmap(c->h, c->map_len);
  delete c;
}

int mc_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
