// _rtpu_core: native transport core for direct actor calls.
//
// Counterpart of the reference's C++ core-worker transport
// (Ray's src/ray/core_worker/transport/actor_task_submitter.cc +
// task_receiver.cc): framing, socket I/O, and frame parsing in C++ with the
// GIL released.  Round-2's pure-Python direct path paid for pickled frame
// envelopes and a Python thread-per-connection; on a single-core host that
// overhead IS the actor-call ceiling (BENCH_core n:n at 0.41x reference).
//
// Design: THREADLESS.  The extension spawns no threads at all — on a
// one-core box every extra hop between threads is pure scheduling latency:
//
//   caller:  Channel.submit(frame)        — sendall on the calling thread
//            Channel.recv_reply(ms)       — recv+parse on the calling
//                                           thread (the Python drain
//                                           thread), GIL released while
//                                           blocked.  One wake per reply,
//                                           exactly like a plain socket
//                                           reader, but parsing is C++.
//   callee:  Server.next(ms)              — epoll accept/read/parse on the
//                                           calling thread (the single
//                                           Python executor); returns one
//                                           complete call frame.
//            Server.reply(conn_id, frame) — sendall on the same thread.
//
// Frames are the 4-byte-LE length-prefixed format of _private/protocol.py;
// bodies are the records built by _private/direct.py (0x01/0x02/0x03
// binary dialect; 0x80-first-byte legacy pickles from Python-fallback
// peers pass through opaquely — the Python layer handles both).
//
// Build: CPython C API (no pybind11 in this image) — see native/build.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/eventfd.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <stdint.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMaxFrame = 1u << 28;

bool send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        // Non-blocking fd (server-accepted conns) with a full buffer:
        // wait for drain.  Bailing here would truncate mid-frame and
        // permanently desync the stream.
        struct pollfd pfd{fd, POLLOUT, 0};
        if (::poll(&pfd, 1, 10000) <= 0) return false;
        continue;
      }
      return false;
    }
    p += k;
    n -= size_t(k);
  }
  return true;
}

// Framed send, caller already holds the send lock: one writev-ish call
// (header copied into a stack prefix for small frames to keep it a
// single syscall).
bool send_frame_locked(int fd, const char* body, size_t n) {
  uint32_t len = uint32_t(n);
  if (n <= 65536 - 4) {
    char buf[65536];
    memcpy(buf, &len, 4);
    memcpy(buf + 4, body, n);
    return send_all(fd, buf, n + 4);
  }
  char hdr[4];
  memcpy(hdr, &len, 4);
  return send_all(fd, hdr, 4) && send_all(fd, body, n);
}

bool send_frame(int fd, std::mutex& mu, const char* body, size_t n) {
  std::lock_guard<std::mutex> g(mu);
  return send_frame_locked(fd, body, n);
}

// Incremental frame extraction: 1 = frame out, 0 = need more bytes,
// -1 = poisoned stream (oversize length) — the caller MUST drop the
// connection; after a bogus length no later byte boundary can be trusted.
int extract_frame(std::string& acc, std::string* out) {
  if (acc.size() < 4) return 0;
  uint32_t len;
  memcpy(&len, acc.data(), 4);
  if (len > kMaxFrame) return -1;
  if (acc.size() < 4 + size_t(len)) return 0;
  out->assign(acc, 4, len);
  acc.erase(0, 4 + size_t(len));
  return 1;
}

// ---------- Channel (caller side) ----------

struct ChannelCore {
  int fd = -1;
  std::mutex send_mu;
  std::string in;  // recv accumulation (single reader thread by contract)
  std::string out;  // submit_buffered coalescing (flushed by flush())
  bool dead = false;
};

// The coalescing cap: past this, submit_buffered flushes inline so a
// burst of large frames cannot balloon the buffer.
constexpr size_t kSubmitBufferCap = 256 * 1024;

typedef struct {
  PyObject_HEAD
  ChannelCore* core;
} ChannelObject;

static PyObject* Channel_new(PyTypeObject* type, PyObject* args,
                             PyObject* kwds) {
  int fd;
  if (!PyArg_ParseTuple(args, "i", &fd)) return nullptr;
  ChannelObject* self = (ChannelObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->core = new ChannelCore();
  self->core->fd = fd;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  return (PyObject*)self;
}

static void Channel_dealloc(ChannelObject* self) {
  if (self->core) {
    ::shutdown(self->core->fd, SHUT_RDWR);
    ::close(self->core->fd);
    delete self->core;
    self->core = nullptr;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* Channel_submit(ChannelObject* self, PyObject* args) {
  Py_buffer frame;
  if (!PyArg_ParseTuple(args, "y*", &frame)) return nullptr;
  ChannelCore* c = self->core;
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  {
    std::lock_guard<std::mutex> g(c->send_mu);
    if (c->dead) {
      ok = false;
    } else {
      // drain any coalesced frames first: mixing submit_buffered and
      // submit on one channel must preserve submission order
      if (!c->out.empty()) {
        ok = send_all(c->fd, c->out.data(), c->out.size());
        c->out.clear();
      }
      if (ok)
        ok = send_frame_locked(c->fd, (const char*)frame.buf,
                               size_t(frame.len));
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&frame);
  return PyBool_FromLong(ok);
}

// submit_buffered(frame) -> bool: append to the coalescing buffer with NO
// syscall; a later flush() (or hitting the cap) writes every pending
// frame in one send.  Halves the per-call syscall budget on the n:n
// fan-in path (reference batches the same way via gRPC streams).
static PyObject* Channel_submit_buffered(ChannelObject* self,
                                         PyObject* args) {
  Py_buffer frame;
  if (!PyArg_ParseTuple(args, "y*", &frame)) return nullptr;
  ChannelCore* c = self->core;
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  {
    std::lock_guard<std::mutex> g(c->send_mu);
    if (c->dead) {
      ok = false;
    } else {
      uint32_t len = uint32_t(frame.len);
      c->out.append((const char*)&len, 4);
      c->out.append((const char*)frame.buf, size_t(frame.len));
      if (c->out.size() >= kSubmitBufferCap) {
        ok = send_all(c->fd, c->out.data(), c->out.size());
        c->out.clear();
      }
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&frame);
  return PyBool_FromLong(ok);
}

static PyObject* Channel_flush(ChannelObject* self, PyObject*) {
  ChannelCore* c = self->core;
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  {
    std::lock_guard<std::mutex> g(c->send_mu);
    if (!c->out.empty()) {
      ok = !c->dead && send_all(c->fd, c->out.data(), c->out.size());
      c->out.clear();
    }
  }
  Py_END_ALLOW_THREADS
  return PyBool_FromLong(ok);
}

// recv_reply(timeout_ms) -> (task_id, flags, payload) | None on timeout;
// raises ConnectionError on EOF/reset.  Non-0x02 frames are skipped.
static PyObject* Channel_recv_reply(ChannelObject* self, PyObject* args) {
  long timeout_ms;
  if (!PyArg_ParseTuple(args, "l", &timeout_ms)) return nullptr;
  ChannelCore* c = self->core;
  std::string frame;
  bool got = false;
  Py_BEGIN_ALLOW_THREADS
  for (;;) {
    int fr = extract_frame(c->in, &frame);
    if (fr < 0) {  // poisoned framing: the channel is unusable
      c->dead = true;
      ::shutdown(c->fd, SHUT_RDWR);
      break;
    }
    if (fr > 0) {
      if (frame.size() >= 3 && uint8_t(frame[0]) == 0x02) {
        got = true;
        break;
      }
      continue;  // not a reply frame: skip
    }
    if (c->dead) break;
    struct pollfd pfd{c->fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, int(timeout_ms));
    if (pr == 0) break;  // timeout
    if (pr < 0) {
      if (errno == EINTR) continue;
      c->dead = true;
      break;
    }
    char buf[1 << 16];
    ssize_t k = ::recv(c->fd, buf, sizeof buf, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      c->dead = true;
      break;
    }
    c->in.append(buf, size_t(k));
  }
  Py_END_ALLOW_THREADS
  if (got) {
    uint8_t tl = uint8_t(frame[1]);
    if (frame.size() < size_t(2 + tl + 1)) Py_RETURN_NONE;
    uint8_t flags = uint8_t(frame[2 + tl]);
    return Py_BuildValue("(y#iy#)", frame.data() + 2, Py_ssize_t(tl),
                         int(flags), frame.data() + 2 + tl + 1,
                         Py_ssize_t(frame.size() - 2 - tl - 1));
  }
  if (self->core->dead) {
    PyErr_SetString(PyExc_ConnectionError, "direct channel lost");
    return nullptr;
  }
  Py_RETURN_NONE;
}

// recv_replies(timeout_ms) -> [(task_id, flags, payload), ...] | None on
// timeout.  Blocks for the FIRST reply, then drains every further frame
// already buffered/readable without blocking — one Python call (and one
// GIL acquisition) per burst instead of per reply.
static PyObject* Channel_recv_replies(ChannelObject* self, PyObject* args) {
  long timeout_ms;
  if (!PyArg_ParseTuple(args, "l", &timeout_ms)) return nullptr;
  ChannelCore* c = self->core;
  std::deque<std::string> frames;
  Py_BEGIN_ALLOW_THREADS
  bool blocking_done = false;
  for (;;) {
    std::string frame;
    int fr = extract_frame(c->in, &frame);
    if (fr < 0) {
      c->dead = true;
      ::shutdown(c->fd, SHUT_RDWR);
      break;
    }
    if (fr > 0) {
      if (frame.size() >= 3 && uint8_t(frame[0]) == 0x02)
        frames.push_back(std::move(frame));
      continue;
    }
    if (c->dead) break;
    // buffer exhausted: block only while we have nothing to hand back
    int wait_ms = frames.empty() && !blocking_done ? int(timeout_ms) : 0;
    struct pollfd pfd{c->fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, wait_ms);
    if (pr == 0) {
      if (wait_ms != 0) blocking_done = true;
      break;
    }
    if (pr < 0) {
      if (errno == EINTR) continue;
      c->dead = true;
      break;
    }
    char buf[1 << 16];
    ssize_t k = ::recv(c->fd, buf, sizeof buf, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      c->dead = true;
      break;
    }
    c->in.append(buf, size_t(k));
  }
  Py_END_ALLOW_THREADS
  if (!frames.empty()) {
    PyObject* list = PyList_New(Py_ssize_t(frames.size()));
    if (!list) return nullptr;
    Py_ssize_t i = 0;
    for (const std::string& frame : frames) {
      uint8_t tl = uint8_t(frame[1]);
      PyObject* item;
      if (frame.size() < size_t(2 + tl + 1)) {
        item = Py_None;
        Py_INCREF(item);
      } else {
        uint8_t flags = uint8_t(frame[2 + tl]);
        item = Py_BuildValue("(y#iy#)", frame.data() + 2, Py_ssize_t(tl),
                             int(flags), frame.data() + 2 + tl + 1,
                             Py_ssize_t(frame.size() - 2 - tl - 1));
        if (!item) {
          Py_DECREF(list);
          return nullptr;
        }
      }
      PyList_SET_ITEM(list, i++, item);
    }
    return list;
  }
  if (c->dead) {
    PyErr_SetString(PyExc_ConnectionError, "direct channel lost");
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyObject* Channel_is_dead(ChannelObject* self, PyObject*) {
  return PyBool_FromLong(self->core->dead);
}

static PyObject* Channel_close(ChannelObject* self, PyObject*) {
  self->core->dead = true;
  ::shutdown(self->core->fd, SHUT_RDWR);
  Py_RETURN_NONE;
}

static PyMethodDef Channel_methods[] = {
    {"submit", (PyCFunction)Channel_submit, METH_VARARGS,
     "submit(frame) -> bool (False when the connection is gone)"},
    {"submit_buffered", (PyCFunction)Channel_submit_buffered, METH_VARARGS,
     "submit_buffered(frame) -> bool (no syscall until flush/cap)"},
    {"flush", (PyCFunction)Channel_flush, METH_NOARGS,
     "flush() -> bool: one send for every buffered frame"},
    {"recv_reply", (PyCFunction)Channel_recv_reply, METH_VARARGS,
     "recv_reply(timeout_ms) -> (task_id, flags, payload) | None; raises "
     "ConnectionError when the channel is dead"},
    {"recv_replies", (PyCFunction)Channel_recv_replies, METH_VARARGS,
     "recv_replies(timeout_ms) -> list of replies | None; drains the "
     "whole readable burst per call"},
    {"is_dead", (PyCFunction)Channel_is_dead, METH_NOARGS, ""},
    {"close", (PyCFunction)Channel_close, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject ChannelType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------- Raylet core (native local dispatch) ----------
//
// C++ counterpart of the reference raylet's local task manager + worker
// lease grant (Ray's src/ray/raylet/local_task_manager.cc,
// node_manager.cc HandleRequestWorkerLease:1892): the steady-state
// dispatch cycle for plain stateless tasks —
//
//   caller 0x10 SUBMIT -> [queue] -> resource deduct + idle-worker pick
//     -> 0x11 ASSIGN to the worker -> worker 0x12 DONE -> resource return
//     -> next dispatch; 0x13 batches sealed-object ids
//
// runs entirely inside the Server's epoll thread with the GIL released.
// Python stays the OWNER of policy (placement groups, affinity, labels,
// runtime envs, actor lifecycle, retries on worker death, multi-node
// spillback) and calls in through the raylet_* methods; the ledger here
// is the single owner of node resources so the two lanes cannot drift.
//
// Binary node-service frames (first byte; pickled frames start 0x80):
//   0x10 SUBMIT : [u8 tl][tid][f64 cpu][payload = pickled TaskSpec]
//   0x11 ASSIGN : [u8 tl][tid][payload]            (raylet -> worker)
//   0x12 DONE   : [u8 tl][tid][u8 ok]              (worker -> raylet)
//   0x13 SEALED : [u8 n]{[u8 len][oid]}*n          (worker -> raylet)

struct ServerCore;

struct RayletCore {
  std::mutex mu;  // guards everything below (serve thread + Python threads)
  std::map<std::string, double> avail;  // the node resource ledger
  std::deque<uint64_t> idle;            // native-capable idle workers
  std::set<uint64_t> idle_set;
  std::set<uint64_t> bound;             // all native-bound worker conns
  struct Pending {
    std::string tid;
    std::string name;
    double cpu;
    std::string assign;  // pre-built 0x11 frame body
  };
  std::deque<Pending> pending;
  struct InFlight {
    double cpu;
    std::string assign;  // kept for worker-death orphan recovery
    std::string name;
    bool blocked = false;  // CPU released while the task blocks in get()
  };
  std::unordered_map<uint64_t, std::map<std::string, InFlight>> inflight;
  // Per-dead-conn assign frames (keyed so OOM provenance of ONE worker's
  // kill is never applied to another's orphans).
  std::map<uint64_t, std::vector<std::string>> orphans;
  // Assign frames of tasks whose demand exceeds node TOTALS — can never
  // dispatch; Python fails them with a clear error.
  std::vector<std::string> infeasible;
  bool infeasible_marker = false;
  std::map<std::string, double> total;  // node totals (infeasibility)
  std::vector<std::string> sealed;   // oid batch for Python to publish
  bool sealed_marker = false;  // a drain marker is already queued to Python
  // Task-event ring for the state API / timeline (reference:
  // GcsTaskManager): Python drains + merges lazily on state queries, so
  // the steady state writes a struct, never wakes Python.
  // state: 0=PENDING 1=RUNNING 2=FINISHED 3=FAILED
  struct Event {
    std::string tid;
    std::string name;
    uint8_t state;
    double ts;
  };
  std::deque<Event> events;
  // flag-registry tunable (RTPU_RAYLET_EVENT_CAP, _private/flags.py)
  size_t max_events = [] {
    const char* v = getenv("RTPU_RAYLET_EVENT_CAP");
    if (!v || !*v) return size_t(50000);
    char* end = nullptr;
    long long n = strtoll(v, &end, 10);
    // garbage/non-positive falls back (registry _coerce contract)
    return (end && *end == '\0' && n > 0) ? size_t(n) : size_t(50000);
  }();

  void push_event_locked(const std::string& tid, const std::string& name,
                         uint8_t state) {
    struct timespec t;
    clock_gettime(CLOCK_REALTIME, &t);
    events.push_back({tid, name, state, double(t.tv_sec) +
                                            double(t.tv_nsec) * 1e-9});
    while (events.size() > max_events) events.pop_front();
  }
  uint64_t n_dispatched = 0, n_done = 0, n_submitted = 0;
  bool enabled = false;
  bool accept_submits = true;  // false: 0x10 falls through to Python
                               // (multi-node policy path)

  bool try_acquire_locked(const std::map<std::string, double>& need) {
    for (const auto& [k, v] : need) {
      auto it = avail.find(k);
      if ((it == avail.end() ? 0.0 : it->second) < v) return false;
    }
    for (const auto& [k, v] : need) avail[k] -= v;
    return true;
  }

  void release_locked(const std::map<std::string, double>& res) {
    for (const auto& [k, v] : res) avail[k] += v;
  }

  void remove_worker_locked(uint64_t id) {
    bound.erase(id);
    if (idle_set.erase(id)) {
      for (auto it = idle.begin(); it != idle.end(); ++it) {
        if (*it == id) {
          idle.erase(it);
          break;
        }
      }
    }
    auto inf = inflight.find(id);
    if (inf != inflight.end()) {
      for (auto& [tid, fl] : inf->second) {
        if (!fl.blocked) avail["CPU"] += fl.cpu;  // blocked already returned
        orphans[id].push_back(std::move(fl.assign));
      }
      inflight.erase(inf);
    }
  }
};

// ---------- Server (callee side) ----------

struct ConnState {
  int fd;
  std::string in;
  enum Phase { AUTH, READY } phase = READY;
};

struct ServerCore {
  // Threadless contract: the conns map and every socket write/read/close
  // happen ONLY on the thread inside Server_next (the Python executor).
  // Other threads (max_concurrency>1 pool callbacks) hand replies over
  // through out_queue + an eventfd wake — they never touch sockets, so
  // there is no map race and no send-to-recycled-fd window.
  int epfd = -1;
  int listen_fd = -1;
  int wake_fd = -1;  // eventfd: reply producers wake the epoll loop
  bool is_tcp = false;
  bool closed = false;
  std::string token;
  std::map<uint64_t, ConnState> conns;
  uint64_t next_conn_id = 1;
  std::map<int, uint64_t> by_fd;
  std::deque<std::pair<uint64_t, std::string>> ready;  // parsed call frames
  std::mutex out_mu;  // guards out_queue only
  std::deque<std::pair<uint64_t, std::string>> out_queue;
  std::mutex dummy_send_mu;  // sends are single-threaded; kept for helpers
  RayletCore* raylet = nullptr;
  // Native memory monitor (reference: src/ray/common/memory_monitor.h —
  // a C++ timer sampling cgroup/meminfo usage).  Sampling + threshold
  // detection run here in the epoll loop (no GIL, no Python thread); on
  // a crossing, a 0x7e marker frame wakes Python, which owns the victim
  // policy and the kill (our C++/Python split everywhere).
  // atomics: enable/ack are called from Python threads while the serve
  // thread reads these GIL-free inside Server_next
  std::atomic<double> mm_threshold{0};  // 0 = disabled
  std::atomic<double> mm_interval_s{1.0};
  std::atomic<double> mm_cooldown_s{5.0};
  std::atomic<double> mm_next_check{0};
  std::atomic<double> mm_last_fire{0};

  static bool node_mem_usage(uint64_t* used, uint64_t* total) {
    // cgroup v2 first (containerized nodes), /proc/meminfo fallback
    FILE* f = fopen("/sys/fs/cgroup/memory.max", "r");
    if (f) {
      char buf[64] = {0};
      bool have = fgets(buf, sizeof buf, f) != nullptr;
      fclose(f);
      if (have && strncmp(buf, "max", 3) != 0) {
        uint64_t limit = strtoull(buf, nullptr, 10);
        FILE* g = fopen("/sys/fs/cgroup/memory.current", "r");
        if (g && limit > 0) {
          char cur[64] = {0};
          bool ok = fgets(cur, sizeof cur, g) != nullptr;
          fclose(g);
          if (ok) {
            *used = strtoull(cur, nullptr, 10);
            *total = limit;
            return true;
          }
        } else if (g) {
          fclose(g);
        }
      }
    }
    f = fopen("/proc/meminfo", "r");
    if (!f) return false;
    uint64_t total_kb = 0, avail_kb = 0;
    char line[256];
    while (fgets(line, sizeof line, f)) {
      if (sscanf(line, "MemTotal: %lu kB", &total_kb) == 1) continue;
      if (sscanf(line, "MemAvailable: %lu kB", &avail_kb) == 1) continue;
    }
    fclose(f);
    if (total_kb == 0) return false;
    *total = total_kb * 1024;
    *used = (total_kb > avail_kb ? total_kb - avail_kb : 0) * 1024;
    return true;
  }

  static double mono_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
  }

  // Serve-thread only: sample on the interval; emit ONE 0x7e marker
  // (u64 used | u64 total, LE) per crossing, rate-limited by cooldown.
  void memory_check() {
    double thr = mm_threshold.load();
    if (thr <= 0) return;
    double now = mono_now();
    if (now < mm_next_check.load()) return;
    mm_next_check.store(now + mm_interval_s.load());
    uint64_t used = 0, total = 0;
    if (!node_mem_usage(&used, &total) || total == 0) return;
    if (double(used) / double(total) < thr) return;
    if (now - mm_last_fire.load() < mm_cooldown_s.load()) return;
    mm_last_fire.store(now);
    std::string frame(17, '\0');
    frame[0] = char(0x7e);
    memcpy(frame.data() + 1, &used, 8);
    memcpy(frame.data() + 9, &total, 8);
    ready.emplace_back(0, std::move(frame));
  }
  std::vector<uint64_t> pending_drops;  // conns to drop after event loop

  void drop(uint64_t id) {
    auto it = conns.find(id);
    if (it == conns.end()) return;
    epoll_ctl(epfd, EPOLL_CTL_DEL, it->second.fd, nullptr);
    by_fd.erase(it->second.fd);
    ::close(it->second.fd);
    bool was_ready = it->second.phase == ConnState::READY;
    conns.erase(it);
    if (raylet) {
      std::lock_guard<std::mutex> g(raylet->mu);
      raylet->remove_worker_locked(id);
    }
    // surface the disconnect to Python as an EMPTY frame (never legal on
    // the wire) so the consumer can run its death/cleanup handler — the
    // raylet-mode consumer requeues the dead worker's in-flight tasks
    if (was_ready) ready.emplace_back(id, std::string());
  }

  // Serve-thread only: dispatch queued plain tasks onto idle workers.
  void raylet_pump() {
    RayletCore* r = raylet;
    if (!r || !r->enabled) return;
    std::vector<std::pair<uint64_t, std::string>> sends;
    bool emit_sealed = false, emit_infeasible = false;
    {
      std::lock_guard<std::mutex> g(r->mu);
      if (!r->sealed.empty() && !r->sealed_marker) {
        // wake Python exactly once per batch to publish locations
        r->sealed_marker = true;
        emit_sealed = true;
      }
      // Infeasible tasks are routed at SUBMIT time (node totals are
      // immutable after raylet_enable, so the check is O(1) per task and
      // never needs a queue scan); the pump only publishes the wake-up so
      // Python fails them — unconditionally, NOT gated on idle workers.
      if (!r->infeasible.empty() && !r->infeasible_marker) {
        r->infeasible_marker = true;
        emit_infeasible = true;
      }
      // First-fit over the WHOLE queue: a head task waiting for capacity
      // must not wedge smaller tasks behind it (the Python lane requeues
      // unschedulable specs and keeps going — same semantics here).
      for (auto it = r->pending.begin();
           it != r->pending.end() && !r->idle.empty();) {
        RayletCore::Pending& p = *it;
        if (p.cpu > 0) {
          std::map<std::string, double> need{{"CPU", p.cpu}};
          if (!r->try_acquire_locked(need)) {
            ++it;  // not now; later (smaller) tasks may still fit
            continue;
          }
        }
        uint64_t w = r->idle.front();
        r->idle.pop_front();
        r->idle_set.erase(w);
        r->push_event_locked(p.tid, p.name, 1);
        r->inflight[w].emplace(
            p.tid, RayletCore::InFlight{p.cpu, p.assign, p.name});
        sends.emplace_back(w, std::move(p.assign));
        r->n_dispatched++;
        it = r->pending.erase(it);
      }
    }
    if (emit_sealed) ready.emplace_back(0, std::string("\x13"));
    if (emit_infeasible) ready.emplace_back(0, std::string("\x7f"));
    for (auto& [w, frame] : sends) {
      auto it = conns.find(w);
      bool ok = it != conns.end() &&
                send_frame(it->second.fd, dummy_send_mu, frame.data(),
                           frame.size());
      if (!ok) {
        // worker vanished mid-dispatch: orphan the task for Python's
        // retry path and schedule the connection drop
        std::lock_guard<std::mutex> g(r->mu);
        size_t tl = frame.size() >= 2 ? uint8_t(frame[1]) : 0;
        std::string tid = frame.size() >= 2 + tl ? frame.substr(2, tl)
                                                 : std::string();
        auto inf = r->inflight.find(w);
        if (inf != r->inflight.end()) {
          auto t = inf->second.find(tid);
          if (t != inf->second.end()) {
            r->avail["CPU"] += t->second.cpu;
            r->orphans[w].push_back(std::move(t->second.assign));
            inf->second.erase(t);
          }
        }
        pending_drops.push_back(w);
      }
    }
  }

  // Serve-thread only: true when the frame was a raylet-lane frame.
  bool raylet_handle(uint64_t id, const std::string& f) {
    RayletCore* r = raylet;
    if (!r || !r->enabled || f.size() < 2) return false;
    uint8_t k = uint8_t(f[0]);
    if (k == 0x10) {  // SUBMIT from a worker/driver connection
      if (!r->accept_submits) return false;  // Python policy path takes it
      size_t tl = uint8_t(f[1]);
      if (f.size() < 2 + tl + 8 + 2) return true;  // malformed: swallow
      std::string tid = f.substr(2, tl);
      double cpu;
      memcpy(&cpu, f.data() + 2 + tl, 8);
      uint16_t nl;
      memcpy(&nl, f.data() + 2 + tl + 8, 2);
      size_t off = 2 + tl + 8 + 2;
      if (f.size() < off + nl) return true;
      std::string name = f.substr(off, nl);
      off += nl;
      std::string assign;
      assign.reserve(f.size() - off + 2 + tl);
      assign.push_back(char(0x11));
      assign.push_back(char(tl));
      assign += tid;
      assign.append(f, off, std::string::npos);
      std::lock_guard<std::mutex> g(r->mu);
      r->n_submitted++;
      r->push_event_locked(tid, name, 0);
      auto tot = r->total.find("CPU");
      if (cpu > (tot == r->total.end() ? 0.0 : tot->second)) {
        // demand exceeds node totals: fail fast even with zero idle
        // workers — never queue what can never run
        r->infeasible.push_back(std::move(assign));
      } else {
        r->pending.push_back(
            {std::move(tid), std::move(name), cpu, std::move(assign)});
      }
      return true;
    }
    if (k == 0x12) {  // DONE
      size_t tl = uint8_t(f[1]);
      if (f.size() < 2 + tl) return true;
      std::lock_guard<std::mutex> g(r->mu);
      auto inf = r->inflight.find(id);
      if (inf != r->inflight.end()) {
        std::string tid = f.substr(2, tl);
        auto t = inf->second.find(tid);
        if (t != inf->second.end()) {
          if (!t->second.blocked) r->avail["CPU"] += t->second.cpu;
          bool ok = f.size() > 2 + tl && f[2 + tl] != 0;
          r->push_event_locked(tid, t->second.name, ok ? 2 : 3);
          inf->second.erase(t);
          r->n_done++;
        }
      }
      if (r->bound.count(id) && !r->idle_set.count(id) &&
          (inf == r->inflight.end() || inf->second.empty())) {
        r->idle.push_back(id);
        r->idle_set.insert(id);
      }
      return true;
    }
    if (k == 0x13) {  // SEALED oid batch
      size_t n = uint8_t(f[1]);
      size_t pos = 2;
      std::lock_guard<std::mutex> g(r->mu);
      for (size_t i = 0; i < n && pos < f.size(); ++i) {
        size_t l = uint8_t(f[pos]);
        pos += 1;
        if (pos + l > f.size()) break;
        r->sealed.emplace_back(f, pos, l);
        pos += l;
      }
      return true;
    }
    return false;
  }

  // Exec-thread only: drain queued replies onto their sockets.  An empty
  // queued frame is the close command (Server.kick).
  void flush_replies() {
    for (;;) {
      uint64_t id;
      std::string frame;
      {
        std::lock_guard<std::mutex> g(out_mu);
        if (out_queue.empty()) return;
        id = out_queue.front().first;
        frame = std::move(out_queue.front().second);
        out_queue.pop_front();
      }
      auto it = conns.find(id);
      if (it == conns.end()) continue;  // caller hung up; it will resend
      if (frame.empty()) {
        drop(id);
        continue;
      }
      if (!send_frame(it->second.fd, dummy_send_mu, frame.data(),
                      frame.size()))
        drop(id);
    }
  }

  void accept_ready() {
    for (;;) {
      int fd = ::accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
      if (fd < 0) return;
      if (is_tcp) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      }
      uint64_t id = next_conn_id++;  // starts at 2 (0=listener, 1=wake)
      ConnState cs;
      cs.fd = fd;
      cs.phase = is_tcp ? ConnState::AUTH : ConnState::READY;
      conns.emplace(id, std::move(cs));
      by_fd[fd] = id;
      struct epoll_event ev;
      ev.events = EPOLLIN;
      ev.data.u64 = id;
      epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  // Read everything available on conn `id`; parse complete frames into
  // `ready`.  Returns false when the conn died.
  bool read_conn(uint64_t id) {
    auto it = conns.find(id);
    if (it == conns.end()) return false;
    ConnState& cs = it->second;
    char buf[1 << 16];
    for (;;) {
      ssize_t k = ::recv(cs.fd, buf, sizeof buf, 0);
      if (k > 0) {
        cs.in.append(buf, size_t(k));
        if (cs.in.size() > kMaxFrame + 4) return false;
      } else if (k == 0) {
        return false;
      } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
        break;
      } else if (errno != EINTR) {
        return false;
      }
    }
    std::string frame;
    int fr;
    while ((fr = extract_frame(cs.in, &frame)) != 0) {
      if (fr < 0) return false;  // poisoned framing: drop the connection
      if (cs.phase == ConnState::AUTH) {
        // cluster-token handshake (reference of record:
        // protocol.py authenticate_server_side), constant-time-ish
        unsigned char d = frame.size() == token.size() ? 0 : 1;
        for (size_t i = 0; i < frame.size() && i < token.size(); ++i)
          d |= (unsigned char)(frame[i]) ^ (unsigned char)(token[i]);
        if (d != 0) {
          send_frame(cs.fd, dummy_send_mu, "NO", 2);
          return false;
        }
        if (!send_frame(cs.fd, dummy_send_mu, "OK", 2)) return false;
        cs.phase = ConnState::READY;
        continue;
      }
      if (frame.empty()) continue;  // empty frames are reserved markers
      if (raylet && raylet_handle(id, frame)) {
        frame.clear();
        continue;  // consumed natively: Python never sees it
      }
      ready.emplace_back(id, std::move(frame));
      frame.clear();
    }
    return true;
  }
};

typedef struct {
  PyObject_HEAD
  ServerCore* core;
} ServerObject;

static PyObject* Server_new(PyTypeObject* type, PyObject* args,
                            PyObject* kwds) {
  int fd, is_tcp;
  const char* token;
  Py_ssize_t token_len;
  if (!PyArg_ParseTuple(args, "ipy#", &fd, &is_tcp, &token, &token_len))
    return nullptr;
  ServerObject* self = (ServerObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  ServerCore* c = new ServerCore();
  self->core = c;
  c->listen_fd = fd;
  c->is_tcp = is_tcp != 0;
  c->token.assign(token, size_t(token_len));
  c->next_conn_id = 2;  // 0 = listener sentinel, 1 = wake sentinel
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  c->epfd = epoll_create1(0);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = 0;  // 0 = the listener
  epoll_ctl(c->epfd, EPOLL_CTL_ADD, fd, &ev);
  c->wake_fd = eventfd(0, EFD_NONBLOCK);
  struct epoll_event wev;
  wev.events = EPOLLIN;
  wev.data.u64 = 1;  // 1 = reply-queue wake
  epoll_ctl(c->epfd, EPOLL_CTL_ADD, c->wake_fd, &wev);
  return (PyObject*)self;
}

static void Server_dealloc(ServerObject* self) {
  ServerCore* c = self->core;
  if (c) {
    for (auto& [id, cs] : c->conns) ::close(cs.fd);
    ::close(c->listen_fd);
    ::close(c->wake_fd);
    ::close(c->epfd);
    delete c->raylet;
    delete c;
    self->core = nullptr;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

// ---------- raylet_* methods (Python-facing; touch state, never sockets) --

static bool dict_to_resmap(PyObject* d, std::map<std::string, double>* out) {
  PyObject *key, *value;
  Py_ssize_t pos = 0;
  while (PyDict_Next(d, &pos, &key, &value)) {
    const char* k = PyUnicode_AsUTF8(key);
    double v = PyFloat_AsDouble(value);
    if (!k || (v == -1.0 && PyErr_Occurred())) return false;
    (*out)[k] = v;
  }
  return true;
}

static void raylet_wake(ServerCore* c) {
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, 8);
}

static RayletCore* raylet_of(ServerObject* self) {
  ServerCore* c = self->core;
  if (!c->raylet) {
    PyErr_SetString(PyExc_RuntimeError, "raylet not enabled");
    return nullptr;
  }
  return c->raylet;
}

static PyObject* Server_raylet_enable(ServerObject* self, PyObject* args) {
  PyObject* resources;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &resources))
    return nullptr;
  ServerCore* c = self->core;
  if (!c->raylet) c->raylet = new RayletCore();
  std::map<std::string, double> res;
  if (!dict_to_resmap(resources, &res)) return nullptr;
  {
    std::lock_guard<std::mutex> g(c->raylet->mu);
    c->raylet->total = res;
    c->raylet->avail = std::move(res);
    c->raylet->enabled = true;
  }
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_try_acquire(ServerObject* self,
                                           PyObject* args) {
  PyObject* d;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &d)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::map<std::string, double> need;
  if (!dict_to_resmap(d, &need)) return nullptr;
  bool ok;
  {
    std::lock_guard<std::mutex> g(r->mu);
    ok = r->try_acquire_locked(need);
  }
  return PyBool_FromLong(ok);
}

static PyObject* Server_raylet_release(ServerObject* self, PyObject* args) {
  PyObject* d;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &d)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::map<std::string, double> res;
  if (!dict_to_resmap(d, &res)) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->release_locked(res);
  }
  raylet_wake(self->core);  // freed capacity may unblock queued dispatch
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_force_acquire(ServerObject* self,
                                             PyObject* args) {
  // Unconditional deduct (may go negative): the unblock path accepts
  // transient oversubscription, matching the Python scheduler's rule.
  PyObject* d;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &d)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::map<std::string, double> res;
  if (!dict_to_resmap(d, &res)) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    for (const auto& [k, v] : res) r->avail[k] -= v;
  }
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_snapshot(ServerObject* self, PyObject*) {
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::map<std::string, double> copy;
  {
    std::lock_guard<std::mutex> g(r->mu);
    copy = r->avail;
  }
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  for (const auto& [k, v] : copy) {
    PyObject* val = PyFloat_FromDouble(v);
    if (!val || PyDict_SetItemString(d, k.c_str(), val) < 0) {
      Py_XDECREF(val);
      Py_DECREF(d);
      return nullptr;
    }
    Py_DECREF(val);
  }
  return d;
}

static PyObject* Server_memory_monitor_enable(ServerObject* self,
                                              PyObject* args) {
  // (threshold_fraction, interval_s, cooldown_s); threshold 0 disables.
  double threshold, interval, cooldown;
  if (!PyArg_ParseTuple(args, "ddd", &threshold, &interval, &cooldown))
    return nullptr;
  ServerCore* c = self->core;
  c->mm_threshold.store(threshold);
  c->mm_interval_s.store(interval > 0 ? interval : 1.0);
  c->mm_cooldown_s.store(cooldown >= 0 ? cooldown : 5.0);
  c->mm_next_check.store(0);
  raylet_wake(c);  // re-enter epoll with the capped timeout
  Py_RETURN_NONE;
}

static PyObject* Server_memory_monitor_ack(ServerObject* self,
                                           PyObject* args) {
  // Python reports the crossing's outcome.  No victim killed -> clear
  // the cooldown so the next interval can fire again: a no-op crossing
  // must not suppress pressure response while memory keeps climbing
  // (Python's check_once only cooled down after a SUCCESSFUL kill).
  int killed;
  if (!PyArg_ParseTuple(args, "p", &killed)) return nullptr;
  if (!killed) self->core->mm_last_fire.store(0);
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_debug(ServerObject* self, PyObject*) {
  // Introspection for tests/diagnosis: (idle ids, bound ids,
  // {conn: [task ids]} inflight).  Not a hot path.
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::vector<uint64_t> idle, bound;
  std::vector<std::pair<uint64_t, std::vector<std::string>>> inflight;
  {
    std::lock_guard<std::mutex> g(r->mu);
    idle.assign(r->idle.begin(), r->idle.end());
    bound.assign(r->bound.begin(), r->bound.end());
    for (auto& [cid, tasks] : r->inflight) {
      std::vector<std::string> tids;
      for (auto& [tid, _] : tasks) tids.push_back(tid);
      if (!tids.empty()) inflight.emplace_back(cid, std::move(tids));
    }
  }
  PyObject* d = PyDict_New();
  PyObject* li = PyList_New(0);
  for (auto v : idle) {
    PyObject* o = PyLong_FromUnsignedLongLong(v);
    PyList_Append(li, o);
    Py_DECREF(o);
  }
  PyDict_SetItemString(d, "idle", li);
  Py_DECREF(li);
  PyObject* lb = PyList_New(0);
  for (auto v : bound) {
    PyObject* o = PyLong_FromUnsignedLongLong(v);
    PyList_Append(lb, o);
    Py_DECREF(o);
  }
  PyDict_SetItemString(d, "bound", lb);
  Py_DECREF(lb);
  PyObject* linf = PyDict_New();
  for (auto& [cid, tids] : inflight) {
    PyObject* key = PyLong_FromUnsignedLongLong(cid);
    PyObject* tl = PyList_New(0);
    for (auto& t : tids) {
      PyObject* b = PyBytes_FromStringAndSize(t.data(),
                                              Py_ssize_t(t.size()));
      PyList_Append(tl, b);
      Py_DECREF(b);
    }
    PyDict_SetItem(linf, key, tl);
    Py_DECREF(key);
    Py_DECREF(tl);
  }
  PyDict_SetItemString(d, "inflight", linf);
  Py_DECREF(linf);
  return d;
}

static PyObject* Server_raylet_bind_worker(ServerObject* self,
                                           PyObject* args) {
  unsigned long long conn_id;
  if (!PyArg_ParseTuple(args, "K", &conn_id)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->bound.insert(conn_id);
    if (!r->idle_set.count(conn_id)) {
      r->idle.push_back(conn_id);
      r->idle_set.insert(conn_id);
    }
  }
  raylet_wake(self->core);
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_acquire_worker(ServerObject* self,
                                              PyObject*) {
  // Python-lane lease: pop an idle worker for a non-plain task (PG /
  // actor / custom-resource); the caller dispatches + releases it.
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  uint64_t id = 0;
  {
    std::lock_guard<std::mutex> g(r->mu);
    if (r->idle.empty()) Py_RETURN_NONE;
    id = r->idle.front();
    r->idle.pop_front();
    r->idle_set.erase(id);
  }
  return PyLong_FromUnsignedLongLong(id);
}

static PyObject* Server_raylet_release_worker(ServerObject* self,
                                              PyObject* args) {
  unsigned long long conn_id;
  if (!PyArg_ParseTuple(args, "K", &conn_id)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    if (r->bound.count(conn_id) && !r->idle_set.count(conn_id)) {
      r->idle.push_back(conn_id);
      r->idle_set.insert(conn_id);
    }
  }
  raylet_wake(self->core);
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_submit(ServerObject* self, PyObject* args) {
  // In-process submit (the driver on the head node): same lane as a 0x10
  // frame, without a socket hop.
  Py_buffer tid, payload;
  double cpu;
  const char* name;
  Py_ssize_t name_len;
  if (!PyArg_ParseTuple(args, "y*ds#y*", &tid, &cpu, &name, &name_len,
                        &payload))
    return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) {
    PyBuffer_Release(&tid);
    PyBuffer_Release(&payload);
    return nullptr;
  }
  std::string t((const char*)tid.buf, size_t(tid.len));
  std::string assign;
  assign.reserve(2 + t.size() + size_t(payload.len));
  assign.push_back(char(0x11));
  assign.push_back(char(uint8_t(t.size())));
  assign += t;
  assign.append((const char*)payload.buf, size_t(payload.len));
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->n_submitted++;
    r->push_event_locked(t, std::string(name, size_t(name_len)), 0);
    auto tot = r->total.find("CPU");
    if (cpu > (tot == r->total.end() ? 0.0 : tot->second)) {
      r->infeasible.push_back(std::move(assign));
    } else {
      r->pending.push_back({std::move(t),
                            std::string(name, size_t(name_len)), cpu,
                            std::move(assign)});
    }
  }
  PyBuffer_Release(&tid);
  PyBuffer_Release(&payload);
  raylet_wake(self->core);
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_native_inflight(ServerObject* self,
                                               PyObject*) {
  // {conn_id: in-flight native task count} — the OOM killer's victim
  // policy needs to see native-lane busyness (Python's WorkerState
  // in_flight only tracks the policy lane).
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  std::vector<std::pair<uint64_t, size_t>> rows;
  {
    std::lock_guard<std::mutex> g(r->mu);
    for (const auto& [w, m] : r->inflight)
      if (!m.empty()) rows.emplace_back(w, m.size());
  }
  for (const auto& [w, n] : rows) {
    PyObject* key = PyLong_FromUnsignedLongLong(w);
    PyObject* val = PyLong_FromSize_t(n);
    if (!key || !val || PyDict_SetItem(d, key, val) < 0) {
      Py_XDECREF(key);
      Py_XDECREF(val);
      Py_DECREF(d);
      return nullptr;
    }
    Py_DECREF(key);
    Py_DECREF(val);
  }
  return d;
}

static PyObject* Server_raylet_drain_events(ServerObject* self, PyObject*) {
  // [(task_id, name, state, ts), ...]; state 0=PENDING 1=RUNNING
  // 2=FINISHED 3=FAILED.  Python merges into its task-event table on
  // state-API queries.
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::deque<RayletCore::Event> out;
  {
    std::lock_guard<std::mutex> g(r->mu);
    out.swap(r->events);
  }
  PyObject* list = PyList_New(Py_ssize_t(out.size()));
  if (!list) return nullptr;
  Py_ssize_t i = 0;
  for (const auto& e : out) {
    // lenient name decode: a truncated/garbled UTF-8 name must not
    // poison the whole drained batch
    PyObject* name = PyUnicode_DecodeUTF8(
        e.name.data(), Py_ssize_t(e.name.size()), "replace");
    if (!name) {
      Py_DECREF(list);
      return nullptr;
    }
    PyObject* item = Py_BuildValue(
        "(y#Nid)", e.tid.data(), Py_ssize_t(e.tid.size()), name,
        int(e.state), e.ts);  // N: item owns `name`
    if (!item) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, i++, item);
  }
  return list;
}

static PyObject* Server_raylet_set_accept(ServerObject* self,
                                          PyObject* args) {
  // false: 0x10 SUBMITs fall through to Python (multi-node spillback
  // policy applies); DONE/SEALED stay native either way.
  int accept;
  if (!PyArg_ParseTuple(args, "p", &accept)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->accept_submits = accept != 0;
  }
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_block_worker(ServerObject* self,
                                            PyObject* args) {
  // The worker's running native task entered a blocking get: release its
  // CPU back to the ledger so dependency chains cannot deadlock the node
  // (reference: NotifyDirectCallTaskBlocked, node_manager.cc).  When the
  // notification names the blocking task, only that task's CPU is
  // released — a stale "blocked" arriving after C++ already completed the
  // task and dispatched a new one to the same conn must not credit the
  // NEW task's CPU.
  unsigned long long conn_id;
  const char* tid_buf = nullptr;
  Py_ssize_t tid_len = 0;
  if (!PyArg_ParseTuple(args, "K|y#", &conn_id, &tid_buf, &tid_len))
    return nullptr;
  std::string want(tid_buf ? tid_buf : "", (size_t)tid_len);
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    auto inf = r->inflight.find(conn_id);
    if (inf != r->inflight.end()) {
      for (auto& [tid, fl] : inf->second) {
        if (!want.empty() && tid != want) continue;
        if (!fl.blocked) {
          fl.blocked = true;
          r->avail["CPU"] += fl.cpu;
        }
      }
    }
  }
  raylet_wake(self->core);
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_unblock_worker(ServerObject* self,
                                              PyObject* args) {
  // Unconditional re-deduct (transient oversubscription accepted).
  // Matches the task-scoped release in raylet_block_worker.
  unsigned long long conn_id;
  const char* tid_buf = nullptr;
  Py_ssize_t tid_len = 0;
  if (!PyArg_ParseTuple(args, "K|y#", &conn_id, &tid_buf, &tid_len))
    return nullptr;
  std::string want(tid_buf ? tid_buf : "", (size_t)tid_len);
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  {
    std::lock_guard<std::mutex> g(r->mu);
    auto inf = r->inflight.find(conn_id);
    if (inf != r->inflight.end()) {
      for (auto& [tid, fl] : inf->second) {
        if (!want.empty() && tid != want) continue;
        if (fl.blocked) {
          fl.blocked = false;
          r->avail["CPU"] -= fl.cpu;
        }
      }
    }
  }
  Py_RETURN_NONE;
}

static PyObject* Server_raylet_reap_orphans(ServerObject* self,
                                            PyObject* args) {
  // Assign frames ([0x11][tl][tid][payload]) of tasks whose worker died
  // before DONE; Python unpickles the payload and runs its retry policy.
  // Keyed by the dead connection so one worker's death provenance (e.g.
  // an OOM kill) is never applied to another's tasks.
  unsigned long long conn_id;
  if (!PyArg_ParseTuple(args, "K", &conn_id)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::vector<std::string> out;
  {
    std::lock_guard<std::mutex> g(r->mu);
    auto it = r->orphans.find(conn_id);
    if (it != r->orphans.end()) {
      out = std::move(it->second);
      r->orphans.erase(it);
    }
  }
  PyObject* list = PyList_New(Py_ssize_t(out.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < out.size(); ++i) {
    PyObject* b =
        PyBytes_FromStringAndSize(out[i].data(), Py_ssize_t(out[i].size()));
    if (!b) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, Py_ssize_t(i), b);
  }
  return list;
}

static PyObject* Server_raylet_drain_infeasible(ServerObject* self,
                                                PyObject*) {
  // Assign frames of tasks whose demand exceeds node totals — Python
  // fails them with a precise error instead of queueing forever.
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::vector<std::string> out;
  {
    std::lock_guard<std::mutex> g(r->mu);
    out.swap(r->infeasible);
    r->infeasible_marker = false;
  }
  PyObject* list = PyList_New(Py_ssize_t(out.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < out.size(); ++i) {
    PyObject* b =
        PyBytes_FromStringAndSize(out[i].data(), Py_ssize_t(out[i].size()));
    if (!b) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, Py_ssize_t(i), b);
  }
  return list;
}

static PyObject* Server_raylet_steal_pending(ServerObject* self,
                                             PyObject* args) {
  // Move queued tasks back to Python (assign frames).  With no argument
  // the whole queue drains (lane shutdown / drain).  With max_n, up to
  // max_n tasks are stolen from the BACK of the queue — the newest
  // submissions, which are the ones a saturated node's balancer spills
  // to peers while the oldest keep their local dispatch position.
  long long max_n = -1;
  if (!PyArg_ParseTuple(args, "|L", &max_n)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::deque<RayletCore::Pending> out;
  {
    std::lock_guard<std::mutex> g(r->mu);
    if (max_n < 0 || size_t(max_n) >= r->pending.size()) {
      out.swap(r->pending);
    } else {
      for (long long i = 0; i < max_n; ++i) {
        out.push_front(std::move(r->pending.back()));
        r->pending.pop_back();
      }
    }
  }
  PyObject* list = PyList_New(Py_ssize_t(out.size()));
  if (!list) return nullptr;
  Py_ssize_t i = 0;
  for (auto& p : out) {
    PyObject* b = PyBytes_FromStringAndSize(p.assign.data(),
                                            Py_ssize_t(p.assign.size()));
    if (!b) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, i++, b);
  }
  return list;
}

static PyObject* Server_raylet_cancel(ServerObject* self, PyObject* args) {
  // cancel(tid) -> (state, conn_id, frame|None)
  //   state 0: unknown here; 1: removed from the queue (frame returned
  //   so Python can fail the spec's return objects); 2: running on
  //   conn_id (force-cancel kills that worker from Python).
  Py_buffer tid;
  if (!PyArg_ParseTuple(args, "y*", &tid)) return nullptr;
  RayletCore* r = raylet_of(self);
  if (!r) {
    PyBuffer_Release(&tid);
    return nullptr;
  }
  std::string t((const char*)tid.buf, size_t(tid.len));
  PyBuffer_Release(&tid);
  int state = 0;
  uint64_t conn = 0;
  std::string frame;
  {
    std::lock_guard<std::mutex> g(r->mu);
    for (auto it = r->pending.begin(); it != r->pending.end(); ++it) {
      if (it->tid == t) {
        frame = std::move(it->assign);
        r->pending.erase(it);
        state = 1;
        break;
      }
    }
    if (state == 0) {
      for (auto& [w, m] : r->inflight) {
        if (m.count(t)) {
          state = 2;
          conn = w;
          break;
        }
      }
    }
  }
  if (state == 1)
    return Py_BuildValue("(iKy#)", state, (unsigned long long)conn,
                         frame.data(), Py_ssize_t(frame.size()));
  return Py_BuildValue("(iKO)", state, (unsigned long long)conn, Py_None);
}

static PyObject* Server_raylet_drain_sealed(ServerObject* self, PyObject*) {
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  std::vector<std::string> out;
  {
    std::lock_guard<std::mutex> g(r->mu);
    out.swap(r->sealed);
    r->sealed_marker = false;
  }
  PyObject* list = PyList_New(Py_ssize_t(out.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < out.size(); ++i) {
    PyObject* b =
        PyBytes_FromStringAndSize(out[i].data(), Py_ssize_t(out[i].size()));
    if (!b) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, Py_ssize_t(i), b);
  }
  return list;
}

static PyObject* Server_raylet_stats(ServerObject* self, PyObject*) {
  RayletCore* r = raylet_of(self);
  if (!r) return nullptr;
  uint64_t pending, idle, inflight = 0, dispatched, done, submitted;
  double cpu;
  {
    std::lock_guard<std::mutex> g(r->mu);
    pending = r->pending.size();
    idle = r->idle.size();
    for (auto& [w, m] : r->inflight) inflight += m.size();
    dispatched = r->n_dispatched;
    done = r->n_done;
    submitted = r->n_submitted;
    auto it = r->avail.find("CPU");
    cpu = it == r->avail.end() ? 0.0 : it->second;
  }
  return Py_BuildValue(
      "{s:K,s:K,s:K,s:K,s:K,s:K,s:d}", "pending",
      (unsigned long long)pending, "idle", (unsigned long long)idle,
      "inflight", (unsigned long long)inflight, "dispatched",
      (unsigned long long)dispatched, "done", (unsigned long long)done,
      "submitted", (unsigned long long)submitted, "cpu_available", cpu);
}

// next(timeout_ms) -> (conn_id, frame) | None; raises ConnectionError
// after close().  Runs accept/read/parse inline on the calling thread.
static PyObject* Server_next(ServerObject* self, PyObject* args) {
  long timeout_ms;
  if (!PyArg_ParseTuple(args, "l", &timeout_ms)) return nullptr;
  ServerCore* c = self->core;
  if (c->closed) {
    PyErr_SetString(PyExc_ConnectionError, "server closed");
    return nullptr;
  }
  uint64_t conn_id = 0;
  std::string frame;
  bool got = false;
  // absolute caller deadline so monitor ticks never extend a finite wait
  double deadline = timeout_ms >= 0
                        ? ServerCore::mono_now() + timeout_ms / 1000.0
                        : -1.0;
  Py_BEGIN_ALLOW_THREADS
  for (;;) {
    c->flush_replies();  // pool-thread replies drain on THIS thread
    c->raylet_pump();    // dispatch queued plain tasks to idle workers
    c->memory_check();   // native memory monitor (emits 0x7e markers)
    for (uint64_t did : c->pending_drops) c->drop(did);
    c->pending_drops.clear();
    if (!c->ready.empty()) {
      conn_id = c->ready.front().first;
      frame = std::move(c->ready.front().second);
      c->ready.pop_front();
      got = true;
      break;
    }
    struct epoll_event evs[32];
    // the memory monitor needs periodic wakeups even when the caller
    // waits forever: cap the block at the sampling interval and treat
    // that expiry as a tick, not a caller timeout
    long eff_ms;
    if (deadline < 0) {
      eff_ms = -1;
    } else {
      double rem = (deadline - ServerCore::mono_now()) * 1000.0;
      eff_ms = rem > 0 ? long(rem) + 1 : 0;
    }
    bool tick_only = false;
    if (c->mm_threshold.load() > 0) {
      long mm_ms = long(c->mm_interval_s.load() * 1000);
      if (mm_ms < 1) mm_ms = 1;
      if (eff_ms < 0 || eff_ms > mm_ms) {
        eff_ms = mm_ms;
        tick_only = true;
      }
    }
    int n = epoll_wait(c->epfd, evs, 32, int(eff_ms));
    if (n == 0) {
      if (tick_only) continue;  // monitor tick, caller budget remains
      break;  // caller timeout
    }
    if (n < 0) {
      if (errno == EINTR) continue;
      c->closed = true;
      break;
    }
    for (int i = 0; i < n; ++i) {
      if (evs[i].data.u64 == 0) {
        if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
          c->closed = true;
        } else {
          c->accept_ready();
        }
      } else if (evs[i].data.u64 == 1) {
        uint64_t junk;
        while (::read(c->wake_fd, &junk, 8) == 8) {
        }
        // replies flushed at loop top
      } else {
        // read even on HUP: there may be buffered final frames
        uint64_t id = evs[i].data.u64;
        if (!c->read_conn(id)) c->drop(id);
      }
    }
    if (c->closed) break;
  }
  Py_END_ALLOW_THREADS
  if (got)
    return Py_BuildValue("(Ky#)", (unsigned long long)conn_id, frame.data(),
                         Py_ssize_t(frame.size()));
  if (c->closed) {
    PyErr_SetString(PyExc_ConnectionError, "server closed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyObject* Server_reply(ServerObject* self, PyObject* args) {
  // Callable from ANY thread (the exec thread or max_concurrency pool
  // callbacks): only enqueues — the exec thread owns the sockets.
  unsigned long long conn_id;
  Py_buffer frame;
  if (!PyArg_ParseTuple(args, "Ky*", &conn_id, &frame)) return nullptr;
  ServerCore* c = self->core;
  {
    std::lock_guard<std::mutex> g(c->out_mu);
    c->out_queue.emplace_back(
        conn_id, std::string((const char*)frame.buf, size_t(frame.len)));
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, 8);  // wake the epoll loop
  PyBuffer_Release(&frame);
  Py_RETURN_TRUE;
}

static PyObject* Server_close(ServerObject* self, PyObject*) {
  ServerCore* c = self->core;
  c->closed = true;
  ::shutdown(c->listen_fd, SHUT_RDWR);
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, 8);  // wake a parked next()
  Py_RETURN_NONE;
}

static PyObject* Server_kick(ServerObject* self, PyObject* args) {
  // Close a connection from any thread (processed by the exec thread).
  unsigned long long conn_id;
  if (!PyArg_ParseTuple(args, "K", &conn_id)) return nullptr;
  ServerCore* c = self->core;
  {
    std::lock_guard<std::mutex> g(c->out_mu);
    c->out_queue.emplace_back(conn_id, std::string());
  }
  uint64_t one = 1;
  (void)!::write(c->wake_fd, &one, 8);
  Py_RETURN_NONE;
}

static PyMethodDef Server_methods[] = {
    {"next", (PyCFunction)Server_next, METH_VARARGS,
     "next(timeout_ms) -> (conn_id, frame) | None; an EMPTY frame means "
     "the connection closed; raises ConnectionError after close()"},
    {"reply", (PyCFunction)Server_reply, METH_VARARGS,
     "reply(conn_id, frame) -> bool (enqueued; exec thread flushes)"},
    {"kick", (PyCFunction)Server_kick, METH_VARARGS,
     "kick(conn_id): close a connection"},
    {"close", (PyCFunction)Server_close, METH_NOARGS, ""},
    {"raylet_enable", (PyCFunction)Server_raylet_enable, METH_VARARGS,
     "raylet_enable(resources): turn on native plain-task dispatch; the "
     "resource dict becomes the node ledger (single owner)"},
    {"raylet_try_acquire", (PyCFunction)Server_raylet_try_acquire,
     METH_VARARGS, "raylet_try_acquire({name: amount}) -> bool (atomic)"},
    {"raylet_release", (PyCFunction)Server_raylet_release, METH_VARARGS,
     "raylet_release({name: amount})"},
    {"raylet_force_acquire", (PyCFunction)Server_raylet_force_acquire,
     METH_VARARGS,
     "raylet_force_acquire({name: amount}): unconditional deduct"},
    {"raylet_snapshot", (PyCFunction)Server_raylet_snapshot, METH_NOARGS,
     "raylet_snapshot() -> {name: available}"},
    {"raylet_bind_worker", (PyCFunction)Server_raylet_bind_worker,
     METH_VARARGS, "raylet_bind_worker(conn_id): register + mark idle"},
    {"raylet_debug", (PyCFunction)Server_raylet_debug, METH_NOARGS,
     "raylet_debug() -> {idle, bound, inflight} introspection"},
    {"memory_monitor_enable", (PyCFunction)Server_memory_monitor_enable,
     METH_VARARGS,
     "memory_monitor_enable(threshold, interval_s, cooldown_s): native "
     "usage sampling in the epoll loop; 0x7e markers wake Python"},
    {"memory_monitor_ack", (PyCFunction)Server_memory_monitor_ack,
     METH_VARARGS,
     "memory_monitor_ack(killed): no-kill crossings clear the cooldown"},
    {"raylet_acquire_worker", (PyCFunction)Server_raylet_acquire_worker,
     METH_NOARGS, "raylet_acquire_worker() -> conn_id | None"},
    {"raylet_release_worker", (PyCFunction)Server_raylet_release_worker,
     METH_VARARGS, "raylet_release_worker(conn_id): return to idle pool"},
    {"raylet_submit", (PyCFunction)Server_raylet_submit, METH_VARARGS,
     "raylet_submit(task_id, cpu, payload): enqueue a plain task"},
    {"raylet_set_accept", (PyCFunction)Server_raylet_set_accept,
     METH_VARARGS,
     "raylet_set_accept(bool): route 0x10 SUBMITs natively or to Python"},
    {"raylet_block_worker", (PyCFunction)Server_raylet_block_worker,
     METH_VARARGS,
     "raylet_block_worker(conn_id[, task_id]): release the blocking "
     "task's CPU (all of the conn's tasks when task_id is omitted)"},
    {"raylet_unblock_worker", (PyCFunction)Server_raylet_unblock_worker,
     METH_VARARGS,
     "raylet_unblock_worker(conn_id[, task_id]): re-deduct the matching "
     "task's CPU"},
    {"raylet_reap_orphans", (PyCFunction)Server_raylet_reap_orphans,
     METH_VARARGS,
     "raylet_reap_orphans(conn_id) -> [assign frames of that dead "
     "worker's tasks]"},
    {"raylet_drain_infeasible",
     (PyCFunction)Server_raylet_drain_infeasible, METH_NOARGS,
     "raylet_drain_infeasible() -> [assign frames exceeding node totals]"},
    {"raylet_cancel", (PyCFunction)Server_raylet_cancel, METH_VARARGS,
     "raylet_cancel(task_id) -> (state, conn_id, frame|None)"},
    {"raylet_steal_pending", (PyCFunction)Server_raylet_steal_pending,
     METH_VARARGS,
     "raylet_steal_pending([max_n]) -> [assign frames]; no arg drains "
     "all, max_n steals the newest from the queue back"},
    {"raylet_drain_sealed", (PyCFunction)Server_raylet_drain_sealed,
     METH_NOARGS, "raylet_drain_sealed() -> [oid, ...]"},
    {"raylet_drain_events", (PyCFunction)Server_raylet_drain_events,
     METH_NOARGS,
     "raylet_drain_events() -> [(task_id, name, state, ts), ...]"},
    {"raylet_native_inflight",
     (PyCFunction)Server_raylet_native_inflight, METH_NOARGS,
     "raylet_native_inflight() -> {conn_id: task count}"},
    {"raylet_stats", (PyCFunction)Server_raylet_stats, METH_NOARGS,
     "raylet_stats() -> dispatch counters + ledger CPU"},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject ServerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------- StoreConn (native shm-store client op layer) ----------
//
// One pooled connection to the shm_store daemon (protocol of
// shm_store.cc: fixed 37-byte request / 17-byte response, with OP_PUT
// payload streaming and OP_GET_INLINE payload returns).  The Python
// StoreClient keeps the pool + mmap; each checked-out socket is wrapped
// in a StoreConn so the per-op pack/send/recv runs in C with the GIL
// released — on the multi-client put path the Python per-op overhead is
// comparable to the daemon round trip itself.

struct StoreConnCore {
  int fd = -1;
  bool dead = false;
};

typedef struct {
  PyObject_HEAD
  StoreConnCore* core;
} StoreConnObject;

static PyObject* StoreConn_new(PyTypeObject* type, PyObject* args,
                               PyObject* kwds) {
  int fd;
  if (!PyArg_ParseTuple(args, "i", &fd)) return nullptr;
  StoreConnObject* self = (StoreConnObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->core = new StoreConnCore();
  self->core->fd = fd;
  return (PyObject*)self;
}

static void StoreConn_dealloc(StoreConnObject* self) {
  if (self->core) {
    // fd ownership stays with the Python socket object that dialed it
    delete self->core;
    self->core = nullptr;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static bool recv_full(int fd, char* p, size_t n) {
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return false;
    }
    p += k;
    n -= size_t(k);
  }
  return true;
}

constexpr size_t kStoreIdLen = 20;
constexpr size_t kStoreReqLen = 1 + kStoreIdLen + 8 + 8;
constexpr size_t kStoreRespLen = 1 + 8 + 8;

static void pack_store_req(char* req, uint8_t op, const char* oid,
                           uint64_t a0, uint64_t a1) {
  req[0] = char(op);
  memcpy(req + 1, oid, kStoreIdLen);
  memcpy(req + 1 + kStoreIdLen, &a0, 8);
  memcpy(req + 1 + kStoreIdLen + 8, &a1, 8);
}

// call(op, oid, a0, a1) -> (status, r0, r1)
static PyObject* StoreConn_call(StoreConnObject* self, PyObject* args) {
  int op;
  Py_buffer oid;
  unsigned long long a0, a1;
  if (!PyArg_ParseTuple(args, "iy*KK", &op, &oid, &a0, &a1)) return nullptr;
  if (oid.len != Py_ssize_t(kStoreIdLen)) {
    PyBuffer_Release(&oid);
    PyErr_SetString(PyExc_ValueError, "oid must be 20 bytes");
    return nullptr;
  }
  StoreConnCore* c = self->core;
  char req[kStoreReqLen], resp[kStoreRespLen];
  pack_store_req(req, uint8_t(op), (const char*)oid.buf, a0, a1);
  bool ok = false;
  Py_BEGIN_ALLOW_THREADS
  ok = !c->dead && send_all(c->fd, req, kStoreReqLen) &&
       recv_full(c->fd, resp, kStoreRespLen);
  if (!ok) c->dead = true;
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&oid);
  if (!ok) {
    PyErr_SetString(PyExc_ConnectionError, "object store connection closed");
    return nullptr;
  }
  uint64_t r0, r1;
  memcpy(&r0, resp + 1, 8);
  memcpy(&r1, resp + 1 + 8, 8);
  return Py_BuildValue("(iKK)", int(uint8_t(resp[0])),
                       (unsigned long long)r0, (unsigned long long)r1);
}

// put(oid, payload) -> status  (request + payload in one send when small)
static PyObject* StoreConn_put(StoreConnObject* self, PyObject* args) {
  Py_buffer oid, payload;
  if (!PyArg_ParseTuple(args, "y*y*", &oid, &payload)) return nullptr;
  if (oid.len != Py_ssize_t(kStoreIdLen)) {
    PyBuffer_Release(&oid);
    PyBuffer_Release(&payload);
    PyErr_SetString(PyExc_ValueError, "oid must be 20 bytes");
    return nullptr;
  }
  StoreConnCore* c = self->core;
  bool ok = false;
  char resp[kStoreRespLen];
  Py_BEGIN_ALLOW_THREADS
  if (!c->dead) {
    if (size_t(payload.len) <= 65536 - kStoreReqLen) {
      char buf[65536];
      pack_store_req(buf, 9 /*OP_PUT*/, (const char*)oid.buf,
                     uint64_t(payload.len), 0);
      memcpy(buf + kStoreReqLen, payload.buf, size_t(payload.len));
      ok = send_all(c->fd, buf, kStoreReqLen + size_t(payload.len));
    } else {
      char req[kStoreReqLen];
      pack_store_req(req, 9, (const char*)oid.buf, uint64_t(payload.len), 0);
      ok = send_all(c->fd, req, kStoreReqLen) &&
           send_all(c->fd, (const char*)payload.buf, size_t(payload.len));
    }
    ok = ok && recv_full(c->fd, resp, kStoreRespLen);
    if (!ok) c->dead = true;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&oid);
  PyBuffer_Release(&payload);
  if (!ok) {
    PyErr_SetString(PyExc_ConnectionError, "object store connection closed");
    return nullptr;
  }
  return PyLong_FromLong(long(uint8_t(resp[0])));
}

// get_inline(oid, timeout_ms, cap) -> (status, r0, r1, payload|None)
static PyObject* StoreConn_get_inline(StoreConnObject* self, PyObject* args) {
  Py_buffer oid;
  unsigned long long timeout_ms, cap;
  if (!PyArg_ParseTuple(args, "y*KK", &oid, &timeout_ms, &cap))
    return nullptr;
  if (oid.len != Py_ssize_t(kStoreIdLen)) {
    PyBuffer_Release(&oid);
    PyErr_SetString(PyExc_ValueError, "oid must be 20 bytes");
    return nullptr;
  }
  StoreConnCore* c = self->core;
  char req[kStoreReqLen], resp[kStoreRespLen];
  pack_store_req(req, 10 /*OP_GET_INLINE*/, (const char*)oid.buf,
                 timeout_ms, cap);
  bool ok = false;
  Py_BEGIN_ALLOW_THREADS
  ok = !c->dead && send_all(c->fd, req, kStoreReqLen) &&
       recv_full(c->fd, resp, kStoreRespLen);
  if (!ok) c->dead = true;
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&oid);
  if (!ok) {
    PyErr_SetString(PyExc_ConnectionError, "object store connection closed");
    return nullptr;
  }
  int status = int(uint8_t(resp[0]));
  uint64_t r0, r1;
  memcpy(&r0, resp + 1, 8);
  memcpy(&r1, resp + 1 + 8, 8);
  if (status == 0 /*ST_OK*/ && r0 == 1) {
    // inline payload follows: read straight into a fresh bytes object
    PyObject* data = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(r1));
    if (!data) return nullptr;
    bool ok2 = false;
    char* dst = PyBytes_AS_STRING(data);
    Py_BEGIN_ALLOW_THREADS
    ok2 = recv_full(c->fd, dst, size_t(r1));
    if (!ok2) c->dead = true;
    Py_END_ALLOW_THREADS
    if (!ok2) {
      Py_DECREF(data);
      PyErr_SetString(PyExc_ConnectionError,
                      "object store connection closed");
      return nullptr;
    }
    PyObject* out = Py_BuildValue("(iKKN)", status, (unsigned long long)r0,
                                  (unsigned long long)r1, data);
    return out;
  }
  return Py_BuildValue("(iKKO)", status, (unsigned long long)r0,
                       (unsigned long long)r1, Py_None);
}

static PyObject* StoreConn_is_dead(StoreConnObject* self, PyObject*) {
  return PyBool_FromLong(self->core->dead);
}

static PyMethodDef StoreConn_methods[] = {
    {"call", (PyCFunction)StoreConn_call, METH_VARARGS,
     "call(op, oid, a0, a1) -> (status, r0, r1)"},
    {"put", (PyCFunction)StoreConn_put, METH_VARARGS,
     "put(oid, payload) -> status (create+copy+seal, one round trip)"},
    {"get_inline", (PyCFunction)StoreConn_get_inline, METH_VARARGS,
     "get_inline(oid, timeout_ms, cap) -> (status, r0, r1, bytes|None)"},
    {"is_dead", (PyCFunction)StoreConn_is_dead, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject StoreConnType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------- module ----------

static PyModuleDef rtpu_core_module = {
    PyModuleDef_HEAD_INIT, "_rtpu_core",
    "Native transport core for direct actor calls (threadless)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__rtpu_core(void) {
  ChannelType.tp_name = "_rtpu_core.Channel";
  ChannelType.tp_basicsize = sizeof(ChannelObject);
  ChannelType.tp_flags = Py_TPFLAGS_DEFAULT;
  ChannelType.tp_new = Channel_new;
  ChannelType.tp_dealloc = (destructor)Channel_dealloc;
  ChannelType.tp_methods = Channel_methods;
  ChannelType.tp_doc = "Caller-side direct channel (C++ framed I/O)";
  if (PyType_Ready(&ChannelType) < 0) return nullptr;

  ServerType.tp_name = "_rtpu_core.Server";
  ServerType.tp_basicsize = sizeof(ServerObject);
  ServerType.tp_flags = Py_TPFLAGS_DEFAULT;
  ServerType.tp_new = Server_new;
  ServerType.tp_dealloc = (destructor)Server_dealloc;
  ServerType.tp_methods = Server_methods;
  ServerType.tp_doc = "Callee-side epoll frame server (threadless)";
  if (PyType_Ready(&ServerType) < 0) return nullptr;

  StoreConnType.tp_name = "_rtpu_core.StoreConn";
  StoreConnType.tp_basicsize = sizeof(StoreConnObject);
  StoreConnType.tp_flags = Py_TPFLAGS_DEFAULT;
  StoreConnType.tp_new = StoreConn_new;
  StoreConnType.tp_dealloc = (destructor)StoreConn_dealloc;
  StoreConnType.tp_methods = StoreConn_methods;
  StoreConnType.tp_doc = "Native shm-store client op layer (GIL-free I/O)";
  if (PyType_Ready(&StoreConnType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&rtpu_core_module);
  if (!m) return nullptr;
  Py_INCREF(&ChannelType);
  PyModule_AddObject(m, "Channel", (PyObject*)&ChannelType);
  Py_INCREF(&ServerType);
  PyModule_AddObject(m, "Server", (PyObject*)&ServerType);
  Py_INCREF(&StoreConnType);
  PyModule_AddObject(m, "StoreConn", (PyObject*)&StoreConnType);
  return m;
}
