// Native GCS server daemon.
//
// Counterpart of the reference's C++ GCS (Ray's src/ray/gcs/
// gcs_server/gcs_server.cc): the cluster control plane — actor registry with
// lifecycle FSM + named-actor index, node table with liveness, per-node load
// view, internal KV, placement-group table, object location directory, and
// (net new vs the round-2 Python GCS) a pubsub event log with long-poll
// subscriptions (reference: src/ray/pubsub/publisher.h:300 +
// gcs_server/pubsub_handler.cc) so clients subscribe to actor/node/object/KV
// changes instead of sleep-polling.
//
// Speaks the frame protocol of _private/protocol.py (u32-LE length prefix)
// with wire-codec bodies (_private/wire.py / native/wire.h) — the Python
// GcsClient works unchanged against this daemon or the Python GcsServer.
//
// Design: one thread, one epoll loop (the reference pins GCS handlers to a
// single asio io_context for the same reason — lock-free tables,
// deterministic ordering).  Long-poll subscribers park their reply inside
// the loop; publishes and timeouts complete them.  Durable tables (actors,
// named actors, KV, placement groups) snapshot to --persist with a debounce,
// same file format as the Python Gcs (wire-encoded state dict), so a head
// restart can hand the tables between implementations in either direction.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <memory>
#include <deque>
#include <map>
#include <set>
#include <string>
#include <vector>

#include "wire.h"

using wire::Value;

static volatile sig_atomic_t g_stop = 0;
static void on_stop_signal(int) { g_stop = 1; }

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

static double mono_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

// ---------------------------------------------------------------------------
// Tables (mirror of _private/gcs.py Gcs)
// ---------------------------------------------------------------------------

static const char* kStateDead = "DEAD";
static const char* kStateRestarting = "RESTARTING";

struct Event {
  uint64_t seq;
  std::string channel;
  Value payload;
};

struct Waiter {  // a parked sub_poll long-poll
  int fd;
  std::vector<std::string> channels;
  uint64_t cursor;
  double deadline_mono;  // <=0: no timeout (shouldn't happen; client sends one)
};

// ---------------------------------------------------------------------------
// Pluggable persistence backends (reference:
// src/ray/gcs/store_client/redis_store_client.h — the GCS tables behind
// a swappable store client).  The snapshot blob is identical across
// backends (wire-encoded state dict), so a head can move between them.
// ---------------------------------------------------------------------------

struct PersistBackend {
  virtual ~PersistBackend() = default;
  virtual bool store(const std::string& blob) = 0;
  // false = backend unreachable (NOT the same as "no snapshot": a head
  // must never start empty and overwrite durable state just because the
  // store was briefly down); true with empty *blob = genuinely absent.
  virtual bool load(std::string* blob) = 0;
};

struct FilePersist : PersistBackend {
  std::string path;
  explicit FilePersist(std::string p) : path(std::move(p)) {}

  bool store(const std::string& blob) override {
    std::string tmp = path + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return false;
    bool ok = fwrite(blob.data(), 1, blob.size(), f) == blob.size();
    ok = fclose(f) == 0 && ok;
    if (ok) rename(tmp.c_str(), path.c_str());  // atomic swap
    return ok;
  }

  bool load(std::string* blob) override {
    blob->clear();
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return true;  // absent: a fresh cluster
    char buf[1 << 16];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) blob->append(buf, n);
    fclose(f);
    return true;
  }
};

// RESP (Redis Serialization Protocol) backend: SET/GET of the snapshot
// blob against any Redis-compatible server — the durable external
// control-plane store the reference uses for GCS fault tolerance.
// URL: redis://host:port[/key]
struct RedisPersist : PersistBackend {
  std::string host, key;
  int port;
  int fd = -1;

  RedisPersist(std::string h, int p, std::string k)
      : host(std::move(h)), key(std::move(k)), port(p) {}
  ~RedisPersist() override {
    if (fd >= 0) close(fd);
  }

  static constexpr int kIoTimeoutS = 5;

  bool ensure() {
    if (fd >= 0) return true;
    // hostname or numeric address (getaddrinfo covers both); timeouts
    // are set BEFORE connect — this runs on the single epoll control
    // thread, and a blackholed Redis must degrade, never hang the GCS
    struct addrinfo hints, *res = nullptr;
    memset(&hints, 0, sizeof hints);
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0)
      return false;
    for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
      fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      struct timeval tv = {kIoTimeoutS, 0};
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
      if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
      close(fd);
      fd = -1;
    }
    freeaddrinfo(res);
    return fd >= 0;
  }

  bool write_all(const std::string& data) {
    size_t off = 0;
    while (off < data.size()) {
      ssize_t n = send(fd, data.data() + off, data.size() - off,
                       MSG_NOSIGNAL);
      if (n <= 0) return false;
      off += size_t(n);
    }
    return true;
  }

  bool read_line(std::string* line) {
    line->clear();
    char c;
    while (true) {
      ssize_t n = recv(fd, &c, 1, 0);
      if (n <= 0) return false;
      if (c == '\r') {
        if (recv(fd, &c, 1, 0) <= 0) return false;  // consume \n
        return true;
      }
      line->push_back(c);
    }
  }

  bool read_exact(std::string* out, size_t n) {
    out->resize(n);
    size_t off = 0;
    while (off < n) {
      ssize_t r = recv(fd, out->data() + off, n - off, 0);
      if (r <= 0) return false;
      off += size_t(r);
    }
    char crlf[2];
    return recv(fd, crlf, 2, MSG_WAITALL) == 2;
  }

  static std::string cmd(const std::vector<std::string>& parts) {
    std::string out = "*" + std::to_string(parts.size()) + "\r\n";
    for (auto& p : parts)
      out += "$" + std::to_string(p.size()) + "\r\n" + p + "\r\n";
    return out;
  }

  bool store(const std::string& blob) override {
    for (int attempt = 0; attempt < 2; ++attempt) {
      if (!ensure()) return false;
      std::string reply;
      if (write_all(cmd({"SET", key, blob})) && read_line(&reply) &&
          !reply.empty() && reply[0] == '+')
        return true;
      close(fd);  // stale/broken conn: one reconnect attempt
      fd = -1;
    }
    return false;
  }

  bool load(std::string* blob) override {
    blob->clear();
    // a few connect attempts: a briefly-restarting Redis at head boot
    // must not be mistaken for "no snapshot"
    for (int attempt = 0; attempt < 5; ++attempt) {
      if (ensure()) break;
      struct timespec ts = {0, 300 * 1000 * 1000};
      nanosleep(&ts, nullptr);
    }
    if (fd < 0) return false;  // unreachable: caller decides (fatal)
    std::string reply;
    if (!write_all(cmd({"GET", key})) || !read_line(&reply) ||
        reply.empty() || reply[0] != '$') {
      close(fd);
      fd = -1;
      return false;
    }
    long long n = atoll(reply.c_str() + 1);
    if (n < 0) return true;  // $-1: key absent — fresh cluster
    if (!read_exact(blob, size_t(n))) {
      close(fd);
      fd = -1;
      blob->clear();
      return false;
    }
    return true;
  }
};

std::unique_ptr<PersistBackend> make_persist(const std::string& spec) {
  if (spec.empty()) return nullptr;
  if (spec.rfind("redis://", 0) == 0) {
    std::string rest = spec.substr(8);
    std::string key = "rtpu:gcs";
    auto slash = rest.find('/');
    if (slash != std::string::npos) {
      if (slash + 1 < rest.size()) key = rest.substr(slash + 1);
      rest = rest.substr(0, slash);
    }
    auto colon = rest.rfind(':');
    int port = 6379;
    std::string host = rest;
    if (colon != std::string::npos) {
      host = rest.substr(0, colon);
      port = atoi(rest.c_str() + colon + 1);
    }
    return std::make_unique<RedisPersist>(host, port, key);
  }
  return std::make_unique<FilePersist>(spec);
}

struct Gcs {
  std::map<std::string, Value> actors;       // actor_id -> STRUCT(1)
  std::map<std::string, std::string> named;  // name -> actor_id
  std::map<std::string, Value> nodes;        // node_id -> STRUCT(2)
  std::map<std::pair<std::string, std::string>, std::string> kv;
  std::map<std::string, std::set<std::string>> obj_locs;
  std::set<std::string> lost_objects;
  std::map<std::string, Value> pgs;  // pg_id -> DICT
  // First-class job / worker / task-event tables (reference:
  // gcs_service.proto JobInfoGcsService:68, WorkerInfoGcsService:363,
  // TaskInfoGcsService:860) — head-side Python holds NO copy, so jobs
  // and task events survive a head restart with the snapshot.
  std::map<std::string, Value> jobs;     // submission_id -> DICT
  std::map<std::string, Value> workers;  // worker_id -> DICT
  std::deque<Value> task_events;         // bounded ring of DICTs
  size_t task_event_cap = env_size("RTPU_GCS_TASK_EVENT_CAP", 1 << 16);
  size_t max_dead_workers = env_size("RTPU_GCS_MAX_DEAD_WORKERS", 4096);
  // task events are telemetry: persist them on a slow cadence, never at
  // the heartbeat-flush rate (the ring alone can be multi-MB)
  double tev_last_persist_mono = 0;
  double tev_persist_every_s = env_f("RTPU_GCS_TEV_PERSIST_S", 5.0);
  double death_timeout_s = 5.0;

  // Env-tunable caps/intervals (flag registry: _private/flags.py; the
  // daemon inherits the head's env, which carries cluster-level flags)
  // Garbage or non-positive values fall back to the default, matching
  // the Python registry's _coerce contract — a typo must never unbound
  // a ring or zero a timeout.
  static size_t env_size(const char* name, size_t dflt) {
    const char* v = getenv(name);
    if (!v || !*v) return dflt;
    char* end = nullptr;
    long long n = strtoll(v, &end, 10);
    return (end && *end == '\0' && n > 0) ? size_t(n) : dflt;
  }
  static double env_f(const char* name, double dflt) {
    const char* v = getenv(name);
    if (!v || !*v) return dflt;
    char* end = nullptr;
    double x = strtod(v, &end);
    return (end && *end == '\0' && x > 0) ? x : dflt;
  }
  // pubsub event log
  std::deque<Event> events;
  uint64_t next_seq = 1;
  size_t ring_cap = env_size("RTPU_GCS_RING_CAP", 16384);

  // persistence (pluggable: file | redis — see make_persist)
  std::unique_ptr<PersistBackend> persist;
  bool dirty = false;
  double snapshot_due_mono = 0;  // 0 = none pending
  double debounce_s = env_f("RTPU_GCS_SNAPSHOT_DEBOUNCE_S", 0.2);

  void publish(const std::string& channel, Value payload) {
    events.push_back(Event{next_seq++, channel, std::move(payload)});
    while (events.size() > ring_cap) events.pop_front();
  }

  void mutated() {
    if (!persist) return;
    dirty = true;
    if (snapshot_due_mono == 0) snapshot_due_mono = mono_s() + debounce_s;
  }

  void snapshot() {
    snapshot_due_mono = 0;
    if (!persist || !dirty) return;
    dirty = false;
    Value state = Value::Dict();
    Value va = Value::Dict();
    for (auto& [id, info] : actors)
      va.pairs->emplace_back(Value::Bytes(id), info);
    state.set("actors", va);
    Value vn = Value::Dict();
    for (auto& [name, id] : named)
      vn.pairs->emplace_back(Value::Str(name), Value::Bytes(id));
    state.set("named_actors", vn);
    Value vk = Value::Dict();
    for (auto& [key, val] : kv) {
      Value t = Value::Tuple();
      t.push(Value::Str(key.first));
      t.push(Value::Bytes(key.second));
      vk.pairs->emplace_back(std::move(t), Value::Bytes(val));
    }
    state.set("kv", vk);
    Value vp = Value::Dict();
    for (auto& [id, pg] : pgs)
      vp.pairs->emplace_back(Value::Bytes(id), pg);
    state.set("placement_groups", vp);
    Value vj = Value::Dict();
    for (auto& [id, job] : jobs)
      vj.pairs->emplace_back(Value::Str(id), job);
    state.set("jobs", vj);
    Value vw = Value::Dict();
    for (auto& [id, w] : workers)
      vw.pairs->emplace_back(Value::Bytes(id), w);
    state.set("workers", vw);
    Value vt = Value::List();
    for (auto& ev : task_events) vt.push(ev);
    state.set("task_events", vt);

    std::string data = wire::encode(state);
    if (!persist->store(data)) {
      // re-arm the timer OURSELVES: with a network backend a transient
      // failure must retry even if no further mutation ever arrives
      dirty = true;
      snapshot_due_mono = mono_s() + 1.0;
    }
  }

  void restore() {
    std::string data;
    if (!persist->load(&data)) {
      // the durable store exists but is unreachable: starting EMPTY and
      // later overwriting it would destroy the persisted control plane
      fprintf(stderr,
              "FATAL: GCS persistence backend unreachable at startup\n");
      exit(1);
    }
    if (data.empty()) return;
    Value state;
    try {
      state = wire::decode(data);
    } catch (const wire::WireError&) {
      return;  // torn/corrupt snapshot: start empty
    }
    if (state.kind != Value::DICT) return;
    if (const Value* va = state.get("actors"); va && va->pairs)
      for (auto& [k, v] : *va->pairs)
        if (k.kind == Value::BYTES) actors[k.s] = v;
    if (const Value* vn = state.get("named_actors"); vn && vn->pairs)
      for (auto& [k, v] : *vn->pairs)
        if (k.kind == Value::STR && v.kind == Value::BYTES) named[k.s] = v.s;
    if (const Value* vk = state.get("kv"); vk && vk->pairs)
      for (auto& [k, v] : *vk->pairs)
        if (k.kind == Value::TUPLE && k.items && k.items->size() == 2 &&
            v.kind == Value::BYTES)
          kv[{(*k.items)[0].s, (*k.items)[1].s}] = v.s;
    if (const Value* vp = state.get("placement_groups"); vp && vp->pairs)
      for (auto& [k, v] : *vp->pairs)
        if (k.kind == Value::BYTES) pgs[k.s] = v;
    if (const Value* vj = state.get("jobs"); vj && vj->pairs)
      for (auto& [k, v] : *vj->pairs)
        if (k.kind == Value::STR) jobs[k.s] = v;
    if (const Value* vw = state.get("workers"); vw && vw->pairs)
      for (auto& [k, v] : *vw->pairs)
        if (k.kind == Value::BYTES) workers[k.s] = v;
    if (const Value* vt = state.get("task_events"); vt && vt->items)
      for (auto& ev : *vt->items) task_events.push_back(ev);

    // Restored workers belonged to the previous incarnation's processes:
    // they are gone (the reference's WorkerTable reports them DEAD on
    // GCS failover the same way).
    for (auto& [id, w] : workers) {
      const Value* st = w.get("state");
      if (!st || st->kind != Value::STR || st->s != kStateDead) {
        w.set("state", Value::Str(kStateDead));
        w.set("exit_detail",
              Value::Str("GCS restarted; worker process lost"));
      }
    }

    // Restored actors lived on nodes that predate this incarnation: mark
    // restartable ones RESTARTING so the head scheduler recreates them,
    // DEAD otherwise (reference: gcs_actor_manager restart-on-GCS-recovery).
    for (auto& [id, info] : actors) {
      const Value* st = info.get("state");
      if (st && st->kind == Value::STR && st->s == kStateDead) continue;
      int64_t max_r = info.get("max_restarts") ? info.get("max_restarts")->as_i() : 0;
      int64_t num_r = info.get("num_restarts") ? info.get("num_restarts")->as_i() : 0;
      if (max_r == -1 || num_r < max_r) {
        info.set("state", Value::Str(kStateRestarting));
        info.set("num_restarts", Value::Int(num_r + 1));
        info.set("worker_id", Value::None());
        info.set("node_id", Value::None());
        info.set("addr", Value::None());
      } else {
        info.set("state", Value::Str(kStateDead));
        info.set("death_cause",
                 Value::Str("GCS restarted; actor not restartable"));
        const Value* nm = info.get("name");
        if (nm && nm->kind == Value::STR) named.erase(nm->s);
      }
    }
    dirty = true;
    snapshot();  // restart transitions must survive ANOTHER crash
  }
};

// ---------------------------------------------------------------------------
// Method dispatch
// ---------------------------------------------------------------------------

static const Value* arg(const wire::Request& req, size_t i,
                        const char* name = nullptr) {
  if (req.args.items && i < req.args.items->size())
    return &(*req.args.items)[i];
  if (name) return req.kwargs.get(name);
  return nullptr;
}

static std::string arg_bytes(const wire::Request& req, size_t i,
                             const char* name) {
  const Value* v = arg(req, i, name);
  if (!v || (v->kind != Value::BYTES && v->kind != Value::STR))
    throw wire::WireError(std::string("bad argument: ") + name);
  return v->s;
}

static Value actor_event(const Value& info) {
  Value ev = Value::Dict();
  ev.set("ch", Value::Str("actors"));
  const Value* id = info.get("actor_id");
  ev.set("actor_id", id ? *id : Value::None());
  const Value* st = info.get("state");
  ev.set("state", st ? *st : Value::None());
  const Value* ad = info.get("addr");
  ev.set("addr", ad ? *ad : Value::None());
  return ev;
}

// Drops a node from every object's location set; objects losing their last
// copy are tombstoned LOST (+ published) so owners re-execute lineage.
// Shared by mark_node_dead (node died) and drop_node_objects (the node is
// alive but its store daemon restarted empty under supervision).  Returns
// how many objects lost their last copy.
static int64_t do_drop_node_objects(Gcs& g, const std::string& node_id) {
  int64_t lost = 0;
  for (auto oit = g.obj_locs.begin(); oit != g.obj_locs.end();) {
    oit->second.erase(node_id);
    if (oit->second.empty()) {
      if (g.lost_objects.size() >= 1000000)
        g.lost_objects.erase(g.lost_objects.begin());
      g.lost_objects.insert(oit->first);
      lost++;
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("objects"));
      ev.set("oid", Value::Bytes(oit->first));
      ev.set("lost", Value::Bool(true));
      g.publish("objects", std::move(ev));
      oit = g.obj_locs.erase(oit);
    } else {
      ++oit;
    }
  }
  return lost;
}

// Marks a node dead; returns true on alive->dead transition.  Mirrors
// gcs.py mark_node_dead including the object-location cleanup + LOST
// tombstones that let owners trigger lineage re-execution.
static bool do_mark_node_dead(Gcs& g, const std::string& node_id) {
  auto it = g.nodes.find(node_id);
  if (it == g.nodes.end()) return false;
  Value& info = it->second;
  const Value* alive = info.get("alive");
  if (!alive || !alive->truthy()) return false;
  info.set("alive", Value::Bool(false));
  do_drop_node_objects(g, node_id);
  Value ev = Value::Dict();
  ev.set("ch", Value::Str("nodes"));
  ev.set("node_id", Value::Bytes(node_id));
  ev.set("alive", Value::Bool(false));
  g.publish("nodes", std::move(ev));
  return true;
}

struct PendingSub {
  bool parked = false;
  std::vector<std::string> channels;
  uint64_t cursor = 0;
  double deadline_mono = 0;
};

// Builds the sub_poll reply for a cursor; returns false if nothing to send
// yet (caller may park).
static bool sub_reply(Gcs& g, const std::vector<std::string>& channels,
                      uint64_t cursor, Value* out) {
  uint64_t oldest = g.events.empty() ? g.next_seq : g.events.front().seq;
  Value reply = Value::Dict();
  if (cursor < oldest) {
    // events the subscriber hasn't seen were evicted from the ring:
    // signal a gap so it re-reads table state instead of trusting events
    reply.set("cursor", Value::Int(int64_t(g.next_seq)));
    reply.set("events", Value::List());
    reply.set("gap", Value::Bool(true));
    *out = std::move(reply);
    return true;
  }
  Value evs = Value::List();
  uint64_t next_cursor = cursor;
  for (const Event& e : g.events) {
    if (e.seq < cursor) continue;
    next_cursor = e.seq + 1;
    bool match = channels.empty();
    for (const std::string& ch : channels)
      if (e.channel == ch) { match = true; break; }
    if (match) evs.push(e.payload);
  }
  if (evs.items->empty()) return false;
  reply.set("cursor", Value::Int(int64_t(next_cursor)));
  reply.set("events", std::move(evs));
  reply.set("gap", Value::Bool(false));
  *out = std::move(reply);
  return true;
}

// Dispatch one request.  Returns the response frame body; sets *park when
// the request is a long-poll that must wait (no frame is sent yet).
static std::string dispatch(Gcs& g, const wire::Request& req,
                            PendingSub* park) {
  const std::string& m = req.method;
  Value r = Value::None();
  try {
    if (m == "kv_put") {
      std::string ns = arg_bytes(req, 0, "namespace");
      std::string key = arg_bytes(req, 1, "key");
      g.kv[{ns, key}] = arg_bytes(req, 2, "value");
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("kv:" + ns));
      ev.set("key", Value::Bytes(key));
      g.publish("kv:" + ns, std::move(ev));
      g.mutated();
    } else if (m == "kv_get") {
      auto it = g.kv.find({arg_bytes(req, 0, "namespace"),
                           arg_bytes(req, 1, "key")});
      if (it != g.kv.end()) r = Value::Bytes(it->second);
    } else if (m == "kv_del") {
      g.kv.erase({arg_bytes(req, 0, "namespace"), arg_bytes(req, 1, "key")});
      g.mutated();
    } else if (m == "kv_keys") {
      std::string ns = arg_bytes(req, 0, "namespace");
      r = Value::List();
      for (auto& [key, _] : g.kv)
        if (key.first == ns) r.push(Value::Bytes(key.second));
    } else if (m == "register_actor") {
      const Value* info = arg(req, 0, "info");
      if (!info || info->kind != Value::STRUCT)
        throw wire::WireError("register_actor needs ActorInfo");
      Value copy = *info;
      copy.pairs = std::make_shared<wire::ValuePairs>(*info->pairs);
      const Value* aid = copy.get("actor_id");
      if (!aid || aid->kind != Value::BYTES)
        throw wire::WireError("register_actor: missing actor_id");
      const Value* nm = copy.get("name");
      if (nm && nm->kind == Value::STR && !nm->s.empty()) {
        if (g.named.count(nm->s))
          return wire::encode_response(
              false, Value::Error("ValueError", "actor name '" + nm->s +
                                                    "' already taken"));
        g.named[nm->s] = aid->s;
      }
      g.actors[aid->s] = copy;
      g.publish("actors", actor_event(copy));
      g.mutated();
    } else if (m == "update_actor") {
      std::string id = arg_bytes(req, 0, "actor_id");
      auto it = g.actors.find(id);
      if (it != g.actors.end()) {
        Value& info = it->second;
        // fields arrive as kwargs (plus any positional dict is ignored —
        // the Python surface is update_actor(actor_id, **fields))
        if (req.kwargs.pairs)
          for (auto& [k, v] : *req.kwargs.pairs)
            if (k.kind == Value::STR) info.set(k.s, v);
        const Value* st = info.get("state");
        if (st && st->kind == Value::STR && st->s == kStateDead) {
          const Value* nm = info.get("name");
          if (nm && nm->kind == Value::STR) {
            auto nit = g.named.find(nm->s);
            if (nit != g.named.end() && nit->second == id)
              g.named.erase(nit);
          }
        }
        g.publish("actors", actor_event(info));
        g.mutated();
      }
    } else if (m == "get_actor") {
      auto it = g.actors.find(arg_bytes(req, 0, "actor_id"));
      if (it != g.actors.end()) r = it->second;
    } else if (m == "get_actor_by_name") {
      const Value* nm = arg(req, 0, "name");
      if (nm && nm->kind == Value::STR) {
        auto nit = g.named.find(nm->s);
        if (nit != g.named.end()) {
          auto it = g.actors.find(nit->second);
          if (it != g.actors.end()) r = it->second;
        }
      }
    } else if (m == "list_actors") {
      r = Value::List();
      for (auto& [_, info] : g.actors) r.push(info);
    } else if (m == "register_node") {
      const Value* info = arg(req, 0, "info");
      if (!info || info->kind != Value::STRUCT)
        throw wire::WireError("register_node needs NodeInfo");
      Value copy = *info;
      copy.pairs = std::make_shared<wire::ValuePairs>(*info->pairs);
      const Value* nid = copy.get("node_id");
      if (!nid || nid->kind != Value::BYTES)
        throw wire::WireError("register_node: missing node_id");
      const Value* res = copy.get("resources");
      copy.set("available", res ? *res : Value::Dict());
      if (!copy.get("ts")) copy.set("ts", Value::Float(now_s()));
      g.nodes[nid->s] = copy;
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("nodes"));
      ev.set("node_id", Value::Bytes(nid->s));
      ev.set("alive", Value::Bool(true));
      g.publish("nodes", std::move(ev));
    } else if (m == "list_nodes") {
      r = Value::List();
      for (auto& [_, info] : g.nodes) r.push(info);
    } else if (m == "get_node") {
      auto it = g.nodes.find(arg_bytes(req, 0, "node_id"));
      if (it != g.nodes.end()) r = it->second;
    } else if (m == "heartbeat") {
      auto it = g.nodes.find(arg_bytes(req, 0, "node_id"));
      if (it != g.nodes.end()) {
        Value& info = it->second;
        const Value* alive = info.get("alive");
        if (alive && alive->truthy()) {
          info.set("ts", Value::Float(now_s()));
          const Value* av = arg(req, 1, "available");
          if (av) info.set("available", *av);
          const Value* q = arg(req, 2, "queued");
          if (q) info.set("queued", *q);
        }
      }
    } else if (m == "mark_node_dead") {
      r = Value::Bool(do_mark_node_dead(g, arg_bytes(req, 0, "node_id")));
    } else if (m == "drop_node_objects") {
      r = Value::Int(do_drop_node_objects(g, arg_bytes(req, 0, "node_id")));
    } else if (m == "check_node_health") {
      double now = now_s();
      std::vector<std::string> stale;
      for (auto& [id, info] : g.nodes) {
        const Value* alive = info.get("alive");
        const Value* is_head = info.get("is_head");
        const Value* ts = info.get("ts");
        if (alive && alive->truthy() && !(is_head && is_head->truthy()) &&
            ts && now - ts->as_f() > g.death_timeout_s)
          stale.push_back(id);
      }
      r = Value::List();
      for (const std::string& id : stale)
        if (do_mark_node_dead(g, id)) r.push(Value::Bytes(id));
    } else if (m == "add_object_location") {
      std::string oid = arg_bytes(req, 0, "oid");
      g.obj_locs[oid].insert(arg_bytes(req, 1, "node_id"));
      g.lost_objects.erase(oid);
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("objects"));
      ev.set("oid", Value::Bytes(oid));
      ev.set("lost", Value::Bool(false));
      g.publish("objects", std::move(ev));
    } else if (m == "add_object_locations") {
      // batched seal-notification flush: one RPC, many locations
      const Value* pairs = arg(req, 0, "pairs");
      if (pairs && pairs->items) {
        for (const Value& p : *pairs->items) {
          if (!p.items || p.items->size() != 2) continue;
          const Value& oid = (*p.items)[0];
          const Value& nid = (*p.items)[1];
          if (oid.kind != Value::BYTES || nid.kind != Value::BYTES)
            continue;
          g.obj_locs[oid.s].insert(nid.s);
          g.lost_objects.erase(oid.s);
          Value ev = Value::Dict();
          ev.set("ch", Value::Str("objects"));
          ev.set("oid", Value::Bytes(oid.s));
          ev.set("lost", Value::Bool(false));
          g.publish("objects", std::move(ev));
        }
      }
    } else if (m == "remove_object_location") {
      std::string oid = arg_bytes(req, 0, "oid");
      auto it = g.obj_locs.find(oid);
      if (it != g.obj_locs.end()) {
        it->second.erase(arg_bytes(req, 1, "node_id"));
        if (it->second.empty()) g.obj_locs.erase(it);
      }
    } else if (m == "get_object_locations") {
      r = Value::List();
      auto it = g.obj_locs.find(arg_bytes(req, 0, "oid"));
      if (it != g.obj_locs.end())
        for (const std::string& nid : it->second) r.push(Value::Bytes(nid));
    } else if (m == "all_object_locations") {
      r = Value::Dict();
      for (auto& [oid, locs] : g.obj_locs) {
        Value l = Value::List();
        for (const std::string& nid : locs) l.push(Value::Bytes(nid));
        r.pairs->emplace_back(Value::Bytes(oid), std::move(l));
      }
    } else if (m == "object_lost") {
      r = Value::Bool(g.lost_objects.count(arg_bytes(req, 0, "oid")) > 0);
    } else if (m == "clear_object_lost") {
      g.lost_objects.erase(arg_bytes(req, 0, "oid"));
    } else if (m == "register_pg") {
      Value pg = Value::Dict();
      const Value* bundles = arg(req, 1, "bundles");
      const Value* strategy = arg(req, 2, "strategy");
      const Value* assignment = arg(req, 3, "assignment");
      pg.set("bundles", bundles ? *bundles : Value::List());
      pg.set("strategy", strategy ? *strategy : Value::Str("PACK"));
      pg.set("assignment", assignment ? *assignment : Value::List());
      g.pgs[arg_bytes(req, 0, "pg_id")] = std::move(pg);
      g.mutated();
    } else if (m == "get_pg") {
      auto it = g.pgs.find(arg_bytes(req, 0, "pg_id"));
      if (it != g.pgs.end()) r = it->second;
    } else if (m == "remove_pg") {
      g.pgs.erase(arg_bytes(req, 0, "pg_id"));
      g.mutated();
    } else if (m == "list_pgs") {
      r = Value::Dict();
      for (auto& [id, pg] : g.pgs)
        r.pairs->emplace_back(Value::Bytes(id), pg);
    } else if (m == "add_job") {
      // (job_id, info DICT) — full record insert; publishes on "jobs"
      std::string jid = arg_bytes(req, 0, "job_id");
      const Value* info = arg(req, 1, "info");
      if (!info || (info->kind != Value::DICT &&
                    info->kind != Value::STRUCT))
        throw wire::WireError("add_job needs an info dict");
      g.jobs[jid] = *info;
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("jobs"));
      ev.set("job_id", Value::Str(jid));
      g.publish("jobs", std::move(ev));
      g.mutated();
    } else if (m == "update_job") {
      // (job_id, fields DICT) — merge; missing job returns False
      std::string jid = arg_bytes(req, 0, "job_id");
      auto it = g.jobs.find(jid);
      if (it == g.jobs.end()) {
        r = Value::Bool(false);
      } else {
        const Value* fields = arg(req, 1, "fields");
        if (fields && fields->pairs) {
          Value copy = it->second;
          copy.pairs = std::make_shared<wire::ValuePairs>(
              *it->second.pairs);
          for (auto& [k, v] : *fields->pairs)
            if (k.kind == Value::STR) copy.set(k.s.c_str(), v);
          it->second = std::move(copy);
        }
        Value ev = Value::Dict();
        ev.set("ch", Value::Str("jobs"));
        ev.set("job_id", Value::Str(jid));
        g.publish("jobs", std::move(ev));
        g.mutated();
        r = Value::Bool(true);
      }
    } else if (m == "get_job") {
      auto it = g.jobs.find(arg_bytes(req, 0, "job_id"));
      if (it != g.jobs.end()) r = it->second;
    } else if (m == "list_jobs") {
      r = Value::List();
      for (auto& [_, job] : g.jobs) r.push(job);
    } else if (m == "add_worker") {
      std::string wid = arg_bytes(req, 0, "worker_id");
      const Value* info = arg(req, 1, "info");
      if (!info || (info->kind != Value::DICT &&
                    info->kind != Value::STRUCT))
        throw wire::WireError("add_worker needs an info dict");
      g.workers[wid] = *info;
      // bound the table: evict the oldest DEAD records past the cap
      if (g.workers.size() > 2 * g.max_dead_workers) {
        std::vector<std::pair<double, std::string>> dead;
        for (auto& [id, w] : g.workers) {
          const Value* st = w.get("state");
          if (st && st->kind == Value::STR && st->s == kStateDead) {
            const Value* ts = w.get("end_ts");
            dead.emplace_back(ts ? ts->as_f() : 0.0, id);
          }
        }
        std::sort(dead.begin(), dead.end());
        size_t drop = dead.size() > g.max_dead_workers
                          ? dead.size() - g.max_dead_workers
                          : 0;
        for (size_t i = 0; i < drop; ++i) g.workers.erase(dead[i].second);
      }
      g.mutated();
    } else if (m == "update_worker") {
      std::string wid = arg_bytes(req, 0, "worker_id");
      auto it = g.workers.find(wid);
      if (it == g.workers.end()) {
        r = Value::Bool(false);
      } else {
        const Value* fields = arg(req, 1, "fields");
        if (fields && fields->pairs) {
          Value copy = it->second;
          copy.pairs = std::make_shared<wire::ValuePairs>(
              *it->second.pairs);
          for (auto& [k, v] : *fields->pairs)
            if (k.kind == Value::STR) copy.set(k.s.c_str(), v);
          it->second = std::move(copy);
        }
        g.mutated();
        r = Value::Bool(true);
      }
    } else if (m == "list_workers") {
      r = Value::List();
      for (auto& [_, w] : g.workers) r.push(w);
    } else if (m == "add_task_events") {
      // (events LIST of DICT): batch append into the bounded ring —
      // one RPC per flusher wakeup, mirroring the reference's
      // task_event_buffer batching
      const Value* evs = arg(req, 0, "events");
      if (evs && evs->items) {
        for (auto& ev : *evs->items) g.task_events.push_back(ev);
        while (g.task_events.size() > g.task_event_cap)
          g.task_events.pop_front();
        double now = mono_s();
        if (now - g.tev_last_persist_mono > g.tev_persist_every_s) {
          g.tev_last_persist_mono = now;
          g.mutated();
        }
      }
      r = Value::Int(int64_t(g.task_events.size()));
    } else if (m == "list_task_events") {
      // (limit) — newest-last window of the ring
      const Value* lim = arg(req, 0, "limit");
      size_t limit = lim ? size_t(lim->as_i()) : size_t(1000);
      r = Value::List();
      size_t start = g.task_events.size() > limit
                         ? g.task_events.size() - limit
                         : 0;
      for (size_t i = start; i < g.task_events.size(); ++i)
        r.push(g.task_events[i]);
    } else if (m == "broadcast_command") {
      // syncer COMMANDS channel (reference: ray_syncer.h:83): publish the
      // payload cluster-wide; schedulers subscribed to "commands" act
      const Value* payload = arg(req, 0, "payload");
      Value ev = Value::Dict();
      ev.set("ch", Value::Str("commands"));
      if (payload && payload->pairs)
        for (auto& [k, v] : *payload->pairs)
          if (k.kind == Value::STR && k.s != "ch") ev.set(k.s, v);
      g.publish("commands", std::move(ev));
    } else if (m == "sub_poll") {
      // sub_poll(channels, cursor, timeout_ms) -> {cursor, events, gap}
      const Value* chv = arg(req, 0, "channels");
      std::vector<std::string> channels;
      if (chv && chv->items)
        for (const Value& c : *chv->items)
          if (c.kind == Value::STR) channels.push_back(c.s);
      const Value* cur = arg(req, 1, "cursor");
      int64_t cursor = cur ? cur->as_i() : -1;
      const Value* tmo = arg(req, 2, "timeout_ms");
      int64_t timeout_ms = tmo ? tmo->as_i() : 0;
      if (cursor < 0) {  // tail: hand back the current end of the log
        Value reply = Value::Dict();
        reply.set("cursor", Value::Int(int64_t(g.next_seq)));
        reply.set("events", Value::List());
        reply.set("gap", Value::Bool(false));
        return wire::encode_response(true, reply);
      }
      Value reply;
      if (sub_reply(g, channels, uint64_t(cursor), &reply))
        return wire::encode_response(true, reply);
      if (timeout_ms > 0) {  // park until publish or timeout
        park->parked = true;
        park->channels = std::move(channels);
        park->cursor = uint64_t(cursor);
        park->deadline_mono = mono_s() + double(timeout_ms) / 1000.0;
        return std::string();
      }
      // nothing matched in the scanned range: advance to the end, or
      // unrelated-channel churn would evict the stale position and turn
      // every later poll into a spurious gap
      reply = Value::Dict();
      reply.set("cursor", Value::Int(int64_t(g.next_seq)));
      reply.set("events", Value::List());
      reply.set("gap", Value::Bool(false));
      return wire::encode_response(true, reply);
    } else {
      return wire::encode_response(
          false,
          Value::Error("ValueError", "unknown GCS method '" + m + "'"));
    }
  } catch (const wire::WireError& e) {
    return wire::encode_response(false,
                                 Value::Error("ValueError", e.what()));
  }
  return wire::encode_response(true, r);
}

// ---------------------------------------------------------------------------
// Event loop: epoll, nonblocking conns, length-prefixed frames
// ---------------------------------------------------------------------------

struct Conn {
  int fd;
  bool is_tcp;
  enum Phase { AUTH, HELLO, READY } phase;
  std::string in;    // read accumulation
  std::string out;   // pending writes
  PendingSub sub;    // parked long-poll (at most one per conn)
  bool closing = false;
};

static constexpr size_t kMaxFrame = 1u << 28;

static void set_nonblock(int fd) {
  fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
}

struct Server {
  Gcs gcs;
  int epfd = -1;
  int listen_fd = -1;
  bool listen_tcp = false;
  std::string token;  // TCP peers must present this before frame 1
  std::map<int, Conn> conns;

  void add_frame(Conn& c, const std::string& body) {
    uint32_t n = uint32_t(body.size());
    char hdr[4];
    memcpy(hdr, &n, 4);
    c.out.append(hdr, 4);
    c.out.append(body);
  }

  void want_write(Conn& c) {
    struct epoll_event ev;
    ev.events = EPOLLIN | (c.out.empty() ? 0 : EPOLLOUT);
    ev.data.fd = c.fd;
    epoll_ctl(epfd, EPOLL_CTL_MOD, c.fd, &ev);
  }

  void close_conn(int fd) {
    epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    conns.erase(fd);
  }

  void flush(Conn& c) {
    while (!c.out.empty()) {
      ssize_t n = write(c.fd, c.out.data(), c.out.size());
      if (n > 0) {
        c.out.erase(0, size_t(n));
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else {
        c.closing = true;
        return;
      }
    }
    if (c.closing && c.out.empty()) return;
    want_write(c);
  }

  // Completes parked long-polls that now have matching events (called
  // after every dispatch that may have published).
  void wake_subscribers() {
    for (auto& [fd, c] : conns) {
      if (!c.sub.parked) continue;
      Value reply;
      if (sub_reply(gcs, c.sub.channels, c.sub.cursor, &reply)) {
        c.sub.parked = false;
        add_frame(c, wire::encode_response(true, reply));
        flush(c);
      }
    }
  }

  void expire_subscribers(double now_mono) {
    for (auto& [fd, c] : conns) {
      if (!c.sub.parked || c.sub.deadline_mono > now_mono) continue;
      c.sub.parked = false;
      Value reply = Value::Dict();
      // every event < next_seq was scanned (wake_subscribers runs after
      // each publish): none matched, so the cursor can safely advance —
      // leaving it behind would rot into spurious gaps under churn
      reply.set("cursor", Value::Int(int64_t(gcs.next_seq)));
      reply.set("events", Value::List());
      reply.set("gap", Value::Bool(false));
      add_frame(c, wire::encode_response(true, reply));
      flush(c);
    }
  }

  // Pulls complete frames out of c.in; returns false when the connection
  // must close.
  bool on_readable(Conn& c) {
    char buf[1 << 16];
    for (;;) {
      ssize_t n = read(c.fd, buf, sizeof buf);
      if (n > 0) {
        c.in.append(buf, size_t(n));
        if (c.in.size() > kMaxFrame + 4) return false;  // flooding
      } else if (n == 0) {
        return false;  // clean EOF
      } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
        break;
      } else {
        return false;
      }
    }
    for (;;) {
      if (c.in.size() < 4) return true;
      uint32_t len;
      memcpy(&len, c.in.data(), 4);
      if (len > kMaxFrame) return false;
      if (c.in.size() < 4 + size_t(len)) return true;
      std::string body = c.in.substr(4, len);
      c.in.erase(0, 4 + size_t(len));
      if (!on_frame(c, body)) return false;
    }
  }

  bool on_frame(Conn& c, const std::string& body) {
    switch (c.phase) {
      case Conn::AUTH:
        // constant-time-ish compare (reference: token-authenticated TCP
        // control plane; see protocol.py authenticate_server_side)
        if (body.size() != token.size() ||
            CRYPTO_memcmp(body, token) != 0) {
          add_frame(c, "NO");
          flush(c);
          return false;
        }
        add_frame(c, "OK");
        c.phase = Conn::HELLO;
        flush(c);
        return true;
      case Conn::HELLO:
        if (body != wire::kHello) return false;  // version mismatch: hang up
        add_frame(c, wire::kHelloOk);
        c.phase = Conn::READY;
        flush(c);
        return true;
      case Conn::READY: {
        wire::Request req;
        try {
          req = wire::decode_request(body);
        } catch (const wire::WireError& e) {
          add_frame(c, wire::encode_response(
                           false, Value::Error("ValueError", e.what())));
          flush(c);
          return true;  // framing is intact; keep serving
        }
        PendingSub park;
        std::string resp = dispatch(gcs, req, &park);
        if (park.parked) {
          c.sub = std::move(park);
          return true;
        }
        add_frame(c, resp);
        flush(c);
        wake_subscribers();
        return true;
      }
    }
    return false;
  }

  static int CRYPTO_memcmp(const std::string& a, const std::string& b) {
    unsigned char d = 0;
    for (size_t i = 0; i < a.size(); ++i)
      d |= (unsigned char)(a[i]) ^ (unsigned char)(b[i]);
    return d;
  }

  void accept_all() {
    for (;;) {
      int fd = accept(listen_fd, nullptr, nullptr);
      if (fd < 0) return;
      set_nonblock(fd);
      if (listen_tcp) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      }
      Conn c;
      c.fd = fd;
      c.is_tcp = listen_tcp;
      c.phase = listen_tcp ? Conn::AUTH : Conn::HELLO;
      conns.emplace(fd, std::move(c));
      struct epoll_event ev;
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  pid_t parent_pid = 0;  // exit when the spawning head process dies
  double next_parent_check = 0;

  int run() {
    struct epoll_event evs[64];
    for (;;) {
      if (g_stop) {  // SIGTERM/SIGINT: flush durable state, then exit
        gcs.dirty = gcs.dirty || bool(gcs.persist);
        gcs.snapshot();
        return 0;
      }
      // epoll timeout = nearest of (snapshot debounce, sub deadlines)
      double now = mono_s();
      if (parent_pid > 0 && now >= next_parent_check) {
        next_parent_check = now + 1.0;
        if (kill(parent_pid, 0) != 0 && errno == ESRCH) {
          gcs.snapshot();  // flush durable state before orphan exit
          return 0;
        }
      }
      double next = now + 1.0;
      if (gcs.snapshot_due_mono > 0 && gcs.snapshot_due_mono < next)
        next = gcs.snapshot_due_mono;
      for (auto& [fd, c] : conns)
        if (c.sub.parked && c.sub.deadline_mono < next)
          next = c.sub.deadline_mono;
      int timeout_ms = int((next - now) * 1000.0);
      if (timeout_ms < 0) timeout_ms = 0;
      int n = epoll_wait(epfd, evs, 64, timeout_ms);
      if (n < 0 && errno == EINTR) continue;  // signal: loop re-checks g_stop
      now = mono_s();
      if (gcs.snapshot_due_mono > 0 && now >= gcs.snapshot_due_mono)
        gcs.snapshot();
      expire_subscribers(now);
      for (int i = 0; i < n; ++i) {
        int fd = evs[i].data.fd;
        if (fd == listen_fd) {
          accept_all();
          continue;
        }
        auto it = conns.find(fd);
        if (it == conns.end()) continue;
        Conn& c = it->second;
        bool ok = true;
        if (evs[i].events & (EPOLLHUP | EPOLLERR))
          ok = false;
        else {
          if (evs[i].events & EPOLLIN) ok = on_readable(c);
          if (ok && (evs[i].events & EPOLLOUT)) flush(c);
          if (c.closing) ok = false;
        }
        if (!ok) close_conn(fd);
      }
    }
  }
};

int main(int argc, char** argv) {
  std::string bind_addr, advertise_file, persist;
  double death_timeout = 5.0;
  int parent_pid_arg = 0;
  for (int i = 1; i < argc - 1; ++i) {
    std::string a = argv[i];
    if (a == "--bind") bind_addr = argv[++i];
    else if (a == "--advertise-file") advertise_file = argv[++i];
    else if (a == "--persist") persist = argv[++i];
    else if (a == "--death-timeout-s") death_timeout = atof(argv[++i]);
    else if (a == "--parent-pid") parent_pid_arg = atoi(argv[++i]);
  }
  if (bind_addr.empty()) {
    fprintf(stderr, "usage: gcs_server --bind <unix path|host:port> "
                    "[--advertise-file F] [--persist F] "
                    "[--death-timeout-s S]\n");
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  struct sigaction sa_stop;
  memset(&sa_stop, 0, sizeof sa_stop);
  sa_stop.sa_handler = on_stop_signal;  // no SA_RESTART: epoll must EINTR
  sigaction(SIGTERM, &sa_stop, nullptr);
  sigaction(SIGINT, &sa_stop, nullptr);

  Server srv;
  srv.parent_pid = parent_pid_arg;
  srv.gcs.death_timeout_s = death_timeout;
  srv.gcs.persist = make_persist(persist);
  if (srv.gcs.persist) srv.gcs.restore();
  const char* tok = getenv("RTPU_CLUSTER_TOKEN");
  srv.token = tok ? tok : "";

  // TCP address = has a ':' and doesn't start with '/' or '.'
  size_t colon = bind_addr.rfind(':');
  srv.listen_tcp = bind_addr[0] != '/' && bind_addr[0] != '.' &&
                   colon != std::string::npos;
  std::string advertised = bind_addr;
  if (srv.listen_tcp) {
    std::string host = bind_addr.substr(0, colon);
    int port = atoi(bind_addr.c_str() + colon + 1);
    srv.listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(srv.listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof sa);
    sa.sin_family = AF_INET;
    sa.sin_port = htons(uint16_t(port));
    if (host.empty() || host == "0.0.0.0")
      sa.sin_addr.s_addr = INADDR_ANY;
    else if (inet_pton(AF_INET, host.c_str(), &sa.sin_addr) != 1)
      sa.sin_addr.s_addr = INADDR_ANY;
    if (bind(srv.listen_fd, (struct sockaddr*)&sa, sizeof sa) != 0 ||
        listen(srv.listen_fd, 512) != 0) {
      perror("bind/listen");
      return 1;
    }
    socklen_t slen = sizeof sa;
    getsockname(srv.listen_fd, (struct sockaddr*)&sa, &slen);
    advertised = host + ":" + std::to_string(ntohs(sa.sin_port));
  } else {
    srv.listen_fd = socket(AF_UNIX, SOCK_STREAM, 0);
    struct sockaddr_un sa;
    memset(&sa, 0, sizeof sa);
    sa.sun_family = AF_UNIX;
    strncpy(sa.sun_path, bind_addr.c_str(), sizeof sa.sun_path - 1);
    unlink(bind_addr.c_str());
    if (bind(srv.listen_fd, (struct sockaddr*)&sa, sizeof sa) != 0 ||
        listen(srv.listen_fd, 512) != 0) {
      perror("bind/listen");
      return 1;
    }
  }
  set_nonblock(srv.listen_fd);
  srv.epfd = epoll_create1(0);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.fd = srv.listen_fd;
  epoll_ctl(srv.epfd, EPOLL_CTL_ADD, srv.listen_fd, &ev);

  if (!advertise_file.empty()) {
    std::string tmp = advertise_file + ".tmp";
    FILE* f = fopen(tmp.c_str(), "w");
    if (f) {
      fprintf(f, "%s\n", advertised.c_str());
      fclose(f);
      rename(tmp.c_str(), advertise_file.c_str());
    }
  }
  return srv.run();
}
