// ray_tpu native shared-memory object store ("plasma equivalent").
//
// TPU-native re-design of the reference's plasma store
// (Ray's src/ray/object_manager/plasma/store.cc): a per-node daemon
// that owns one large POSIX shared-memory segment, hands out offsets to
// clients (which mmap the same segment for zero-copy reads/writes), tracks
// object lifecycle (CREATED -> SEALED -> released/evicted) and performs LRU
// eviction of unreferenced sealed objects under memory pressure.  Unlike the
// reference we do not use fd-passing + flatbuffers; clients address the
// segment by name (`/dev/shm/<name>`) and the wire protocol is fixed-size
// binary frames over a unix domain socket, which keeps the client mappable
// from Python via mmap + struct with no codegen.
//
// The host segment doubles as the staging tier for TPU HBM transfers: numpy
// views of sealed objects feed jax.device_put without an intermediate copy.
//
// Usage: shm_store <socket_path> <shm_name> <capacity_bytes>
//
// Wire protocol (all little-endian):
//   request:  u8 op | u8[20] object_id | u64 arg0 | u64 arg1
//   response: u8 status | u64 offset | u64 size
// Ops: 1=CREATE(size,timeout) 2=SEAL 3=GET(timeout_ms) 4=RELEASE 5=DELETE
//      6=CONTAINS 7=STATS 8=ABORT 9=PUT(size) 10=GET_INLINE(timeout,cap)
// Status: 0=OK 1=NOT_FOUND 2=EXISTS 3=OOM 4=TIMEOUT 5=NOT_SEALED 6=ERR
//
// PUT: `size` payload bytes follow the request; the daemon writes them
// straight into the fresh extent and seals — create+write+seal in ONE
// round trip (the dominant cost of a small put is the client<->daemon
// context switch on a 1-core host, so halving round trips ~doubles small
// put throughput; the reference's plasma CreateAndSealRequest exists for
// the same reason, plasma/protocol.fbs).
// GET_INLINE: blocks like GET; when the sealed object is <= cap (arg1)
// the response is status=OK, r0=1, r1=size followed by the payload bytes
// (no pin left behind — the daemon pins, copies, releases).  A larger
// object answers status=VIEW with r0=offset, r1=size and the pin KEPT:
// the client maps its zero-copy view immediately (it owes a RELEASE,
// exactly like GET).  Either way a get is ONE round trip.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <deque>
#include <map>
#include <unordered_map>
#include <unordered_set>
#include <atomic>
#include <list>
#include <memory>
#include <mutex>
#include <condition_variable>
#include <random>
#include <thread>
#include <vector>
#include <array>

#include <arpa/inet.h>
#include <cerrno>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>
#include <signal.h>

namespace {

constexpr uint8_t OP_CREATE = 1, OP_SEAL = 2, OP_GET = 3, OP_RELEASE = 4,
                  OP_DELETE = 5, OP_CONTAINS = 6, OP_STATS = 7, OP_ABORT = 8,
                  OP_PUT = 9, OP_GET_INLINE = 10, OP_PULL = 11, OP_PUSH = 12,
                  OP_AUDIT = 13;
// Daemon-to-daemon transfer ops (TCP peer listener).  XFER_PULL_RANGE is
// the striped plane: <u64 offset | u64 length> follows the id and the
// response carries only that byte range (length 0 = size probe, no
// payload) — K such connections in parallel saturate the link where one
// stream is window/cpu-bound (cf. tf.data service's parallel streams).
constexpr uint8_t XFER_PULL = 1, XFER_PUSH = 2, XFER_PULL_RANGE = 3;
constexpr uint8_t ST_OK = 0, ST_NOT_FOUND = 1, ST_EXISTS = 2, ST_OOM = 3,
                  ST_TIMEOUT = 4, ST_NOT_SEALED = 5, ST_ERR = 6,
                  ST_EVICTED = 7, ST_VIEW = 8;

constexpr size_t kIdLen = 20;
constexpr size_t kReqLen = 1 + kIdLen + 8 + 8;
constexpr size_t kRespLen = 1 + 8 + 8;
constexpr uint64_t kAlign = 64;  // cache-line align allocations
// Extent sentinel for husk entries (aborted recreation whose old readers
// are still pinned): never a valid segment offset, and FreeListAllocator
// ignores offsets it does not own.
constexpr uint64_t kInvalidOffset = ~0ull;
// OP_PULL/OP_PUSH addr payload ("host:port") sanity cap: anything longer
// is a corrupt/hostile frame, answered ST_ERR instead of allocated
// (an unbounded client-supplied length here was a one-frame daemon kill:
// std::string(arg0, '\0') -> bad_alloc -> std::terminate in a detached
// thread).
constexpr uint64_t kMaxAddrLen = 512;

using ObjectId = std::array<uint8_t, kIdLen>;

struct IdHash {
  size_t operator()(const ObjectId& id) const {
    // FNV-1a over every byte: ids are an 8-byte process prefix + a
    // monotonic counter (_private/ids.py), so any fixed-window hash
    // collapses one producer's ids into one bucket and turns the table
    // O(n) — the full mix costs ~20 cheap ops and is layout-proof.
    size_t h = 1469598103934665603ull;
    for (unsigned char ch : id) {
      h ^= ch;
      h *= 1099511628211ull;
    }
    return h;
  }
};

bool ReadFull(int fd, void* buf, size_t n);
bool WriteFull(int fd, const void* buf, size_t n);

// Coarse monotonic clock for per-object create/access stamps.  One
// steady_clock read per Create/Get — nanoseconds against a syscall-bearing
// op, so the audit accounting never taxes the zero-copy hot path.
uint64_t NowMs() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::milliseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

struct ObjectEntry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  int refcount = 0;  // pinned while > 0 (creator or active getters)
  uint64_t create_ms = 0;       // NowMs() at Create (or restore)
  uint64_t last_access_ms = 0;  // NowMs() at the most recent sealed Get
  // Delete() arrived while pinned: the extent is freed on the LAST
  // Release instead — freeing under an active zero-copy Get view would
  // let the next Create scribble over live reader memory.
  bool delete_pending = false;
  // Extents of prior incarnations deleted-while-pinned and then recreated
  // under the same id.  Their readers' pins are folded into `refcount`, so
  // they are freed when refcount drains to 0 — never while any reader of
  // any incarnation might still hold a zero-copy view.
  std::vector<uint64_t> zombie_extents;
  std::list<ObjectId>::iterator lru_it;
  bool in_lru = false;
};

// First-fit free-list allocator over [0, capacity). Offsets are segment-
// relative; the table lives host-side (not in the segment), so a crashed
// client cannot corrupt allocator metadata.
class FreeListAllocator {
 public:
  explicit FreeListAllocator(uint64_t capacity) : capacity_(capacity) {
    free_[0] = capacity;
  }
  bool Alloc(uint64_t size, uint64_t* out) {
    size = (size + kAlign - 1) / kAlign * kAlign;
    if (size == 0) size = kAlign;
    for (auto it = free_.begin(); it != free_.end(); ++it) {
      if (it->second >= size) {
        *out = it->first;
        uint64_t rem = it->second - size;
        uint64_t new_off = it->first + size;
        free_.erase(it);
        if (rem > 0) free_[new_off] = rem;
        used_ += size;
        sizes_[*out] = size;
        return true;
      }
    }
    return false;
  }
  void Free(uint64_t off) {
    auto sit = sizes_.find(off);
    if (sit == sizes_.end()) return;
    uint64_t size = sit->second;
    sizes_.erase(sit);
    used_ -= size;
    auto it = free_.emplace(off, size).first;
    // merge with next
    auto next = std::next(it);
    if (next != free_.end() && it->first + it->second == next->first) {
      it->second += next->second;
      free_.erase(next);
    }
    // merge with prev
    if (it != free_.begin()) {
      auto prev = std::prev(it);
      if (prev->first + prev->second == it->first) {
        prev->second += it->second;
        free_.erase(it);
      }
    }
  }
  uint64_t used() const { return used_; }
  uint64_t capacity() const { return capacity_; }
  // Fragmentation view for the audit plane: how many free extents the
  // arena has shattered into, and the biggest contiguous allocation that
  // can still succeed (the number that actually gates a large Create).
  uint64_t free_blocks() const { return free_.size(); }
  uint64_t largest_free() const {
    uint64_t best = 0;
    for (const auto& kv : free_)
      if (kv.second > best) best = kv.second;
    return best;
  }

 private:
  uint64_t capacity_;
  uint64_t used_ = 0;
  std::map<uint64_t, uint64_t> free_;           // offset -> size
  std::unordered_map<uint64_t, uint64_t> sizes_;  // offset -> alloc size
};

class Store {
 public:
  // base: the daemon's own mapping of the segment (spill IO); spill_dir:
  // empty string disables spilling (eviction then drops data, pre-spill
  // behavior). Reference: plasma fallback allocation + the raylet's
  // LocalObjectManager::SpillObjects (local_object_manager.h:112) — here
  // spill/restore live inside the store daemon itself, so clients need no
  // protocol change: a Get on a spilled object transparently restores it.
  Store(uint64_t capacity, uint8_t* base, std::string spill_dir)
      : alloc_(capacity), base_(base), spill_dir_(std::move(spill_dir)) {}

  uint64_t Capacity() const { return alloc_.capacity(); }

  uint8_t Create(const ObjectId& id, uint64_t size, uint64_t* offset) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    // An entry with delete_pending is logically GONE (Delete tombstoned it;
    // only a reader's pin keeps the extent alive) — recreation (task retry /
    // lineage reconstruction) must succeed, not bounce off ST_EXISTS.
    if (it != objects_.end() && !it->second.delete_pending) return ST_EXISTS;
    evicted_.erase(id);  // recreation (e.g. task retry) clears the tombstone
    DropSpilledLocked(id);  // recreation supersedes a spilled copy
    uint64_t off;
    while (!alloc_.Alloc(size, &off)) {
      if (!EvictOneLocked()) return ST_OOM;
    }
    // NOTE: EvictOneLocked above cannot have erased `it` — delete_pending
    // entries are never in the LRU (Delete removed them).
    if (it != objects_.end()) {
      // Fresh incarnation under the same id: old extent stays zombie-pinned
      // until its readers drain (pins folded into refcount).
      ObjectEntry& e = it->second;
      if (e.offset != kInvalidOffset) e.zombie_extents.push_back(e.offset);
      e.offset = off;
      e.size = size;
      e.sealed = false;
      e.delete_pending = false;
      e.refcount += 1;  // creator pin, on top of surviving old-reader pins
      e.create_ms = NowMs();
      e.last_access_ms = e.create_ms;
      *offset = off;
      return ST_OK;
    }
    ObjectEntry e;
    e.offset = off;
    e.size = size;
    e.refcount = 1;  // creator holds a ref until seal
    e.create_ms = NowMs();
    e.last_access_ms = e.create_ms;
    objects_[id] = e;
    *offset = off;
    return ST_OK;
  }

  uint8_t Seal(const ObjectId& id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    it->second.sealed = true;
    DecrefLocked(it->second, id);
    cv_.notify_all();
    return ST_OK;
  }

  uint8_t Get(const ObjectId& id, uint64_t timeout_ms, uint64_t* offset,
              uint64_t* size) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    for (;;) {
      // spilled copy: restore into shm (may spill others to make room)
      if (objects_.find(id) == objects_.end() && spilled_.count(id)) {
        uint8_t rc = RestoreLocked(id);
        if (rc != ST_OK) return rc;
      }
      if (evicted_.count(id)) return ST_EVICTED;
      auto it = objects_.find(id);
      // A deferred Delete keeps the entry until the last Release, but the
      // object is GONE to new observers (mirror Contains): do not depend on
      // the bounded tombstone ring to hide it.
      if (it != objects_.end() && it->second.delete_pending) return ST_EVICTED;
      if (it != objects_.end() && it->second.sealed) {
        it->second.refcount++;
        it->second.last_access_ms = NowMs();
        if (it->second.in_lru) {
          lru_.erase(it->second.lru_it);
          it->second.in_lru = false;
        }
        *offset = it->second.offset;
        *size = it->second.size;
        return ST_OK;
      }
      if (timeout_ms == 0) return it == objects_.end() ? ST_NOT_FOUND
                                                       : ST_NOT_SEALED;
      if (cv_.wait_until(lk, deadline) == std::cv_status::timeout)
        return ST_TIMEOUT;
    }
  }

  uint8_t Release(const ObjectId& id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    DecrefLocked(it->second, id);
    return ST_OK;
  }

  uint8_t Delete(const ObjectId& id) {
    std::unique_lock<std::mutex> lk(mu_);
    if (objects_.find(id) == objects_.end() && spilled_.count(id)) {
      // spilled-only copy: tombstone so waiters fail fast, like the
      // resident-delete path below
      DropSpilledLocked(id);
      RecordEvictedLocked(id);
      return ST_OK;
    }
    // (no DropSpilled here: an id is never resident AND spilled at once)
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    if (it->second.refcount > 0) {
      // pinned by an active getter's zero-copy view: defer the free to
      // the last Release (the id is tombstoned NOW so new Gets miss)
      it->second.delete_pending = true;
      if (it->second.in_lru) {
        lru_.erase(it->second.lru_it);
        it->second.in_lru = false;
      }
      RecordEvictedLocked(id);
      return ST_OK;
    }
    if (it->second.in_lru) lru_.erase(it->second.lru_it);
    alloc_.Free(it->second.offset);
    objects_.erase(it);
    RecordEvictedLocked(id);  // waiters fail fast instead of hanging
    return ST_OK;
  }

  // Abort an unsealed create (client died or errored mid-write).
  uint8_t Abort(const ObjectId& id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    ObjectEntry& e = it->second;
    if (e.sealed) return ST_ERR;
    if (e.offset != kInvalidOffset) alloc_.Free(e.offset);
    if (e.refcount > 1) {
      // Aborted recreation while old-incarnation readers are still pinned:
      // keep a husk entry to receive their Releases (invisible to
      // Get/Contains via delete_pending); zombies free on the last one.
      e.offset = kInvalidOffset;
      e.size = 0;
      e.delete_pending = true;
      e.refcount--;  // drop the creator pin
      RecordEvictedLocked(id);
      return ST_OK;
    }
    for (uint64_t off : e.zombie_extents) alloc_.Free(off);
    objects_.erase(it);
    return ST_OK;
  }

  uint8_t Contains(const ObjectId& id, uint64_t* sealed, uint64_t* size) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = objects_.find(id);
    // a deferred Delete (extent pinned by a reader) keeps the entry until
    // the last Release, but the object is GONE to new observers — report
    // what Get would (the evicted tombstone), not "present"
    if (it != objects_.end() && it->second.delete_pending)
      return ST_NOT_FOUND;
    if (it == objects_.end()) {
      auto sp = spilled_.find(id);
      if (sp != spilled_.end()) {  // spilled objects are still "present"
        *sealed = 1;
        *size = sp->second;
        return ST_OK;
      }
      return ST_NOT_FOUND;
    }
    *sealed = it->second.sealed ? 1 : 0;
    *size = it->second.size;
    return ST_OK;
  }

  void Stats(uint64_t* used, uint64_t* num_objects) {
    std::unique_lock<std::mutex> lk(mu_);
    *used = alloc_.used();
    *num_objects = objects_.size();
  }

  // Full-store audit as one JSON document: an occupancy/fragmentation
  // summary plus one row per resident or spilled object (size, seal
  // state, pin count, create age, idle time) and a capped slice of the
  // eviction tombstones.  Built under the store mutex — the audit is a
  // cold diagnostic path; serializing it against mutations keeps every
  // row a consistent point-in-time snapshot.  Rows beyond `max_rows`
  // are counted, not silently dropped.
  std::string AuditJson(uint64_t max_rows, uint64_t max_tombstones) {
    std::unique_lock<std::mutex> lk(mu_);
    uint64_t now = NowMs();
    uint64_t spilled_bytes = 0;
    for (const auto& kv : spilled_) spilled_bytes += kv.second;
    std::string out;
    out.reserve(256 + 160 * std::min<uint64_t>(
                          max_rows, objects_.size() + spilled_.size()));
    char buf[256];
    snprintf(buf, sizeof(buf),
             "{\"summary\":{\"capacity\":%llu,\"used\":%llu,"
             "\"num_objects\":%llu,\"free_blocks\":%llu,"
             "\"largest_free\":%llu,\"evictions\":%llu,\"spills\":%llu,"
             "\"restores\":%llu,\"spilled_objects\":%llu,"
             "\"spilled_bytes\":%llu,\"tombstones\":%llu},",
             (unsigned long long)alloc_.capacity(),
             (unsigned long long)alloc_.used(),
             (unsigned long long)objects_.size(),
             (unsigned long long)alloc_.free_blocks(),
             (unsigned long long)alloc_.largest_free(),
             (unsigned long long)evictions_, (unsigned long long)spills_,
             (unsigned long long)restores_,
             (unsigned long long)spilled_.size(),
             (unsigned long long)spilled_bytes,
             (unsigned long long)evicted_.size());
    out += buf;
    out += "\"objects\":[";
    uint64_t rows = 0, dropped = 0;
    for (const auto& kv : objects_) {
      const ObjectEntry& e = kv.second;
      if (e.delete_pending) continue;  // logically gone, awaiting Release
      if (rows >= max_rows) {
        dropped++;
        continue;
      }
      snprintf(buf, sizeof(buf),
               "%s{\"id\":\"%s\",\"size\":%llu,\"sealed\":%d,"
               "\"refcount\":%d,\"age_ms\":%llu,\"idle_ms\":%llu,"
               "\"spilled\":0}",
               rows ? "," : "", HexId(kv.first).c_str(),
               (unsigned long long)e.size, e.sealed ? 1 : 0, e.refcount,
               (unsigned long long)(now - std::min(e.create_ms, now)),
               (unsigned long long)(now - std::min(e.last_access_ms, now)));
      out += buf;
      rows++;
    }
    for (const auto& kv : spilled_) {
      if (rows >= max_rows) {
        dropped++;
        continue;
      }
      snprintf(buf, sizeof(buf),
               "%s{\"id\":\"%s\",\"size\":%llu,\"sealed\":1,"
               "\"refcount\":0,\"age_ms\":0,\"idle_ms\":0,\"spilled\":1}",
               rows ? "," : "", HexId(kv.first).c_str(),
               (unsigned long long)kv.second);
      out += buf;
      rows++;
    }
    out += "],\"objects_dropped\":";
    out += std::to_string(dropped);
    out += ",\"tombstone_ids\":[";
    uint64_t nt = 0;
    // newest-first: post-restart leak triage cares about the most recent
    // losses, and the ring can hold up to a million ids
    for (auto it = evicted_order_.rbegin();
         it != evicted_order_.rend() && nt < max_tombstones; ++it, ++nt) {
      if (nt) out += ",";
      out += "\"";
      out += HexId(*it);
      out += "\"";
    }
    out += "]}";
    return out;
  }

 private:
  void DecrefLocked(ObjectEntry& e, const ObjectId& id) {
    if (e.refcount > 0) e.refcount--;
    if (e.refcount == 0 && !e.zombie_extents.empty()) {
      // last pin of any incarnation gone: old extents are now unreferenced
      for (uint64_t off : e.zombie_extents) alloc_.Free(off);
      e.zombie_extents.clear();
    }
    if (e.refcount == 0 && e.delete_pending) {
      if (e.offset != kInvalidOffset) alloc_.Free(e.offset);
      objects_.erase(id);  // e is dangling after this — return at once
      return;
    }
    if (e.refcount == 0 && e.sealed && !e.in_lru) {
      lru_.push_back(id);
      e.lru_it = std::prev(lru_.end());
      e.in_lru = true;
    }
  }

  bool EvictOneLocked() {
    if (lru_.empty()) return false;
    ObjectId victim = lru_.front();
    lru_.pop_front();
    auto it = objects_.find(victim);
    if (it != objects_.end()) {
      it->second.in_lru = false;
      if (!spill_dir_.empty() && SpillLocked(victim, it->second)) {
        // data preserved on disk; a later Get restores transparently
        alloc_.Free(it->second.offset);
        objects_.erase(it);
        spills_++;
        return true;
      }
      alloc_.Free(it->second.offset);
      objects_.erase(it);
      RecordEvictedLocked(victim);
      evictions_++;
    }
    return true;
  }

  static std::string HexId(const ObjectId& id) {
    static const char* kHex = "0123456789abcdef";
    std::string out;
    out.reserve(kIdLen * 2);
    for (uint8_t b : id) {
      out.push_back(kHex[b >> 4]);
      out.push_back(kHex[b & 0xf]);
    }
    return out;
  }

  std::string SpillPath(const ObjectId& id) const {
    return spill_dir_ + "/" + HexId(id);
  }

  // Disk IO under the store mutex: eviction is already the slow path, and
  // serializing spills keeps restore/create races trivially correct.
  bool SpillLocked(const ObjectId& id, const ObjectEntry& e) {
    std::string path = SpillPath(id);
    int fd = open(path.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0600);
    if (fd < 0) return false;
    bool ok = WriteFull(fd, base_ + e.offset, e.size);
    close(fd);
    if (!ok) {
      unlink(path.c_str());
      return false;  // disk full: fall through to lossy eviction
    }
    spilled_[id] = e.size;
    return true;
  }

  uint8_t RestoreLocked(const ObjectId& id) {
    uint64_t size = spilled_[id];
    uint64_t off;
    while (!alloc_.Alloc(size, &off)) {
      if (!EvictOneLocked()) return ST_OOM;
    }
    std::string path = SpillPath(id);
    int fd = open(path.c_str(), O_RDONLY);
    bool ok = fd >= 0 && ReadFull(fd, base_ + off, size);
    if (fd >= 0) close(fd);
    if (!ok) {
      alloc_.Free(off);
      DropSpilledLocked(id);
      RecordEvictedLocked(id);  // spill file lost: surface as evicted
      return ST_EVICTED;
    }
    ObjectEntry e;
    e.offset = off;
    e.size = size;
    e.sealed = true;
    e.refcount = 0;  // Get's fast path takes the caller's ref
    e.create_ms = NowMs();  // restore time: the in-shm age restarts
    e.last_access_ms = e.create_ms;
    objects_[id] = e;
    DropSpilledLocked(id);
    restores_++;
    return ST_OK;
  }

  void DropSpilledLocked(const ObjectId& id) {
    auto it = spilled_.find(id);
    if (it == spilled_.end()) return;
    spilled_.erase(it);
    unlink(SpillPath(id).c_str());
  }

  // Bounded tombstone set so a GET on an evicted object fails fast with
  // ST_EVICTED instead of blocking forever as if the object were pending.
  void RecordEvictedLocked(const ObjectId& id) {
    evicted_.insert(id);
    evicted_order_.push_back(id);
    while (evicted_order_.size() > kMaxTombstones) {
      evicted_.erase(evicted_order_.front());
      evicted_order_.pop_front();
    }
    cv_.notify_all();
  }

  static constexpr size_t kMaxTombstones = 1 << 20;
  // Lifetime pressure counters (monotonic since daemon start; a restart
  // zeroes them, which the incarnation bump already makes visible).
  uint64_t evictions_ = 0;  // lossy evictions (data dropped, tombstoned)
  uint64_t spills_ = 0;     // evictions that preserved data on disk
  uint64_t restores_ = 0;   // spilled objects pulled back into shm
  std::mutex mu_;
  std::condition_variable cv_;
  FreeListAllocator alloc_;
  uint8_t* base_;            // daemon-side mapping (spill/restore IO)
  std::string spill_dir_;    // empty = spilling disabled
  std::unordered_map<ObjectId, ObjectEntry, IdHash> objects_;
  std::unordered_map<ObjectId, uint64_t, IdHash> spilled_;  // id -> size
  std::list<ObjectId> lru_;  // sealed, refcount==0, eviction candidates
  std::unordered_set<ObjectId, IdHash> evicted_;
  std::deque<ObjectId> evicted_order_;
};

bool ReadFull(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Consume n payload bytes to keep the request stream framed after a
// failed PUT (the client already committed to sending them).
bool DrainBytes(int fd, uint64_t n) {
  char buf[4096];
  while (n > 0) {
    size_t want = n < sizeof buf ? size_t(n) : sizeof buf;
    ssize_t r = read(fd, buf, want);
    if (r <= 0) return false;
    n -= uint64_t(r);
  }
  return true;
}

// ---------------------------------------------------------------------
// Daemon-to-daemon object transfer (TCP peer plane).
//
// TPU-native redesign of the reference object manager
// (Ray's src/ray/object_manager/object_manager.h:53,132 —
// chunked gRPC Push/Pull through an ObjectBufferPool): here the two
// store daemons stream the extent DIRECTLY between their shm segments
// over one TCP connection — sender reads from its mapping, receiver
// writes into a freshly created extent — so there is no chunk buffer
// pool because there are no intermediate buffers at all, and no Python
// byte ever touches the data plane.  Policy (location lookup, retry,
// ban, dedup) stays host-side; see _private/object_transfer.py.
//
// Peer wire protocol (connector speaks first):
//   auth:    u8 token_len | token bytes
//   request: u8 xfer_op | u8[20] object_id
//   XFER_PULL: response u8 status | u64 size | payload bytes
//   XFER_PUSH: request continues u64 size; response u8 status; on OK the
//              connector streams the payload, then reads u8 final status.
// ---------------------------------------------------------------------

std::string g_xfer_token;  // RTPU_STORE_TOKEN (empty = no auth)
// flag-registry tunable (RTPU_XFER_TIMEOUT_S, _private/flags.py)
int g_xfer_timeout_s = [] {
  const char* v = getenv("RTPU_XFER_TIMEOUT_S");
  if (!v || !*v) return 30;
  char* end = nullptr;
  long n = strtol(v, &end, 10);
  // garbage/non-positive would mean timeval{0,0} = NO timeout — the
  // opposite of intent; fall back to the default instead
  return (end && *end == '\0' && n > 0) ? int(n) : 30;
}();
// flag-registry tunable (RTPU_TRANSFER_STRIPES): parallel range streams
// per large pull.  Clamped — each stripe is a thread + connection on the
// responder too, so an unbounded value is a self-DoS knob.
int g_xfer_stripes = [] {
  const char* v = getenv("RTPU_TRANSFER_STRIPES");
  if (!v || !*v) return 4;
  char* end = nullptr;
  long n = strtol(v, &end, 10);
  if (!end || *end != '\0' || n < 1) return 4;
  return n > 16 ? 16 : int(n);
}();
// Objects below this pull over the single probe connection; striping's
// extra dials + thread spawns only pay off once per-stream cost matters.
constexpr uint64_t kStripeMin = 1 << 20;

void SetSockTimeouts(int fd) {
  timeval tv{g_xfer_timeout_s, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
}

// One peer request per connection (transfers are large; setup cost is
// noise, and per-connection framing keeps failure recovery trivial).
void ServeTransferPeer(Store* store, uint8_t* base, int fd) {
  SetSockTimeouts(fd);
  uint8_t tl = 0;
  if (!ReadFull(fd, &tl, 1)) { close(fd); return; }
  std::string token(tl, '\0');
  if (tl && !ReadFull(fd, token.data(), tl)) { close(fd); return; }
  if (token != g_xfer_token) { close(fd); return; }
  uint8_t hdr[1 + kIdLen];
  if (!ReadFull(fd, hdr, sizeof hdr)) { close(fd); return; }
  ObjectId id;
  memcpy(id.data(), hdr + 1, kIdLen);
  if (hdr[0] == XFER_PULL) {
    uint64_t off = 0, size = 0;
    uint8_t status = store->Get(id, 0, &off, &size);  // non-blocking probe
    uint8_t resp[1 + 8];
    resp[0] = status;
    memcpy(resp + 1, &size, 8);
    if (status != ST_OK) {
      WriteFull(fd, resp, sizeof resp);
      close(fd);
      return;
    }
    // pin held across the stream: the extent cannot be evicted under us
    bool ok = WriteFull(fd, resp, sizeof resp) &&
              WriteFull(fd, base + off, size);
    (void)ok;
    store->Release(id);
  } else if (hdr[0] == XFER_PULL_RANGE) {
    // <u64 offset | u64 length> follows; response echoes the TOTAL size
    // so the puller can cross-check every stripe against the incarnation
    // it probed (a recreate between ranges would otherwise interleave
    // two objects' bytes).  length 0 = probe: header only, no payload.
    uint64_t range[2];
    if (!ReadFull(fd, range, sizeof range)) { close(fd); return; }
    uint64_t off = 0, size = 0;
    uint8_t status = store->Get(id, 0, &off, &size);
    uint8_t resp[1 + 8];
    resp[0] = status;
    memcpy(resp + 1, &size, 8);
    if (status != ST_OK) {
      WriteFull(fd, resp, sizeof resp);
      close(fd);
      return;
    }
    uint64_t roff = range[0];
    uint64_t rlen = roff > size ? 0 : range[1];
    if (rlen > size - roff) rlen = size - roff;
    // pin held across the range stream, like full XFER_PULL
    bool ok = WriteFull(fd, resp, sizeof resp) &&
              (rlen == 0 || WriteFull(fd, base + off + roff, rlen));
    (void)ok;
    store->Release(id);
  } else if (hdr[0] == XFER_PUSH) {
    uint64_t size = 0;
    if (!ReadFull(fd, &size, 8)) { close(fd); return; }
    uint64_t off = 0;
    uint8_t status = store->Create(id, size, &off);
    if (status == ST_EXISTS) {
      // only report "already have it" when the copy is SEALED; an
      // unsealed husk from a dying concurrent transfer is ST_ERR so
      // the sender does not count the push as delivered
      uint64_t sealed = 0, sz = 0;
      if (!(store->Contains(id, &sealed, &sz) == ST_OK && sealed))
        status = ST_ERR;
    }
    uint8_t st_byte = status;
    if (!WriteFull(fd, &st_byte, 1) || status != ST_OK) {
      close(fd);  // EXISTS/OOM: decline — the sender stops, no stream
      return;
    }
    if (!ReadFull(fd, base + off, size)) {
      store->Abort(id);  // half-written push: never leave a husk
      close(fd);
      return;
    }
    store->Seal(id);
    st_byte = ST_OK;
    WriteFull(fd, &st_byte, 1);
  }
  close(fd);
}

int DialPeer(const std::string& host, uint16_t port) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_s = std::to_string(port);
  if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0)
    return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    SetSockTimeouts(fd);
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  return fd;
}

bool SendAuthAndHeader(int fd, uint8_t op, const ObjectId& id) {
  std::string pre;
  pre.push_back(char(uint8_t(g_xfer_token.size())));
  pre += g_xfer_token;
  pre.push_back(char(op));
  pre.append(reinterpret_cast<const char*>(id.data()), kIdLen);
  return WriteFull(fd, pre.data(), pre.size());
}

// One stripe of a striped pull: dial its own connection, request
// [roff, roff+rlen) of id, and land the bytes directly at dst.  The
// responder echoes the object's TOTAL size in every range response; a
// mismatch against the size the probe saw means the object was deleted
// and recreated between stripes, so the stripe must fail rather than
// splice two incarnations' bytes together.
bool PullRange(const std::string& host, uint16_t port, const ObjectId& id,
               uint64_t expect_size, uint64_t roff, uint64_t rlen,
               uint8_t* dst) {
  int fd = DialPeer(host, port);
  if (fd < 0) return false;
  bool ok = false;
  uint64_t range[2] = {roff, rlen};
  uint8_t resp[1 + 8];
  if (SendAuthAndHeader(fd, XFER_PULL_RANGE, id) &&
      WriteFull(fd, range, sizeof range) &&
      ReadFull(fd, resp, sizeof resp)) {
    uint64_t total = 0;
    memcpy(&total, resp + 1, 8);
    if (resp[0] == ST_OK && total == expect_size)
      ok = ReadFull(fd, dst, rlen);
  }
  close(fd);
  return ok;
}

// Local client asked us to PULL id from a peer daemon straight into our
// segment.  Returns (status, size).
//
// The first connection doubles as the size probe: it requests range
// [0, kStripeMin) and the response header carries the total size.  Small
// objects therefore complete on that single connection with the same
// round-trip count as the old whole-object pull; larger ones fan the
// remainder out over g_xfer_stripes parallel range connections, all
// writing into the one pre-created extent, sealed only once every
// stripe lands (any failure aborts — never a half-written husk).
std::pair<uint8_t, uint64_t> PullFromPeer(Store* store, uint8_t* base,
                                          const ObjectId& id,
                                          const std::string& host,
                                          uint16_t port) {
  {
    uint64_t sealed = 0, size = 0;
    if (store->Contains(id, &sealed, &size) == ST_OK && sealed)
      return {ST_OK, size};  // raced: already local
  }
  int fd = DialPeer(host, port);
  if (fd < 0) return {ST_ERR, 0};
  uint64_t first_range[2] = {0, kStripeMin};
  if (!SendAuthAndHeader(fd, XFER_PULL_RANGE, id) ||
      !WriteFull(fd, first_range, sizeof first_range)) {
    close(fd);
    return {ST_ERR, 0};
  }
  uint8_t resp[1 + 8];
  if (!ReadFull(fd, resp, sizeof resp)) { close(fd); return {ST_ERR, 0}; }
  uint64_t size = 0;
  memcpy(&size, resp + 1, 8);
  if (resp[0] != ST_OK) { close(fd); return {resp[0], 0}; }
  uint64_t off = 0;
  uint8_t status = store->Create(id, size, &off);
  if (status == ST_EXISTS) {
    close(fd);  // concurrent pull/compute won; drop the stream —
    // but only claim success if that copy is actually SEALED (a
    // half-written concurrent transfer that later aborts must not
    // let us advertise a location we do not hold)
    uint64_t sealed = 0, sz = 0;
    if (store->Contains(id, &sealed, &sz) == ST_OK && sealed)
      return {ST_OK, sz};
    return {ST_NOT_SEALED, 0};
  }
  if (status != ST_OK) { close(fd); return {status, 0}; }
  uint64_t first_len = size < kStripeMin ? size : kStripeMin;
  if (!ReadFull(fd, base + off, first_len)) {
    store->Abort(id);
    close(fd);
    return {ST_ERR, 0};
  }
  close(fd);
  uint64_t rest = size - first_len;
  if (rest > 0) {
    int nstripes = g_xfer_stripes;
    uint64_t per = (rest + nstripes - 1) / uint64_t(nstripes);
    std::atomic<bool> failed{false};
    std::vector<std::thread> threads;
    for (uint64_t o = first_len; o < size; o += per) {
      uint64_t len = size - o < per ? size - o : per;
      threads.emplace_back([&, o, len] {
        if (!PullRange(host, port, id, size, o, len, base + off + o))
          failed.store(true, std::memory_order_relaxed);
      });
    }
    for (auto& t : threads) t.join();
    if (failed.load(std::memory_order_relaxed)) {
      store->Abort(id);
      return {ST_ERR, 0};
    }
  }
  store->Seal(id);
  return {ST_OK, size};
}

// Local client asked us to PUSH a sealed local object to a peer daemon.
uint8_t PushToPeer(Store* store, uint8_t* base, const ObjectId& id,
                   const std::string& host, uint16_t port) {
  uint64_t off = 0, size = 0;
  uint8_t status = store->Get(id, 0, &off, &size);
  if (status != ST_OK) return status;  // evicted since scheduling the push
  int fd = DialPeer(host, port);
  if (fd < 0) { store->Release(id); return ST_ERR; }
  uint8_t final_st = ST_ERR;
  if (SendAuthAndHeader(fd, XFER_PUSH, id) &&
      WriteFull(fd, &size, 8)) {
    uint8_t st = ST_ERR;
    if (ReadFull(fd, &st, 1)) {
      if (st == ST_OK) {
        if (WriteFull(fd, base + off, size) && ReadFull(fd, &st, 1))
          final_st = st;
      } else if (st == ST_EXISTS) {
        final_st = ST_OK;  // receiver already has it: push satisfied
      }
    }
  }
  close(fd);
  store->Release(id);
  return final_st;
}

void TransferListener(Store* store, uint8_t* base, int srv_fd) {
  for (;;) {
    int fd = accept(srv_fd, nullptr, nullptr);
    if (fd < 0) {
      // persistent failure (EMFILE under transfer fan-in): back off
      // instead of busy-spinning the core the daemon shares with its
      // own client threads
      if (errno != EINTR) usleep(10'000);
      continue;
    }
    // an escaped exception in a detached thread is std::terminate for the
    // whole daemon — contain per-connection failures to their connection
    std::thread([store, base, fd] {
      try {
        ServeTransferPeer(store, base, fd);
      } catch (...) {
        close(fd);
      }
    }).detach();
  }
}

// ---- store chaos (testing) -------------------------------------------------
// RTPU_TESTING_STORE_FAILURE="<drop%>:<kill%>": before serving each client
// request the daemon rolls once; drop% closes the offending connection (the
// client sees a reset mid-op and must reconnect-retry), kill% _exit(1)s the
// whole daemon (the node supervisor must restart it and lineage must rebuild
// the lost contents).  Mirrors the RPC chaos flag in _private/protocol.py.
int g_chaos_drop_pct = 0;
int g_chaos_kill_pct = 0;
std::mutex g_chaos_mu;
std::mt19937 g_chaos_rng;

void InitChaos() {
  const char* spec = getenv("RTPU_TESTING_STORE_FAILURE");
  if (!spec || !*spec) return;
  int drop = 0, kill_pct = 0;
  if (sscanf(spec, "%d:%d", &drop, &kill_pct) < 1) return;
  g_chaos_drop_pct = drop < 0 ? 0 : drop;
  g_chaos_kill_pct = kill_pct < 0 ? 0 : kill_pct;
  unsigned seed = static_cast<unsigned>(getpid());
  if (const char* s = getenv("RTPU_TESTING_STORE_SEED"))
    seed = static_cast<unsigned>(strtoul(s, nullptr, 10));
  g_chaos_rng.seed(seed);
}

// 0 = proceed, 1 = drop this connection (may not return at all: kill).
int ChaosGate() {
  if (g_chaos_drop_pct == 0 && g_chaos_kill_pct == 0) return 0;
  int roll;
  {
    std::lock_guard<std::mutex> lk(g_chaos_mu);
    roll = static_cast<int>(g_chaos_rng() % 100);
  }
  if (roll < g_chaos_kill_pct) {
    fprintf(stderr, "[shm_store] chaos: killing daemon\n");
    _exit(1);
  }
  if (roll < g_chaos_kill_pct + g_chaos_drop_pct) return 1;
  return 0;
}

// Per-client (not per-connection) ref bookkeeping: a client process may pool
// several sockets, so a GET on one connection can be RELEASEd on another.
// Pins are reclaimed when the client's last connection closes.
//
// Sharded locking: each ClientState carries its own mutex for the hot
// per-op bookkeeping (GET/RELEASE/CREATE/SEAL), so N clients' traffic
// never cross-serializes on one global lock.  g_clients_mu guards only
// map membership and the conns count — taken once per connection at
// handshake/teardown, never per op.
struct ClientState {
  std::mutex mu;  // guards held + creating
  int conns = 0;  // guarded by g_clients_mu
  std::unordered_map<ObjectId, int, IdHash> held;
  std::unordered_map<ObjectId, bool, IdHash> creating;  // unsealed creates
};

std::mutex g_clients_mu;
std::unordered_map<ObjectId, std::shared_ptr<ClientState>, IdHash> g_clients;

void ServeClient(Store* store, uint8_t* base, int fd) {
  uint8_t req[kReqLen];
  bool conn_broken = false;
  // Handshake: first 20 bytes are the client id.
  ObjectId client_id;
  if (!ReadFull(fd, client_id.data(), kIdLen)) {
    close(fd);
    return;
  }
  std::shared_ptr<ClientState> cs;
  {
    std::lock_guard<std::mutex> lk(g_clients_mu);
    auto& slot = g_clients[client_id];
    if (!slot) slot = std::make_shared<ClientState>();
    slot->conns++;
    cs = slot;
  }
  while (ReadFull(fd, req, kReqLen)) {
    if (ChaosGate()) break;
    uint8_t op = req[0];
    ObjectId id;
    memcpy(id.data(), req + 1, kIdLen);
    uint64_t arg0, arg1;
    memcpy(&arg0, req + 1 + kIdLen, 8);
    memcpy(&arg1, req + 1 + kIdLen + 8, 8);

    uint8_t status = ST_ERR;
    uint64_t r0 = 0, r1 = 0;
    switch (op) {
      case OP_CREATE:
        if (arg0 > store->Capacity()) {
          status = ST_OOM;  // can never fit: reject without eviction churn
          break;
        }
        status = store->Create(id, arg0, &r0);
        if (status == ST_OK) {
          std::lock_guard<std::mutex> lk(cs->mu);
          cs->creating[id] = true;
        }
        r1 = arg0;
        break;
      case OP_SEAL:
        status = store->Seal(id);
        if (status == ST_OK) {
          std::lock_guard<std::mutex> lk(cs->mu);
          cs->creating.erase(id);
        }
        break;
      case OP_GET:
        status = store->Get(id, arg0, &r0, &r1);
        if (status == ST_OK) {
          std::lock_guard<std::mutex> lk(cs->mu);
          cs->held[id]++;
        }
        break;
      case OP_RELEASE:
        status = store->Release(id);
        if (status == ST_OK) {
          std::lock_guard<std::mutex> lk(cs->mu);
          auto it = cs->held.find(id);
          if (it != cs->held.end() && --it->second <= 0) cs->held.erase(it);
        }
        break;
      case OP_DELETE:
        status = store->Delete(id);
        break;
      case OP_CONTAINS:
        status = store->Contains(id, &r0, &r1);
        break;
      case OP_STATS:
        store->Stats(&r0, &r1);
        status = ST_OK;
        break;
      case OP_ABORT:
        status = store->Abort(id);
        break;
      case OP_PUT: {
        // create + payload copy + seal in one round trip (arg0 = size)
        if (arg0 > store->Capacity()) {
          // can never fit — and draining a hostile multi-GB claimed size
          // would stall this thread; reply and drop the connection (the
          // unread payload poisons the framing)
          uint8_t resp[kRespLen] = {ST_OOM};
          WriteFull(fd, resp, kRespLen);
          conn_broken = true;
          break;
        }
        status = store->Create(id, arg0, &r0);
        if (status == ST_OK) {
          if (!ReadFull(fd, base + r0, arg0)) {
            store->Abort(id);
            conn_broken = true;
            break;
          }
          status = store->Seal(id);
        } else if (!DrainBytes(fd, arg0)) {
          conn_broken = true;
          break;
        }
        r1 = arg0;
        break;
      }
      case OP_PULL:
      case OP_PUSH: {
        // arg0 = addr payload length; payload is "host:port".  The
        // transfer runs in THIS connection's thread — the client checked
        // the conn out of its pool, so control traffic on other conns is
        // never head-of-line-blocked by a large transfer.
        if (arg0 > kMaxAddrLen) {
          // corrupt/hostile length: never allocate it (bad_alloc in a
          // detached thread is std::terminate); answer and drop the conn
          uint8_t resp[kRespLen] = {ST_ERR};
          WriteFull(fd, resp, kRespLen);
          conn_broken = true;
          break;
        }
        std::string addr(arg0, '\0');
        if (!ReadFull(fd, addr.data(), arg0)) {
          conn_broken = true;
          break;
        }
        size_t colon = addr.rfind(':');
        if (colon == std::string::npos) {
          status = ST_ERR;
          break;
        }
        std::string host = addr.substr(0, colon);
        uint16_t port = uint16_t(strtoul(addr.c_str() + colon + 1,
                                         nullptr, 10));
        if (op == OP_PULL) {
          auto [st, sz] = PullFromPeer(store, base, id, host, port);
          status = st;
          r1 = sz;
        } else {
          status = PushToPeer(store, base, id, host, port);
        }
        break;
      }
      case OP_AUDIT: {
        // arg0 = max object rows, arg1 = max tombstone ids.  Response is
        // the 17-byte header (r0 = payload length, r1 = resident object
        // count) followed by the JSON payload — the same variable-length
        // framing as an inline GET, so it rides the existing socket pool.
        uint64_t used = 0, nobj = 0;
        store->Stats(&used, &nobj);
        std::string payload = store->AuditJson(
            std::min<uint64_t>(arg0, 1u << 20),
            std::min<uint64_t>(arg1, 1u << 20));
        r0 = payload.size();
        r1 = nobj;
        uint8_t resp[kRespLen];
        resp[0] = ST_OK;
        memcpy(resp + 1, &r0, 8);
        memcpy(resp + 1 + 8, &r1, 8);
        if (!WriteFull(fd, resp, kRespLen) ||
            !WriteFull(fd, payload.data(), payload.size()))
          conn_broken = true;
        continue;  // response already written
      }
      case OP_GET_INLINE: {
        // arg0 = timeout_ms, arg1 = client's inline size cap
        status = store->Get(id, arg0, &r0, &r1);
        if (status == ST_OK) {
          uint64_t off = r0, sz = r1;
          if (sz <= arg1) {
            r0 = 1;
            uint8_t resp[kRespLen];
            resp[0] = status;
            memcpy(resp + 1, &r0, 8);
            memcpy(resp + 1 + 8, &r1, 8);
            // copy while pinned, then drop the pin — the client gets
            // bytes, not a view, so there is nothing to RELEASE later
            bool ok = WriteFull(fd, resp, kRespLen) &&
                      WriteFull(fd, base + off, sz);
            store->Release(id);
            if (!ok) conn_broken = true;
            continue;  // response already written
          }
          // too big for inline: KEEP the pin and hand back the extent —
          // the client maps its zero-copy view from (offset, size) with
          // no second GET round trip; it owes a RELEASE like plain GET
          status = ST_VIEW;
          {
            std::lock_guard<std::mutex> lk(cs->mu);
            cs->held[id]++;
          }
        }
        break;
      }
      default:
        status = ST_ERR;
    }
    if (conn_broken) break;
    uint8_t resp[kRespLen];
    resp[0] = status;
    memcpy(resp + 1, &r0, 8);
    memcpy(resp + 1 + 8, &r1, 8);
    if (!WriteFull(fd, resp, kRespLen)) break;
  }
  // Connection closed: if this was the client's last connection, release its
  // leaked pins and abort half-written creates.
  bool last_conn = false;
  {
    std::lock_guard<std::mutex> lk(g_clients_mu);
    auto it = g_clients.find(client_id);
    if (it != g_clients.end() && it->second == cs && --cs->conns == 0) {
      g_clients.erase(it);
      last_conn = true;
    }
  }
  if (last_conn) {
    // cs is now unreachable from the map, but a racing op on another
    // (already-drained) connection could still hold cs->mu — swap the
    // books out under it rather than reading them unlocked.
    std::unordered_map<ObjectId, int, IdHash> held;
    std::unordered_map<ObjectId, bool, IdHash> creating;
    {
      std::lock_guard<std::mutex> lk(cs->mu);
      held.swap(cs->held);
      creating.swap(cs->creating);
    }
    for (auto& kv : held)
      for (int i = 0; i < kv.second; i++) store->Release(kv.first);
    for (auto& kv : creating) store->Abort(kv.first);
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4 || argc > 6) {
    fprintf(stderr,
            "usage: %s <socket_path> <shm_name> <capacity_bytes> "
            "[spill_dir] [xfer_host]\n",
            argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  InitChaos();
  const char* sock_path = argv[1];
  const char* shm_name = argv[2];
  uint64_t capacity = strtoull(argv[3], nullptr, 10);
  std::string spill_dir = argc >= 5 ? argv[4] : "";
  // Optional TCP transfer listener (daemon-to-daemon data plane): bind
  // an ephemeral port on xfer_host; the chosen port rides the READY
  // line.  Auth token comes via env, never argv (ps-visible).
  std::string xfer_host = argc == 6 ? argv[5] : "";
  if (const char* tok = getenv("RTPU_STORE_TOKEN")) g_xfer_token = tok;

  // Create + size the shared memory segment.
  shm_unlink(shm_name);
  int shm_fd = shm_open(shm_name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (shm_fd < 0) {
    perror("shm_open");
    return 1;
  }
  if (ftruncate(shm_fd, static_cast<off_t>(capacity)) != 0) {
    perror("ftruncate");
    return 1;
  }
  // The daemon maps the segment too: spilling reads object bytes out and
  // restore writes them back (clients still address by offset).
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED,
                    shm_fd, 0);
  close(shm_fd);
  if (base == MAP_FAILED) {
    perror("mmap");
    return 1;
  }
  if (!spill_dir.empty()) {
    mkdir(spill_dir.c_str(), 0700);  // EEXIST fine
  }

  Store store(capacity, static_cast<uint8_t*>(base), spill_dir);

  unlink(sock_path);
  int srv = socket(AF_UNIX, SOCK_STREAM, 0);
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  strncpy(addr.sun_path, sock_path, sizeof(addr.sun_path) - 1);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(srv, 128);

  int xfer_port = 0;
  if (!xfer_host.empty()) {
    int tsrv = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(tsrv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in tin{};
    tin.sin_family = AF_INET;
    tin.sin_port = 0;  // ephemeral
    if (inet_pton(AF_INET, xfer_host.c_str(), &tin.sin_addr) != 1)
      tin.sin_addr.s_addr = htonl(INADDR_ANY);
    if (bind(tsrv, reinterpret_cast<sockaddr*>(&tin), sizeof tin) == 0 &&
        listen(tsrv, 64) == 0) {
      sockaddr_in got{};
      socklen_t glen = sizeof got;
      getsockname(tsrv, reinterpret_cast<sockaddr*>(&got), &glen);
      xfer_port = ntohs(got.sin_port);
      std::thread(TransferListener, &store, static_cast<uint8_t*>(base),
                  tsrv)
          .detach();
    } else {
      close(tsrv);
    }
  }

  // Signal readiness (+ transfer port) on stdout for the parent bootstrap.
  printf("READY %d\n", xfer_port);
  fflush(stdout);

  for (;;) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) {
      if (errno != EINTR) usleep(10'000);  // EMFILE: no busy-spin
      continue;
    }
    std::thread([&store, base, fd] {
      try {
        ServeClient(&store, static_cast<uint8_t*>(base), fd);
      } catch (...) {
        // never let a per-connection failure std::terminate the daemon;
        // the client observes a reset and reconnect-retries
        close(fd);
      }
    }).detach();
  }
  return 0;
}
