// ray_tpu_torch C++ worker API.
//
// Counterpart of Ray's C++ worker (Ray's cpp/include/ray/api/*.h:
// ray::Init, ray::Get/Put, actor handles), scaled to the port runtime's
// protocols: the client speaks
//
//   * the versioned wire codec (ray_tpu_torch/native/wire.h) to the GCS:
//     KV, node listing, actor registry, exactly like a Python node;
//   * the binary direct-call dialect (0x01 call / 0x02 reply frames,
//     ray_tpu_torch/_private/direct.py) to actor workers, with method
//     arguments encoded as a plain-data pickle the Python side unpickles
//     natively and results decoded from the store payload format
//     (ray_tpu_torch/_private/serialization.py: pickle subset, raw array
//     or raw tensor tag).
//
// Values cross the boundary as wire::Value (None/bool/int/float/str/
// bytes/list/dict/tuple), the plain-data subset.  Tasks defined in C++
// are out of scope (the runtime executes Python functions); what this API
// gives a C++ process is full *client* standing: cluster state, KV
// coordination, and calling into any named Python actor.
//
// Arrays and tensors a method returns.  A numpy array (store tag 2) and a
// torch tensor (tag 3) both decode into the same dict:
//   {"dtype": str, "shape": tuple of int, "data": bytes}
// where "dtype" is numpy's dtype string for an array ("<f4") and torch's
// dtype name for a tensor ("float32", "bfloat16"), and "data" holds the
// raw bytes in C order (a bfloat16 element is its 2 bytes, little-endian).
// A CUDA tensor reaches C++ as tag 3 bytes that the actor copied from the
// device: the binary call frame has no slot for a tensor transport, so a
// call from C++ never leaves a device-resident object behind.  A result
// the direct-call reply carries inline (up to the actor's inline cap,
// 100 KiB by default) is decoded; a larger one goes to the store
// (CallResult::in_store) and is out of reach of this client.  A method
// that returns a device-object marker or an ObjectRef (a value living in
// another process) yields !ok with an error naming it, never its bytes.
//
// Build (no extra deps; ray_tpu_torch/cpp/build.py does this on first use),
// one command line:
//   g++ -std=c++17 -O2 -I<repo>/ray_tpu_torch/native
//       -I<repo>/ray_tpu_torch/cpp/include
//       <repo>/ray_tpu_torch/cpp/src/client.cc your_app.cc -o your_app

#pragma once

#include <cstdint>
#include <memory>
#include <optional>
#include <string>
#include <vector>

#include "wire.h"

namespace rtpu {

// One framed connection (4-byte LE length prefix), with the cluster-token
// handshake on TCP addresses ("host:port" or "token@host:port").
class Connection {
 public:
  ~Connection();
  static std::unique_ptr<Connection> Dial(const std::string& addr,
                                          const std::string& token = "");
  bool SendFrame(const std::string& body);
  // nullopt on EOF/error.
  std::optional<std::string> RecvFrame();
  bool ok() const { return fd_ >= 0; }

 private:
  explicit Connection(int fd) : fd_(fd) {}
  int fd_ = -1;
};

struct NodeInfo {
  std::string node_id;  // raw bytes
  bool alive = false;
  bool is_head = false;
  std::string store_socket;  // node-local shm store daemon (unix path)
};

struct ActorInfo {
  std::string actor_id;  // raw bytes
  std::string state;     // "ALIVE" | ...
  std::string addr;      // direct-call endpoint ("" until ALIVE)
  std::string class_name;
};

// The result of an actor method call.
struct CallResult {
  bool ok = false;          // method returned without raising
  wire::Value value;        // decoded return (plain-data subset)
  bool in_store = false;    // large result went to the shm store (value
                            // empty; fetch via a Python peer)
  bool raw = false;         // payload could not be decoded into the
                            // subset; bytes kept verbatim in `value`
                            // (a device-object marker or an ObjectRef
                            // is an error instead: ok false, see above)
  std::string error;        // transport or remote-exception description
};

// A direct channel to one actor (per-caller FIFO, like any Python caller).
class ActorHandle {
 public:
  ActorHandle(ActorInfo info, std::unique_ptr<Connection> conn)
      : info_(std::move(info)), conn_(std::move(conn)) {}

  const ActorInfo& info() const { return info_; }

  // Blocking call: pickles `args`, pushes a 0x01 frame, waits for the
  // matching 0x02 reply (out-of-order replies for earlier in-flight calls
  // are drained in order — the channel is FIFO).
  CallResult Call(const std::string& method,
                  const std::vector<wire::Value>& args);

 private:
  ActorInfo info_;
  std::unique_ptr<Connection> conn_;
  uint64_t seq_ = 0;
};

class Client {
 public:
  // addr: the GCS address (unix path, "host:port", or "token@host:port").
  static std::unique_ptr<Client> Connect(const std::string& addr);

  // -- KV (GCS kv table, shared with Python ray_tpu_torch) --------------
  bool KvPut(const std::string& ns, const std::string& key,
             const std::string& value);
  std::optional<std::string> KvGet(const std::string& ns,
                                   const std::string& key);
  bool KvDel(const std::string& ns, const std::string& key);
  std::vector<std::string> KvKeys(const std::string& ns);

  // -- cluster state ----------------------------------------------------
  std::vector<NodeInfo> ListNodes();

  // -- actors ------------------------------------------------------------
  std::optional<ActorInfo> GetActorByName(const std::string& name);
  // Resolve + open a direct channel; nullptr when the actor is not ALIVE.
  std::unique_ptr<ActorHandle> GetActorHandle(const std::string& name);

  // -- objects -----------------------------------------------------------
  // Put/Get against the LOCAL node's shm store daemon (the first alive
  // node whose store socket exists on this host), in the framework's
  // store payload format (TAG_PICKLE + plain-data pickle): Python
  // ray_tpu_torch.get() reads C++ puts and vice versa.  Put publishes the
  // object's location to the GCS directory so remote nodes can pull it.
  // Returns the 20-byte object id ("" on failure).
  std::string Put(const wire::Value& value);
  // Get by object id; nullopt on miss/timeout, throws std::runtime_error
  // for stored errors or non-plain-data payloads (arrays and tensors:
  // only an actor call's reply decodes those).
  std::optional<wire::Value> Get(const std::string& object_id,
                                 int timeout_ms = 10000);

  // One wire-codec RPC against the GCS (public: escape hatch for methods
  // without a typed wrapper).  Throws wire::WireError on protocol errors,
  // std::runtime_error on a remote error response.
  wire::Value CallGcs(const std::string& method,
                      const std::vector<wire::Value>& args);

  ~Client();

 private:
  Client(std::unique_ptr<Connection> conn, std::string token)
      : conn_(std::move(conn)), token_(std::move(token)) {}
  // one persistent store-daemon connection, resolved+dialed on first
  // Put/Get and reused (the daemon's OP_PUT/GET_INLINE are one round
  // trip; re-resolving the socket and re-handshaking per call would
  // triple it).  Re-dialed transparently after a drop.
  int store_conn();
  std::unique_ptr<Connection> conn_;
  std::string token_;
  std::string store_sock_;
  std::string store_node_;
  int store_fd_ = -1;
};

// Plain-data pickle codec (exposed for tests).
// Pickles (list(args), {}) the way actor args travel.
std::string PickleArgs(const std::vector<wire::Value>& args);
// Decode a pickle of plain data into the wire::Value subset.  Returns
// false when the stream uses opcodes outside the subset.
bool UnpickleValue(const std::string& data, wire::Value* out);
bool UnpickleValue(const char* data, size_t n, wire::Value* out);

}  // namespace rtpu
