// ray_tpu_torch C++ worker API implementation.  See
// ray_tpu_torch/cpp/include/ray_tpu_torch/client.h.
//
// Reference counterpart: Ray's cpp/src/ray/runtime/ (the C++ worker
// runtime over the core worker).  Here the client rides the same two
// protocols every Python process of the port uses: the wire codec to the
// GCS and the binary direct-call dialect to actor workers.

#include "ray_tpu_torch/client.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdlib>
#include <random>
#include <stdexcept>

namespace rtpu {

namespace {

bool send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += k;
    n -= size_t(k);
  }
  return true;
}

bool recv_all(int fd, char* p, size_t n) {
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

// "token@host:port" -> (token, host, port); unix paths pass through.
struct Addr {
  bool tcp = false;
  std::string token;
  std::string host;  // or unix path
  int port = 0;
};

Addr parse_addr(const std::string& raw, const std::string& fallback_token) {
  Addr a;
  std::string rest = raw;
  auto at = raw.rfind('@');
  if (at != std::string::npos && raw[0] != '/') {
    a.token = raw.substr(0, at);
    rest = raw.substr(at + 1);
  } else {
    a.token = fallback_token;
  }
  if (!rest.empty() && (rest[0] == '/' || rest[0] == '.')) {
    a.host = rest;
    return a;
  }
  auto colon = rest.rfind(':');
  if (colon == std::string::npos) {
    a.host = rest;
    return a;
  }
  std::string port_s = rest.substr(colon + 1);
  if (port_s.empty() ||
      port_s.find_first_not_of("0123456789") != std::string::npos) {
    a.host = rest;  // not host:port after all
    return a;
  }
  a.tcp = true;
  a.host = rest.substr(0, colon);
  if (!a.host.empty() && a.host.front() == '[' && a.host.back() == ']')
    a.host = a.host.substr(1, a.host.size() - 2);
  a.port = std::atoi(port_s.c_str());
  return a;
}

std::string env_token() {
  const char* t = std::getenv("RTPU_CLUSTER_TOKEN");
  return t ? t : "";
}

}  // namespace

// ---------------------------------------------------------------------------
// Connection
// ---------------------------------------------------------------------------

Connection::~Connection() {
  if (fd_ >= 0) ::close(fd_);
}

std::unique_ptr<Connection> Connection::Dial(const std::string& addr,
                                             const std::string& token) {
  Addr a = parse_addr(addr, token.empty() ? env_token() : token);
  int fd = -1;
  if (a.tcp) {
    struct addrinfo hints {};
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(a.port);
    if (getaddrinfo(a.host.c_str(), port_s.c_str(), &hints, &res) != 0)
      return nullptr;
    for (auto* p = res; p; p = p->ai_next) {
      fd = ::socket(p->ai_family, p->ai_socktype, p->ai_protocol);
      if (fd < 0) continue;
      if (::connect(fd, p->ai_addr, p->ai_addrlen) == 0) break;
      ::close(fd);
      fd = -1;
    }
    freeaddrinfo(res);
  } else {
    fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    struct sockaddr_un sa {};
    sa.sun_family = AF_UNIX;
    if (a.host.size() >= sizeof(sa.sun_path)) {
      ::close(fd);
      return nullptr;
    }
    memcpy(sa.sun_path, a.host.c_str(), a.host.size() + 1);
    if (::connect(fd, (struct sockaddr*)&sa, sizeof(sa)) != 0) {
      ::close(fd);
      return nullptr;
    }
  }
  if (fd < 0) return nullptr;
  auto conn = std::unique_ptr<Connection>(new Connection(fd));
  if (a.tcp) {
    // cluster-token handshake (protocol.py connect_addr)
    if (!conn->SendFrame(a.token)) return nullptr;
    auto ok = conn->RecvFrame();
    if (!ok || *ok != "OK") return nullptr;
  }
  return conn;
}

bool Connection::SendFrame(const std::string& body) {
  if (fd_ < 0) return false;
  uint32_t len = uint32_t(body.size());
  char hdr[4];
  memcpy(hdr, &len, 4);
  if (!send_all(fd_, hdr, 4) || !send_all(fd_, body.data(), body.size())) {
    ::close(fd_);
    fd_ = -1;
    return false;
  }
  return true;
}

std::optional<std::string> Connection::RecvFrame() {
  if (fd_ < 0) return std::nullopt;
  char hdr[4];
  if (!recv_all(fd_, hdr, 4)) return std::nullopt;
  uint32_t len;
  memcpy(&len, hdr, 4);
  if (len > (1u << 28)) return std::nullopt;
  std::string body(len, '\0');
  if (len > 0 && !recv_all(fd_, body.data(), len)) return std::nullopt;
  return body;
}

// ---------------------------------------------------------------------------
// Plain-data pickle codec
// ---------------------------------------------------------------------------

namespace {

void put_u32le(std::string& out, uint32_t v) {
  out.append(reinterpret_cast<const char*>(&v), 4);
}

void pickle_value(std::string& out, const wire::Value& v) {
  using wire::Value;
  switch (v.kind) {
    case Value::NIL:
      out.push_back('N');
      break;
    case Value::BOOL:
      out.push_back(v.b ? char(0x88) : char(0x89));
      break;
    case Value::INT:
      if (v.i >= INT32_MIN && v.i <= INT32_MAX) {
        out.push_back('J');  // BININT, i32 LE
        int32_t x = int32_t(v.i);
        out.append(reinterpret_cast<const char*>(&x), 4);
      } else {
        out.push_back(char(0x8a));  // LONG1
        out.push_back(8);
        int64_t x = v.i;
        out.append(reinterpret_cast<const char*>(&x), 8);
      }
      break;
    case Value::FLOAT: {
      out.push_back('G');  // BINFLOAT, f64 BIG-endian
      uint64_t bits;
      memcpy(&bits, &v.f, 8);
      for (int k = 7; k >= 0; --k)
        out.push_back(char((bits >> (k * 8)) & 0xFF));
      break;
    }
    case Value::STR:
      out.push_back('X');  // BINUNICODE
      put_u32le(out, uint32_t(v.s.size()));
      out.append(v.s);
      break;
    case Value::BYTES:
      out.push_back('B');  // BINBYTES (protocol 3+)
      put_u32le(out, uint32_t(v.s.size()));
      out.append(v.s);
      break;
    case Value::LIST: {
      out.push_back(']');
      out.push_back('(');
      if (v.items)
        for (auto& x : *v.items) pickle_value(out, x);
      out.push_back('e');  // APPENDS
      break;
    }
    case Value::TUPLE: {
      out.push_back('(');
      if (v.items)
        for (auto& x : *v.items) pickle_value(out, x);
      out.push_back('t');  // TUPLE
      break;
    }
    case Value::DICT: {
      out.push_back('}');
      out.push_back('(');
      if (v.pairs)
        for (auto& kv : *v.pairs) {
          pickle_value(out, kv.first);
          pickle_value(out, kv.second);
        }
      out.push_back('u');  // SETITEMS
      break;
    }
    default:
      throw std::runtime_error("value kind not picklable");
  }
}

}  // namespace

std::string PickleArgs(const std::vector<wire::Value>& args) {
  // pickle of (list(args), {}) — what _resolve_args expects
  std::string out;
  out.push_back(char(0x80));  // PROTO
  out.push_back(3);
  out.push_back('(');
  out.push_back(']');
  out.push_back('(');
  for (auto& a : args) pickle_value(out, a);
  out.push_back('e');
  out.push_back('}');
  out.push_back('t');  // TUPLE -> (args_list, kwargs_dict)
  out.push_back('.');
  return out;
}

namespace {

struct Unpickler {
  const uint8_t* p;
  const uint8_t* end;
  std::vector<wire::Value> stack;
  std::vector<size_t> marks;
  std::vector<wire::Value> memo;
  bool fail = false;
  std::string global;  // "module.name" of the first class referenced

  bool need(size_t n) {
    if (size_t(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }

  template <typename T>
  T read_le() {
    T v{};
    memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  // pop the values above the last MARK into a list
  std::vector<wire::Value> pop_to_mark() {
    if (marks.empty()) {
      fail = true;
      return {};
    }
    size_t m = marks.back();
    marks.pop_back();
    std::vector<wire::Value> out(stack.begin() + m, stack.end());
    stack.resize(m);
    return out;
  }

  bool run() {
    using wire::Value;
    while (p < end) {
      uint8_t op = *p++;
      switch (op) {
        case 0x80:  // PROTO
          if (!need(1)) return false;
          p += 1;
          break;
        case 0x95:  // FRAME
          if (!need(8)) return false;
          p += 8;
          break;
        case 'N':
          stack.push_back(Value::None());
          break;
        case 0x88:
          stack.push_back(Value::Bool(true));
          break;
        case 0x89:
          stack.push_back(Value::Bool(false));
          break;
        case 'J': {
          if (!need(4)) return false;
          int32_t v = read_le<int32_t>();
          stack.push_back(Value::Int(v));
          break;
        }
        case 'K': {
          if (!need(1)) return false;
          stack.push_back(Value::Int(*p++));
          break;
        }
        case 'M': {
          if (!need(2)) return false;
          stack.push_back(Value::Int(read_le<uint16_t>()));
          break;
        }
        case 0x8a: {  // LONG1
          if (!need(1)) return false;
          uint8_t n = *p++;
          if (n > 8 || !need(n)) return false;
          int64_t v = 0;
          for (int k = int(n) - 1; k >= 0; --k) v = (v << 8) | p[k];
          // sign-extend
          if (n > 0 && (p[n - 1] & 0x80))
            for (int k = int(n); k < 8; ++k) v |= int64_t(0xFF) << (k * 8);
          p += n;
          stack.push_back(Value::Int(v));
          break;
        }
        case 'G': {  // BINFLOAT (big-endian)
          if (!need(8)) return false;
          uint64_t bits = 0;
          for (int k = 0; k < 8; ++k) bits = (bits << 8) | p[k];
          p += 8;
          double d;
          memcpy(&d, &bits, 8);
          stack.push_back(Value::Float(d));
          break;
        }
        case 0x8c: {  // SHORT_BINUNICODE
          if (!need(1)) return false;
          uint8_t n = *p++;
          if (!need(n)) return false;
          stack.push_back(Value::Str(std::string((const char*)p, n)));
          p += n;
          break;
        }
        case 'X': {  // BINUNICODE
          if (!need(4)) return false;
          uint32_t n = read_le<uint32_t>();
          if (!need(n)) return false;
          stack.push_back(Value::Str(std::string((const char*)p, n)));
          p += n;
          break;
        }
        case 'C': {  // SHORT_BINBYTES
          if (!need(1)) return false;
          uint8_t n = *p++;
          if (!need(n)) return false;
          stack.push_back(Value::Bytes(std::string((const char*)p, n)));
          p += n;
          break;
        }
        case 'B': {  // BINBYTES
          if (!need(4)) return false;
          uint32_t n = read_le<uint32_t>();
          if (!need(n)) return false;
          stack.push_back(Value::Bytes(std::string((const char*)p, n)));
          p += n;
          break;
        }
        case 0x8e: {  // BINBYTES8
          if (!need(8)) return false;
          uint64_t n = read_le<uint64_t>();
          if (!need(n)) return false;
          stack.push_back(Value::Bytes(std::string((const char*)p, n)));
          p += n;
          break;
        }
        case ']':
          stack.push_back(Value::List());
          break;
        case '}':
          stack.push_back(Value::Dict());
          break;
        case ')':
          stack.push_back(Value::Tuple());
          break;
        case '(':
          marks.push_back(stack.size());
          break;
        case 'a': {  // APPEND
          if (stack.size() < 2) return false;
          wire::Value v = std::move(stack.back());
          stack.pop_back();
          stack.back().push(std::move(v));
          break;
        }
        case 'e': {  // APPENDS
          auto items = pop_to_mark();
          if (fail || stack.empty()) return false;
          for (auto& x : items) stack.back().push(std::move(x));
          break;
        }
        case 's': {  // SETITEM
          if (stack.size() < 3) return false;
          wire::Value v = std::move(stack.back());
          stack.pop_back();
          wire::Value k = std::move(stack.back());
          stack.pop_back();
          if (!stack.back().pairs) return false;
          stack.back().pairs->emplace_back(std::move(k), std::move(v));
          break;
        }
        case 'u': {  // SETITEMS
          auto items = pop_to_mark();
          if (fail || stack.empty() || items.size() % 2) return false;
          auto& d = stack.back();
          if (!d.pairs) return false;
          for (size_t k = 0; k + 1 < items.size(); k += 2)
            d.pairs->emplace_back(std::move(items[k]),
                                  std::move(items[k + 1]));
          break;
        }
        case 0x85:  // TUPLE1
        case 0x86:  // TUPLE2
        case 0x87: {  // TUPLE3
          size_t n = size_t(op - 0x84);
          if (stack.size() < n) return false;
          wire::Value t = wire::Value::Tuple();
          for (size_t k = stack.size() - n; k < stack.size(); ++k)
            t.push(std::move(stack[k]));
          stack.resize(stack.size() - n);
          stack.push_back(std::move(t));
          break;
        }
        case 't': {  // TUPLE
          auto items = pop_to_mark();
          if (fail) return false;
          wire::Value t = wire::Value::Tuple();
          for (auto& x : items) t.push(std::move(x));
          stack.push_back(std::move(t));
          break;
        }
        case 0x94:  // MEMOIZE
          if (stack.empty()) return false;
          memo.push_back(stack.back());
          break;
        case 'q':  // BINPUT
          if (!need(1)) return false;
          p += 1;
          if (stack.empty()) return false;
          memo.push_back(stack.back());
          break;
        case 'r':  // LONG_BINPUT
          if (!need(4)) return false;
          p += 4;
          if (stack.empty()) return false;
          memo.push_back(stack.back());
          break;
        case 'h': {  // BINGET
          if (!need(1)) return false;
          uint8_t k = *p++;
          if (k >= memo.size()) return false;
          stack.push_back(memo[k]);
          break;
        }
        case 'j': {  // LONG_BINGET
          if (!need(4)) return false;
          uint32_t k = read_le<uint32_t>();
          if (k >= memo.size()) return false;
          stack.push_back(memo[k]);
          break;
        }
        case 0x93: {  // STACK_GLOBAL: a class, outside the subset
          if (stack.size() >= 2 &&
              stack[stack.size() - 2].kind == Value::STR &&
              stack.back().kind == Value::STR)
            global = stack[stack.size() - 2].s + "." + stack.back().s;
          return false;
        }
        case '.':  // STOP
          return stack.size() == 1;
        default:
          return false;  // outside the plain-data subset
      }
    }
    return false;
  }
};

// UnpickleValue that also reports the first class the stream references
// ("" when it names none) when it falls outside the plain-data subset.
bool unpickle(const char* data, size_t n, wire::Value* out,
              std::string* global) {
  Unpickler u;
  u.p = reinterpret_cast<const uint8_t*>(data);
  u.end = u.p + n;
  bool ok = u.run() && u.stack.size() == 1;
  if (global) *global = u.global;
  if (!ok) return false;
  *out = std::move(u.stack.back());
  return true;
}

}  // namespace

bool UnpickleValue(const char* data, size_t n, wire::Value* out) {
  return unpickle(data, n, out, nullptr);
}

bool UnpickleValue(const std::string& data, wire::Value* out) {
  return UnpickleValue(data.data(), data.size(), out);
}

// ---------------------------------------------------------------------------
// Actor calls
// ---------------------------------------------------------------------------

namespace {

std::string random_bytes(size_t n) {
  static thread_local std::mt19937_64 rng{std::random_device{}()};
  std::string out(n, '\0');
  for (size_t i = 0; i < n; ++i) out[i] = char(rng() & 0xFF);
  return out;
}

bool ends_with(const std::string& s, const std::string& suffix) {
  return s.size() >= suffix.size() &&
         s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
}

// Decode a store-format payload (serialization.py): tag 0 pickle, tag 1
// error pickle, tag 2 raw array, tag 3 raw tensor.  Works on (frame,
// offset) so large results are copied exactly once, into the final
// CallResult bytes.
void decode_payload(const std::string& frame, size_t off, CallResult* r) {
  size_t n = frame.size() - off;
  if (n == 0) {
    r->value = wire::Value::None();
    return;
  }
  uint8_t tag = uint8_t(frame[off]);
  const char* body = frame.data() + off + 1;
  size_t body_n = n - 1;
  if (tag == 0) {
    std::string global;
    if (!unpickle(body, body_n, &r->value, &global)) {
      // a reference to a value held in another process: its bytes would
      // mean nothing here
      if (ends_with(global, ".DeviceObjectMarker") ||
          ends_with(global, ".ObjectRef")) {
        r->ok = false;
        r->value = wire::Value::None();
        r->error = "the method returned " + global +
                   ", a reference to a value held by a Python process; "
                   "a C++ caller reads only plain data, arrays and "
                   "tensors returned by value";
        return;
      }
      r->raw = true;
      r->value = wire::Value::Bytes(std::string(body, body_n));
    }
    return;
  }
  if (tag == 1) {  // error payload: cloudpickled exception — opaque here
    r->ok = false;
    r->error = "remote exception (payload is a pickled Python exception; "
               "inspect from a Python peer)";
    return;
  }
  // array (tag 2) or tensor (tag 3):
  //   u32 meta_len | pickle((dtype, shape)) | data
  // with numpy's dtype string under tag 2 and torch's dtype name under 3
  if (tag == 2 || tag == 3) {
    uint32_t meta_len = 0;
    wire::Value meta;
    wire::Value arr = wire::Value::Dict();
    if (body_n >= 4) memcpy(&meta_len, body, 4);
    if (body_n >= 4 && 4 + size_t(meta_len) <= body_n &&
        UnpickleValue(body + 4, meta_len, &meta) && meta.items &&
        meta.items->size() == 2) {
      arr.set("dtype", (*meta.items)[0]);
      arr.set("shape", (*meta.items)[1]);
      arr.set("data", wire::Value::Bytes(std::string(
          body + 4 + meta_len, body_n - 4 - meta_len)));
      r->value = std::move(arr);
    } else {
      r->raw = true;
      r->value = wire::Value::Bytes(std::string(body, body_n));
    }
    return;
  }
  r->raw = true;
  r->value = wire::Value::Bytes(std::string(body, body_n));
}

}  // namespace

CallResult ActorHandle::Call(const std::string& method,
                             const std::vector<wire::Value>& args) {
  CallResult out;
  if (!conn_ || !conn_->ok()) {
    out.error = "channel closed";
    return out;
  }
  // 0x01 frame: tid(24) rid(28=tid+u32 index0) aid method args_pickle
  std::string tid = random_bytes(24);
  std::string rid = tid + std::string(4, '\0');
  std::string frame;
  frame.push_back(char(0x01));
  frame.push_back(char(tid.size()));
  frame += tid;
  frame.push_back(char(rid.size()));
  frame += rid;
  frame.push_back(char(info_.actor_id.size()));
  frame += info_.actor_id;
  uint16_t ml = uint16_t(method.size());
  frame.append(reinterpret_cast<const char*>(&ml), 2);
  frame += method;
  frame += PickleArgs(args);
  if (!conn_->SendFrame(frame)) {
    out.error = "send failed (actor gone?)";
    return out;
  }
  for (;;) {
    auto reply = conn_->RecvFrame();
    if (!reply) {
      out.error = "connection lost before reply";
      return out;
    }
    const std::string& f = *reply;
    if (f.size() < 3 || uint8_t(f[0]) != 0x02) continue;
    uint8_t tl = uint8_t(f[1]);
    if (f.size() < size_t(2 + tl + 1)) continue;
    if (f.compare(2, tl, tid) != 0) continue;  // earlier in-flight call
    uint8_t flags = uint8_t(f[2 + tl]);
    out.ok = (flags & 0x01) != 0;
    out.in_store = (flags & 0x02) != 0;
    if (!out.in_store) {
      bool was_ok = out.ok;
      decode_payload(f, size_t(2 + tl + 1), &out);
      out.ok = was_ok && out.error.empty();
    }
    return out;
  }
}

// ---------------------------------------------------------------------------
// Client (GCS)
// ---------------------------------------------------------------------------

std::unique_ptr<Client> Client::Connect(const std::string& addr) {
  Addr a = parse_addr(addr, env_token());
  auto conn = Connection::Dial(addr);
  if (!conn) return nullptr;
  // wire version handshake (gcs.py GcsClient._connect)
  if (!conn->SendFrame(wire::kHello)) return nullptr;
  auto ok = conn->RecvFrame();
  if (!ok || *ok != wire::kHelloOk) return nullptr;
  return std::unique_ptr<Client>(new Client(std::move(conn), a.token));
}

wire::Value Client::CallGcs(const std::string& method,
                            const std::vector<wire::Value>& args) {
  wire::Value req = wire::Value::Tuple();
  req.push(wire::Value::Str(method));
  wire::Value argv = wire::Value::Tuple();
  for (auto& a : args) argv.push(a);
  req.push(std::move(argv));
  req.push(wire::Value::Dict());  // kwargs
  if (!conn_->SendFrame(wire::encode(req)))
    throw wire::WireError("GCS connection lost (send)");
  auto data = conn_->RecvFrame();
  if (!data) throw wire::WireError("GCS connection lost (recv)");
  wire::Value resp = wire::decode(*data);
  if (resp.kind != wire::Value::TUPLE || !resp.items ||
      resp.items->size() != 2)
    throw wire::WireError("malformed GCS response");
  wire::Value& okv = (*resp.items)[0];
  wire::Value& payload = (*resp.items)[1];
  if (!(okv.kind == wire::Value::BOOL && okv.b)) {
    std::string msg = payload.kind == wire::Value::ERROR
                          ? payload.s + ": " + payload.s2
                          : "GCS call failed";
    throw std::runtime_error(msg);
  }
  return std::move(payload);
}

bool Client::KvPut(const std::string& ns, const std::string& key,
                   const std::string& value) {
  CallGcs("kv_put", {wire::Value::Str(ns), wire::Value::Bytes(key),
                     wire::Value::Bytes(value)});
  return true;
}

std::optional<std::string> Client::KvGet(const std::string& ns,
                                         const std::string& key) {
  wire::Value v =
      CallGcs("kv_get", {wire::Value::Str(ns), wire::Value::Bytes(key)});
  if (v.is_none()) return std::nullopt;
  return v.s;
}

bool Client::KvDel(const std::string& ns, const std::string& key) {
  CallGcs("kv_del", {wire::Value::Str(ns), wire::Value::Bytes(key)});
  return true;
}

std::vector<std::string> Client::KvKeys(const std::string& ns) {
  wire::Value v = CallGcs("kv_keys", {wire::Value::Str(ns)});
  std::vector<std::string> out;
  if (v.items)
    for (auto& x : *v.items) out.push_back(x.s);
  return out;
}

std::vector<NodeInfo> Client::ListNodes() {
  wire::Value v = CallGcs("list_nodes", {});
  std::vector<NodeInfo> out;
  if (v.items)
    for (auto& n : *v.items) {
      NodeInfo info;
      if (auto* f = n.get("node_id")) info.node_id = f->s;
      if (auto* f = n.get("alive")) info.alive = f->truthy();
      if (auto* f = n.get("is_head")) info.is_head = f->truthy();
      if (auto* f = n.get("store_socket")) info.store_socket = f->s;
      out.push_back(std::move(info));
    }
  return out;
}

std::optional<ActorInfo> Client::GetActorByName(const std::string& name) {
  wire::Value v = CallGcs("get_actor_by_name", {wire::Value::Str(name)});
  if (v.is_none()) return std::nullopt;
  ActorInfo info;
  if (auto* f = v.get("actor_id")) info.actor_id = f->s;
  if (auto* f = v.get("state")) info.state = f->s;
  if (auto* f = v.get("addr")) info.addr = f->s;
  if (auto* f = v.get("class_name")) info.class_name = f->s;
  return info;
}

std::unique_ptr<ActorHandle> Client::GetActorHandle(const std::string& name) {
  auto info = GetActorByName(name);
  if (!info || info->state != "ALIVE" || info->addr.empty()) return nullptr;
  auto conn = Connection::Dial(info->addr, token_);
  if (!conn) return nullptr;
  return std::make_unique<ActorHandle>(std::move(*info), std::move(conn));
}

// ---------------------------------------------------------------------------
// Object Put/Get against the local shm store daemon.
//
// Speaks store_client.py's fixed-frame protocol (shm_store.cc): 37-byte
// request <u8 op | 20s oid | u64 arg0 | u64 arg1>, 17-byte response
// <u8 status | u64 r0 | u64 r1>.  Payloads are the framework's store
// format: one tag byte (0 = pickle) + a plain-data pickle — the same
// bytes Python's serialization.deserialize reads, so objects are fully
// interoperable across the language boundary
// (reference: Ray's cpp/include/ray/api.h Put/Get over the plasma client).
// ---------------------------------------------------------------------------

namespace {

constexpr uint8_t kOpPut = 9, kOpGetInline = 10;
constexpr uint8_t kStOk = 0, kStNotFound = 1, kStTimeout = 4,
                  kStNotSealed = 5, kStEvicted = 7;
constexpr uint8_t kTagPickle = 0, kTagError = 1, kTagArray = 2,
                  kTagTensor = 3;

int dial_store(const std::string& path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct sockaddr_un sa {};
  sa.sun_family = AF_UNIX;
  if (path.size() >= sizeof(sa.sun_path)) {
    ::close(fd);
    return -1;
  }
  memcpy(sa.sun_path, path.c_str(), path.size() + 1);
  if (::connect(fd, (struct sockaddr*)&sa, sizeof(sa)) != 0) {
    ::close(fd);
    return -1;
  }
  std::string client_id = random_bytes(20);  // per-conn ref bookkeeping key
  if (!send_all(fd, client_id.data(), 20)) {
    ::close(fd);
    return -1;
  }
  return fd;
}

std::string pack_store_req(uint8_t op, const std::string& oid20,
                           uint64_t a0, uint64_t a1) {
  std::string req(37, '\0');
  req[0] = char(op);
  // short ids zero-pad, long ids truncate: never read past oid20's end
  memcpy(&req[1], oid20.data(), oid20.size() < 20 ? oid20.size() : 20);
  memcpy(&req[21], &a0, 8);
  memcpy(&req[29], &a1, 8);
  return req;
}

// first alive node whose store socket exists on THIS host
bool local_store(Client& c, std::string* sock, std::string* node_id) {
  for (auto& n : c.ListNodes()) {
    if (!n.alive || n.store_socket.empty()) continue;
    if (::access(n.store_socket.c_str(), F_OK) == 0) {
      *sock = n.store_socket;
      *node_id = n.node_id;
      return true;
    }
  }
  return false;
}

}  // namespace

Client::~Client() {
  if (store_fd_ >= 0) ::close(store_fd_);
}

int Client::store_conn() {
  if (store_fd_ >= 0) return store_fd_;
  if (store_sock_.empty() &&
      !local_store(*this, &store_sock_, &store_node_))
    return -1;
  store_fd_ = dial_store(store_sock_);
  return store_fd_;
}

// Always streams over OP_PUT, whatever the size: the zero-copy
// create/write/seal tier (store_client.py, >= RTPU_ZCOPY_PUT_MIN) needs
// the client to map the daemon's shm segment, which this convenience
// client deliberately skips — interop puts are control-plane traffic,
// not the bulk data path.
std::string Client::Put(const wire::Value& value) {
  std::string payload;
  payload.push_back(char(kTagPickle));
  payload.push_back(char(0x80));  // PROTO 3 pickle of the bare value
  payload.push_back(3);
  try {
    pickle_value(payload, value);
  } catch (const std::exception&) {
    return "";  // unpicklable kind: the documented "" failure, no throw
  }
  payload.push_back('.');
  std::string oid = random_bytes(20);
  int fd = store_conn();
  if (fd < 0) return "";
  std::string req = pack_store_req(kOpPut, oid, payload.size(), 0);
  uint8_t resp[17];
  bool ok = send_all(fd, req.data(), req.size()) &&
            send_all(fd, payload.data(), payload.size()) &&
            recv_all(fd, (char*)resp, sizeof resp) && resp[0] == kStOk;
  if (!ok) {
    ::close(store_fd_);  // drop the (possibly desynced) conn
    store_fd_ = -1;
    return "";
  }
  // location directory entry: remote nodes resolve + pull through it
  try {
    CallGcs("add_object_location",
            {wire::Value::Bytes(oid), wire::Value::Bytes(store_node_)});
  } catch (const std::exception&) {
    // best-effort: same-node gets still work
  }
  return oid;
}

std::optional<wire::Value> Client::Get(const std::string& object_id,
                                       int timeout_ms) {
  if (object_id.size() != 20) return std::nullopt;  // not a valid ObjectRef id
  int fd = store_conn();
  if (fd < 0) return std::nullopt;
  // huge inline cap: every object comes back as bytes (the zero-copy
  // view path needs the shm mapping, which a convenience client skips)
  std::string req = pack_store_req(kOpGetInline, object_id,
                                   uint64_t(timeout_ms), ~0ull);
  uint8_t resp[17];
  if (!send_all(fd, req.data(), req.size()) ||
      !recv_all(fd, (char*)resp, sizeof resp)) {
    ::close(store_fd_);
    store_fd_ = -1;
    return std::nullopt;
  }
  uint8_t status = resp[0];
  uint64_t inline_flag, size;
  memcpy(&inline_flag, resp + 1, 8);
  memcpy(&size, resp + 9, 8);
  if (status == kStNotFound || status == kStTimeout ||
      status == kStNotSealed || status == kStEvicted) {
    return std::nullopt;  // clean miss: the conn stays usable
  }
  if (status != kStOk || !inline_flag) {
    // daemon-side error (ST_ERR etc.) must be distinguishable from a
    // plain miss; !inline_flag cannot happen under the ~0 cap
    throw std::runtime_error("store get failed, status " +
                             std::to_string(int(status)));
  }
  std::string payload(size, '\0');
  bool ok = recv_all(fd, payload.data(), size);
  if (!ok) {
    ::close(store_fd_);
    store_fd_ = -1;
    return std::nullopt;
  }
  if (payload.empty()) return std::nullopt;
  uint8_t tag = uint8_t(payload[0]);
  if (tag == kTagError)
    throw std::runtime_error("object holds a stored task error");
  if (tag == kTagArray || tag == kTagTensor)
    throw std::runtime_error(
        "object payload is not plain data (array and tensor payloads need "
        "the Python client)");
  if (tag != kTagPickle)
    throw std::runtime_error("object payload has unknown tag " +
                             std::to_string(int(tag)));
  wire::Value out;
  if (!UnpickleValue(payload.data() + 1, payload.size() - 1, &out))
    throw std::runtime_error(
        "object pickle uses opcodes outside the plain-data subset");
  return out;
}

}  // namespace rtpu
