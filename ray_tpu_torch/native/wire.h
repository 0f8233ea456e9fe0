// Wire codec: C++ mirror of ray_tpu/_private/wire.py.
//
// Counterpart of the reference's protobuf layer (Ray's src/ray/
// protobuf/) scaled to this runtime: one tagged, length-delimited value tree
// per frame, identical byte-for-byte to the Python codec so the native GCS /
// raylet daemons and the Python workers interoperate.  Tags:
//
//   0x00 None    0x01 False   0x02 True    0x03 int64   0x04 float64
//   0x05 str     0x06 bytes   0x07 list    0x08 tuple   0x09 dict
//   0x0A struct (u8 id + field dict)       0x0B error (type, message)
//
// Values are held as a small tagged tree (wire::Value).  Structs are kept
// generically as (id + field dict) — the daemons read/update fields by name,
// so a Python-side dataclass gaining a field is never a wire break here.

#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace wire {

constexpr uint8_t kVersion = 1;
inline const std::string kHello = std::string("RTPUWIRE") + char(kVersion);
inline const std::string kHelloOk =
    std::string("RTPUWIRE-OK") + char(kVersion);

constexpr int kMaxDepth = 32;
constexpr uint32_t kMaxItems = 1u << 22;

struct WireError : std::runtime_error {
  explicit WireError(const std::string& m) : std::runtime_error(m) {}
};

struct Value;
using ValueList = std::vector<Value>;
using ValuePairs = std::vector<std::pair<Value, Value>>;

struct Value {
  enum Kind : uint8_t {
    NIL, BOOL, INT, FLOAT, STR, BYTES, LIST, TUPLE, DICT, STRUCT, ERROR
  };
  Kind kind = NIL;
  bool b = false;
  int64_t i = 0;
  double f = 0.0;
  std::string s;   // STR/BYTES payload; ERROR: type name
  std::string s2;  // ERROR: message
  uint8_t struct_id = 0;
  std::shared_ptr<ValueList> items;   // LIST/TUPLE
  std::shared_ptr<ValuePairs> pairs;  // DICT / STRUCT fields

  Value() = default;
  static Value None() { return Value(); }
  static Value Bool(bool v) { Value x; x.kind = BOOL; x.b = v; return x; }
  static Value Int(int64_t v) { Value x; x.kind = INT; x.i = v; return x; }
  static Value Float(double v) { Value x; x.kind = FLOAT; x.f = v; return x; }
  static Value Str(std::string v) {
    Value x; x.kind = STR; x.s = std::move(v); return x;
  }
  static Value Bytes(std::string v) {
    Value x; x.kind = BYTES; x.s = std::move(v); return x;
  }
  static Value List() {
    Value x; x.kind = LIST; x.items = std::make_shared<ValueList>(); return x;
  }
  static Value Tuple() {
    Value x; x.kind = TUPLE; x.items = std::make_shared<ValueList>();
    return x;
  }
  static Value Dict() {
    Value x; x.kind = DICT; x.pairs = std::make_shared<ValuePairs>();
    return x;
  }
  static Value Struct(uint8_t id) {
    Value x; x.kind = STRUCT; x.struct_id = id;
    x.pairs = std::make_shared<ValuePairs>();
    return x;
  }
  static Value Error(std::string type, std::string msg) {
    Value x; x.kind = ERROR; x.s = std::move(type); x.s2 = std::move(msg);
    return x;
  }

  bool is_none() const { return kind == NIL; }
  bool truthy() const {
    switch (kind) {
      case NIL: return false;
      case BOOL: return b;
      case INT: return i != 0;
      case FLOAT: return f != 0.0;
      case STR: case BYTES: return !s.empty();
      case LIST: case TUPLE: return items && !items->empty();
      case DICT: case STRUCT: return pairs && !pairs->empty();
      default: return true;
    }
  }
  // numeric coercion (heartbeat payloads may carry ints where floats live)
  double as_f() const { return kind == INT ? double(i) : f; }
  int64_t as_i() const { return kind == FLOAT ? int64_t(f) : i; }

  // dict/struct field access by string key (linear scan: control-plane
  // dicts are tiny). Returns nullptr when absent.
  const Value* get(const std::string& key) const {
    if (!pairs) return nullptr;
    for (auto& kv : *pairs)
      if (kv.first.kind == STR && kv.first.s == key) return &kv.second;
    return nullptr;
  }
  Value* get_mut(const std::string& key) {
    if (!pairs) return nullptr;
    for (auto& kv : *pairs)
      if (kv.first.kind == STR && kv.first.s == key) return &kv.second;
    return nullptr;
  }
  void set(const std::string& key, Value v) {
    if (!pairs) pairs = std::make_shared<ValuePairs>();
    for (auto& kv : *pairs)
      if (kv.first.kind == STR && kv.first.s == key) {
        kv.second = std::move(v);
        return;
      }
    pairs->emplace_back(Value::Str(key), std::move(v));
  }
  void push(Value v) {
    if (!items) items = std::make_shared<ValueList>();
    items->push_back(std::move(v));
  }
};

// ---------------------------------------------------------------------------
// Encoding
// ---------------------------------------------------------------------------

inline void put_u32(std::string& out, uint32_t v) {
  char b[4];
  std::memcpy(b, &v, 4);  // little-endian hosts only (x86/ARM)
  out.append(b, 4);
}

inline void encode_into(std::string& out, const Value& v, int depth = 0) {
  if (depth > kMaxDepth) throw WireError("encode: nesting too deep");
  switch (v.kind) {
    case Value::NIL: out.push_back(0x00); break;
    case Value::BOOL: out.push_back(v.b ? 0x02 : 0x01); break;
    case Value::INT: {
      out.push_back(0x03);
      char b[8];
      std::memcpy(b, &v.i, 8);
      out.append(b, 8);
      break;
    }
    case Value::FLOAT: {
      out.push_back(0x04);
      char b[8];
      std::memcpy(b, &v.f, 8);
      out.append(b, 8);
      break;
    }
    case Value::STR:
    case Value::BYTES:
      out.push_back(v.kind == Value::STR ? 0x05 : 0x06);
      put_u32(out, uint32_t(v.s.size()));
      out.append(v.s);
      break;
    case Value::LIST:
    case Value::TUPLE: {
      out.push_back(v.kind == Value::LIST ? 0x07 : 0x08);
      size_t n = v.items ? v.items->size() : 0;
      put_u32(out, uint32_t(n));
      for (size_t k = 0; k < n; ++k)
        encode_into(out, (*v.items)[k], depth + 1);
      break;
    }
    case Value::DICT: {
      out.push_back(0x09);
      size_t n = v.pairs ? v.pairs->size() : 0;
      put_u32(out, uint32_t(n));
      for (size_t k = 0; k < n; ++k) {
        encode_into(out, (*v.pairs)[k].first, depth + 1);
        encode_into(out, (*v.pairs)[k].second, depth + 1);
      }
      break;
    }
    case Value::STRUCT: {
      out.push_back(0x0A);
      out.push_back(char(v.struct_id));
      out.push_back(0x09);  // field dict
      size_t n = v.pairs ? v.pairs->size() : 0;
      put_u32(out, uint32_t(n));
      for (size_t k = 0; k < n; ++k) {
        encode_into(out, (*v.pairs)[k].first, depth + 1);
        encode_into(out, (*v.pairs)[k].second, depth + 1);
      }
      break;
    }
    case Value::ERROR:
      out.push_back(0x0B);
      encode_into(out, Value::Str(v.s), depth + 1);
      encode_into(out, Value::Str(v.s2), depth + 1);
      break;
  }
}

inline std::string encode(const Value& v) {
  std::string out;
  encode_into(out, v);
  return out;
}

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct Reader {
  const char* p;
  size_t len;
  size_t pos = 0;

  uint8_t u8() {
    if (pos >= len) throw WireError("truncated frame");
    return uint8_t(p[pos++]);
  }
  uint32_t u32() {
    if (pos + 4 > len) throw WireError("truncated length");
    uint32_t v;
    std::memcpy(&v, p + pos, 4);
    pos += 4;
    return v;
  }
};

inline Value decode_one(Reader& r, int depth) {
  if (depth > kMaxDepth) throw WireError("decode: nesting too deep");
  uint8_t tag = r.u8();
  switch (tag) {
    case 0x00: return Value::None();
    case 0x01: return Value::Bool(false);
    case 0x02: return Value::Bool(true);
    case 0x03: {
      if (r.pos + 8 > r.len) throw WireError("truncated int64");
      int64_t v;
      std::memcpy(&v, r.p + r.pos, 8);
      r.pos += 8;
      return Value::Int(v);
    }
    case 0x04: {
      if (r.pos + 8 > r.len) throw WireError("truncated float64");
      double v;
      std::memcpy(&v, r.p + r.pos, 8);
      r.pos += 8;
      return Value::Float(v);
    }
    case 0x05:
    case 0x06: {
      uint32_t n = r.u32();
      if (r.pos + n > r.len) throw WireError("truncated string/bytes");
      std::string s(r.p + r.pos, n);
      r.pos += n;
      Value v = tag == 0x05 ? Value::Str(std::move(s))
                            : Value::Bytes(std::move(s));
      return v;
    }
    case 0x07:
    case 0x08: {
      uint32_t n = r.u32();
      if (n > kMaxItems || n > r.len - r.pos)
        throw WireError("collection count exceeds frame");
      Value v = tag == 0x07 ? Value::List() : Value::Tuple();
      v.items->reserve(n);
      for (uint32_t k = 0; k < n; ++k)
        v.items->push_back(decode_one(r, depth + 1));
      return v;
    }
    case 0x09: {
      uint32_t n = r.u32();
      if (n > kMaxItems || n > r.len - r.pos)
        throw WireError("collection count exceeds frame");
      Value v = Value::Dict();
      v.pairs->reserve(n);
      for (uint32_t k = 0; k < n; ++k) {
        Value key = decode_one(r, depth + 1);
        Value val = decode_one(r, depth + 1);
        v.pairs->emplace_back(std::move(key), std::move(val));
      }
      return v;
    }
    case 0x0A: {
      uint8_t sid = r.u8();
      Value body = decode_one(r, depth + 1);
      if (body.kind != Value::DICT)
        throw WireError("struct body must be a dict");
      Value v = Value::Struct(sid);
      v.pairs = body.pairs;
      return v;
    }
    case 0x0B: {
      Value name = decode_one(r, depth + 1);
      Value msg = decode_one(r, depth + 1);
      if (name.kind != Value::STR || msg.kind != Value::STR)
        throw WireError("error frame fields must be strings");
      return Value::Error(std::move(name.s), std::move(msg.s));
    }
    default:
      throw WireError("unknown tag");
  }
}

inline Value decode(const std::string& data) {
  Reader r{data.data(), data.size()};
  Value v = decode_one(r, 0);
  if (r.pos != r.len) throw WireError("trailing bytes after value");
  return v;
}

// Request envelope: (method:str, args:tuple, kwargs:dict)
struct Request {
  std::string method;
  Value args;    // TUPLE
  Value kwargs;  // DICT
};

inline Request decode_request(const std::string& data) {
  Value v = decode(data);
  if (v.kind != Value::TUPLE || !v.items || v.items->size() != 3)
    throw WireError("malformed request envelope");
  Value& m = (*v.items)[0];
  if (m.kind != Value::STR || (*v.items)[1].kind != Value::TUPLE ||
      (*v.items)[2].kind != Value::DICT)
    throw WireError("malformed request envelope");
  return Request{std::move(m.s), std::move((*v.items)[1]),
                 std::move((*v.items)[2])};
}

inline std::string encode_response(bool ok, const Value& payload) {
  Value t = Value::Tuple();
  t.push(Value::Bool(ok));
  t.push(payload);
  return encode(t);
}

}  // namespace wire
