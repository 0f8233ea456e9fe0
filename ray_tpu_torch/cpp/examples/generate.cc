// ray_tpu_torch C++ worker API example: a C++ application asks a named
// engine actor for completions.
//
//   ./generate <gcs_address> <actor_name> <max_tokens> [<ids> ...]
//              [--tensor <method>] [--hex] [--pings <n>]
//
// Each <ids> is one prompt as comma-separated token ids.  For prompt k the
// program calls generate("cpp<k>", ids, max_tokens) on the actor, greedy,
// one request at a time, and prints the result's ids as one JSON line:
//   {"key": "cpp0", "ids": [...]}
// With --tensor it then calls <method>(ids of the first result, or [])
// and prints what the returned array or tensor holds:
//   {"tensor": {"method": ..., "dtype": ..., "shape": [...], "nbytes": n,
//               "sums": [s0, s1]}}
// where the sums read the bytes as little-endian int16 words w_i:
// s0 = sum(w_i), s1 = sum(w_i * (i % 65521)), in wrapping int64 (the
// checksum chip_smoke.py computes on the card).  --hex adds the bytes as
// "hex".  --pings times <n> calls of the actor's no-op ping():
//   {"ping_ms": {"n": n, "p50": ..., "p90": ...}}
// Any failure prints "FAIL: ..." on stderr and exits non-zero.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "ray_tpu_torch/client.h"

using wire::Value;

namespace {

int fail(const std::string& msg) {
  fprintf(stderr, "FAIL: %s\n", msg.c_str());
  return 1;
}

bool parse_ids(const std::string& arg, Value* out) {
  *out = Value::List();
  size_t pos = 0;
  while (pos < arg.size()) {
    size_t comma = arg.find(',', pos);
    if (comma == std::string::npos) comma = arg.size();
    std::string tok = arg.substr(pos, comma - pos);
    if (tok.empty() ||
        tok.find_first_not_of("0123456789") != std::string::npos)
      return false;
    out->push(Value::Int(std::strtoll(tok.c_str(), nullptr, 10)));
    pos = comma + 1;
  }
  return true;
}

std::string json_str(const std::string& s) {
  std::string out = "\"";
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out.push_back('\\');
      out.push_back(c);
    } else if (uint8_t(c) < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", unsigned(uint8_t(c)));
      out += buf;
    } else {
      out.push_back(c);
    }
  }
  return out + "\"";
}

// "[1, 2, 3]" from a list or tuple of ints; false on any other item
bool json_ints(const Value& v, std::string* out) {
  *out = "[";
  if (v.items) {
    for (size_t k = 0; k < v.items->size(); ++k) {
      const Value& x = (*v.items)[k];
      if (x.kind != Value::INT) return false;
      if (k) *out += ", ";
      *out += std::to_string(x.i);
    }
  }
  *out += "]";
  return true;
}

double percentile(std::vector<double> xs, double q) {
  std::sort(xs.begin(), xs.end());
  double at = q * double(xs.size() - 1);
  size_t lo = size_t(at);
  size_t hi = std::min(lo + 1, xs.size() - 1);
  return xs[lo] + (at - double(lo)) * (xs[hi] - xs[lo]);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4)
    return fail(
        "usage: generate <gcs_address> <actor_name> <max_tokens> [<ids> ...]"
        " [--tensor <method>] [--hex] [--pings <n>]");
  std::vector<Value> prompts;
  std::string tensor_method;
  bool hex = false;
  int pings = 0;
  int max_tokens = std::atoi(argv[3]);
  for (int k = 4; k < argc; ++k) {
    std::string a = argv[k];
    if (a == "--tensor" && k + 1 < argc) {
      tensor_method = argv[++k];
    } else if (a == "--hex") {
      hex = true;
    } else if (a == "--pings" && k + 1 < argc) {
      pings = std::atoi(argv[++k]);
    } else {
      Value ids;
      if (!parse_ids(a, &ids)) return fail("bad prompt ids: " + a);
      prompts.push_back(std::move(ids));
    }
  }

  auto client = rtpu::Client::Connect(argv[1]);
  if (!client) return fail("GCS connect failed");
  auto actor = client->GetActorHandle(argv[2]);
  if (!actor) return fail("actor not resolvable/ALIVE");

  Value first_ids = Value::List();
  for (size_t k = 0; k < prompts.size(); ++k) {
    std::string key = "cpp" + std::to_string(k);
    auto r = actor->Call("generate", {Value::Str(key), prompts[k],
                                      Value::Int(max_tokens)});
    if (!r.ok) return fail("generate: " + r.error);
    const Value* ids = r.value.get("ids");
    std::string ids_json;
    if (!ids || !json_ints(*ids, &ids_json))
      return fail("generate returned no list of int ids");
    if (k == 0) first_ids = *ids;
    printf("{\"key\": %s, \"ids\": %s}\n", json_str(key).c_str(),
           ids_json.c_str());
  }

  if (!tensor_method.empty()) {
    auto r = actor->Call(tensor_method, {first_ids});
    if (!r.ok) return fail(tensor_method + ": " + r.error);
    if (r.in_store)
      return fail(tensor_method + ": the result went to the store (larger "
                                  "than the actor's inline cap)");
    const Value* dtype = r.value.get("dtype");
    const Value* shape = r.value.get("shape");
    const Value* data = r.value.get("data");
    std::string shape_json;
    if (!dtype || dtype->kind != Value::STR || !shape ||
        !json_ints(*shape, &shape_json) || !data ||
        data->kind != Value::BYTES)
      return fail(tensor_method + " returned no array or tensor");
    const std::string& b = data->s;
    if (b.size() % 2) return fail("odd byte count: no int16 checksum");
    uint64_t s0 = 0, s1 = 0;  // wrapping, as torch's int64 sums
    for (size_t i = 0; i < b.size() / 2; ++i) {
      int16_t w = int16_t(uint16_t(uint8_t(b[2 * i])) |
                          uint16_t(uint8_t(b[2 * i + 1])) << 8);
      s0 += uint64_t(int64_t(w));
      s1 += uint64_t(int64_t(w) * int64_t(i % 65521));
    }
    printf("{\"tensor\": {\"method\": %s, \"dtype\": %s, \"shape\": %s, "
           "\"nbytes\": %zu, \"sums\": [%lld, %lld]",
           json_str(tensor_method).c_str(), json_str(dtype->s).c_str(),
           shape_json.c_str(), b.size(), (long long)int64_t(s0),
           (long long)int64_t(s1));
    if (hex) {
      static const char digits[] = "0123456789abcdef";
      std::string h;
      h.reserve(2 * b.size());
      for (char c : b) {
        h.push_back(digits[uint8_t(c) >> 4]);
        h.push_back(digits[uint8_t(c) & 15]);
      }
      printf(", \"hex\": \"%s\"", h.c_str());
    }
    printf("}}\n");
  }

  if (pings > 0) {
    std::vector<double> ms;
    for (int k = 0; k < pings; ++k) {
      auto t0 = std::chrono::steady_clock::now();
      auto r = actor->Call("ping", {});
      auto t1 = std::chrono::steady_clock::now();
      if (!r.ok) return fail("ping: " + r.error);
      ms.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
    }
    printf("{\"ping_ms\": {\"n\": %d, \"p50\": %.6f, \"p90\": %.6f}}\n", pings,
           percentile(ms, 0.5), percentile(ms, 0.9));
  }
  return 0;
}
