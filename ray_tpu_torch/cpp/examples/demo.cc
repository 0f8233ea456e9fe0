// ray_tpu_torch C++ worker API demo: cluster state, KV, and calling a
// Python actor from C++.  Driven by tests/test_torch_cpp_api.py against a
// live cluster of the port's runtime, and by chip_smoke.py on the card.
//
//   ./demo <gcs_address> <actor_name>
//
// Prints one "DEMO-OK ..." line on success; any failure exits non-zero.

#include <cstdio>
#include <string>

#include "ray_tpu_torch/client.h"

using wire::Value;

#define CHECK(cond, msg)                         \
  do {                                           \
    if (!(cond)) {                               \
      fprintf(stderr, "FAIL: %s\n", msg);        \
      return 1;                                  \
    }                                            \
  } while (0)

int main(int argc, char** argv) {
  CHECK(argc >= 3, "usage: demo <gcs_address> <actor_name>");
  auto client = rtpu::Client::Connect(argv[1]);
  CHECK(client, "GCS connect failed");

  // -- KV ----------------------------------------------------------------
  client->KvPut("cppdemo", "greeting", "hello-from-cpp");
  auto got = client->KvGet("cppdemo", "greeting");
  CHECK(got && *got == "hello-from-cpp", "kv roundtrip");
  auto keys = client->KvKeys("cppdemo");
  bool has_greeting = false;
  for (auto& k : keys) has_greeting |= (k == "greeting");
  CHECK(has_greeting, "kv_keys");

  // -- cluster state ------------------------------------------------------
  auto nodes = client->ListNodes();
  int alive = 0;
  for (auto& n : nodes) alive += n.alive ? 1 : 0;
  CHECK(alive >= 1, "no alive nodes");

  // -- actor calls --------------------------------------------------------
  auto actor = client->GetActorHandle(argv[2]);
  CHECK(actor, "actor not resolvable/ALIVE");

  auto r1 = actor->Call("echo", {Value::Int(41)});
  CHECK(r1.ok && r1.value.kind == Value::INT && r1.value.i == 42, "echo");

  auto r2 = actor->Call("concat",
                        {Value::Str("cpp"), Value::Str("python")});
  CHECK(r2.ok && r2.value.kind == Value::STR && r2.value.s == "cpp:python",
        "concat");

  Value xs = Value::List();
  for (int i = 1; i <= 4; ++i) xs.push(Value::Int(i));
  auto r3 = actor->Call("stats", {xs});
  CHECK(r3.ok && r3.value.pairs, "stats shape");
  auto* n = r3.value.get("n");
  auto* sum = r3.value.get("sum");
  CHECK(n && n->as_i() == 4 && sum && sum->as_i() == 10, "stats values");

  // mixed-type roundtrip incl. float/bytes/none/nested
  Value payload = Value::Dict();
  payload.set("f", Value::Float(2.5));
  payload.set("b", Value::Bytes(std::string("\x00\x01\xff", 3)));
  payload.set("none", Value::None());
  auto r4 = actor->Call("roundtrip", {payload});
  CHECK(r4.ok, "roundtrip failed");
  auto* f = r4.value.get("f");
  CHECK(f && f->as_f() == 5.0, "roundtrip float doubled");
  auto* b = r4.value.get("b");
  CHECK(b && b->s.size() == 3, "roundtrip bytes");

  // remote exception surfaces as !ok
  auto r5 = actor->Call("boom", {});
  CHECK(!r5.ok, "remote exception not surfaced");

  // -- object Put/Get -----------------------------------------------------
  Value obj = Value::Dict();
  obj.set("kind", Value::Str("cpp-object"));
  Value vec = Value::List();
  for (int i = 0; i < 5; ++i) vec.push(Value::Int(i * i));
  obj.set("squares", vec);
  std::string oid = client->Put(obj);
  CHECK(oid.size() == 20, "Put failed");
  auto back = client->Get(oid);
  CHECK(back && back->get("kind") && back->get("kind")->s == "cpp-object",
        "Get roundtrip kind");
  CHECK(back->get("squares") && back->get("squares")->items &&
            back->get("squares")->items->size() == 5 &&
            (*back->get("squares")->items)[4].as_i() == 16,
        "Get roundtrip payload");
  // publish the oid so the Python side of the test can read OUR object
  client->KvPut("cppdemo", "oid", oid);
  // and read an object a PYTHON put sealed, when the test staged one
  auto py_oid = client->KvGet("cppdemo", "py_oid");
  if (py_oid) {
    auto py_obj = client->Get(*py_oid);
    CHECK(py_obj && py_obj->get("from") &&
              py_obj->get("from")->s == "python",
          "cross-language Get");
    printf("CROSS-LANG-OK\n");
  }

  // per-caller FIFO across a burst
  for (int i = 0; i < 20; ++i) {
    auto r = actor->Call("echo", {Value::Int(i)});
    CHECK(r.ok && r.value.i == i + 1, "burst echo");
  }

  printf("DEMO-OK nodes=%d actor=%s\n", alive,
         actor->info().class_name.c_str());
  return 0;
}
