"""The port's static checker (``ray_tpu_torch/_private/staticcheck``)
checks itself as the JAX package's does (``tests/test_staticcheck.py``):
each pass is proven by a seeded-violation fixture tree that it must flag,
the port's tree must be clean modulo the reasoned allowlist, and the
checker must stay fast and import neither torch nor JAX.

The purity and shard fixtures are the port's own
(``tests/fixtures/torch/staticcheck/``, a ``/staticcheck/`` path, which the
JAX package's whole-checkout metrics scan skips).  The drift, locks,
metrics and proto fixtures are the JAX package's, copied at test time with
``ray_tpu/`` renamed ``ray_tpu_torch/``: on them the port's passes must
report what JAX's report, path for path.  So must the drift and locks
passes on the two packages' native sources, which are the same bytes but
for comments.

This file must not spell a family name of the JAX package literally: the
JAX package's lint counts any mention in the checkout as a use.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private import staticcheck
from ray_tpu_torch._private.staticcheck import (
    drift,
    locks,
    metrics_lint,
    protocheck,
    purity,
    shardcheck,
)
from ray_tpu_torch._private.staticcheck.common import (
    Allow,
    Violation,
    apply_allowlist,
    repo_root,
    validate_allowlist,
)

HERE = os.path.dirname(__file__)
_PORT_FIXTURES = os.path.join(HERE, "fixtures", "torch", "staticcheck")
_JAX_FIXTURES = os.path.join(HERE, "fixtures", "staticcheck")
# JAX's fixtures whose passes the port shares with no change of design
MAPPED = ("drifted", "inversion", "unprefixed_metric", "unhandled_opcode",
          "unreachable_chaos")
BUDGET_CPU_S = 10.0  # the JAX checker's budget (tests/test_staticcheck.py)
MODULES = (drift, locks, purity, metrics_lint, shardcheck, protocheck)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """JAX's five fixtures with ``ray_tpu/`` renamed ``ray_tpu_torch/``."""
    base = tmp_path_factory.mktemp("mapped")
    for name in MAPPED:
        shutil.copytree(os.path.join(_JAX_FIXTURES, name, "ray_tpu"),
                        base / name / "ray_tpu_torch")
    return {name: str(base / name) for name in MAPPED}


def _fixture(mapped, name):
    if name in MAPPED:
        return mapped[name]
    return os.path.join(_PORT_FIXTURES, name)


def _rules(violations):
    return {v.rule for v in violations}


# --- seeded-violation fixtures: each pass catches its plant ---------------

def test_drift_catches_drifted_opcode_and_layout(mapped):
    found = drift.check(mapped["drifted"])
    assert "drift/opcode" in _rules(found), found
    assert "drift/layout" in _rules(found), found
    opcode = next(v for v in found if v.rule == "drift/opcode")
    assert opcode.path == "ray_tpu_torch/native/shm_store.cc"
    assert "OP_SEAL = 99" in opcode.message
    assert opcode.line > 1  # points at the constexpr, not the file
    layout = next(v for v in found if v.rule == "drift/layout")
    assert "kReqLen = 29" in layout.message
    assert not any("OP_CREATE" in v.message for v in found)


def test_locks_catches_order_inversion_and_blocking_write(mapped):
    found = locks.check(mapped["inversion"])
    assert "locks/order-inversion" in _rules(found), found
    inv = next(v for v in found if v.rule == "locks/order-inversion")
    assert inv.path == "ray_tpu_torch/native/inversion.cc"
    assert "g_table_mu" in inv.message and "g_io_mu" in inv.message
    blocking = [v for v in found if v.rule == "locks/blocking-under-mutex"]
    assert blocking and "write()" in blocking[0].message


def test_purity_catches_wallclock_rng_and_syncs_in_captured_code():
    """torch.compile (called as a decorator), a function passed by name
    to torch.jit.trace, and a CUDA graph capture block."""
    found = purity.check(os.path.join(_PORT_FIXTURES, "impure"))
    assert all(v.path == "ray_tpu_torch/train/step_fixture.py"
               for v in found)
    by_line = {v.line: v for v in found}
    assert by_line[13].rule == "purity/wallclock-in-jit"
    assert "time.time()" in by_line[13].message
    assert by_line[15].rule == "purity/host-sync-in-jit"
    assert ".item()" in by_line[15].message
    assert by_line[19].rule == "purity/rng-in-jit"
    assert by_line[28].rule == "purity/host-sync-in-jit"
    assert ".cpu()" in by_line[28].message
    assert by_line[36].rule == "purity/host-sync-unbracketed"
    assert "torch.cuda.synchronize()" in by_line[36].message
    assert all("captured" in v.message for v in found
               if v.rule.endswith("-in-jit"))
    assert sorted(by_line) == [13, 15, 19, 28, 36]  # the bracketed sync


def test_metrics_catches_unprefixed_renderer_family(mapped):
    found = metrics_lint.check(mapped["unprefixed_metric"])
    assert "metrics/unprefixed-family" in _rules(found), found
    v = next(v for v in found if v.rule == "metrics/unprefixed-family")
    assert "node_cpu_percent" in v.message


def test_shard_catches_unknown_mesh_axis():
    found = shardcheck.check(os.path.join(_PORT_FIXTURES, "bad_axis"))
    assert _rules(found) == {"shard/unknown-mesh-axis"}, found
    v = found[0]
    assert v.path == "ray_tpu_torch/parallel/layout_fixture.py"
    assert "'tpu'" in v.message and "AXIS_ORDER" in v.message
    assert "get_group()" in v.message


def test_shard_catches_dead_rule():
    found = shardcheck.check(os.path.join(_PORT_FIXTURES, "dead_rule"))
    assert _rules(found) == {"shard/dead-logical-axis"}, found
    v = found[0]
    assert v.path == "ray_tpu_torch/parallel/rules_fixture.py"
    assert "'heads'" in v.message and "FIXTURE_RULES" in v.message
    assert not any("'batch'" in x.message for x in found)


def test_shard_catches_uncovered_param():
    found = shardcheck.check(os.path.join(_PORT_FIXTURES,
                                          "uncovered_param"))
    rules = _rules(found)
    assert "shard/unknown-logical-axis" in rules, found
    assert "shard/uncovered-param" in rules, found
    assert all(v.path == "ray_tpu_torch/models/tiny_fixture.py"
               for v in found)
    uncovered = next(v for v in found if v.rule == "shard/uncovered-param")
    assert "'widgets'" in uncovered.message
    assert "FULLY replicated" in uncovered.message


def test_proto_catches_unhandled_opcode_and_status(mapped):
    found = protocheck.check(mapped["unhandled_opcode"])
    assert _rules(found) == {
        "proto/opcode-undispatched", "proto/opcode-uncalled",
        "proto/status-unproduced", "proto/status-unhandled"}, found
    assert not any("OP_PING" in v.message or "ST_FINE" in v.message
                   for v in found)
    assert all("OP_FROB" in v.message or "ST_WEIRD" in v.message
               for v in found)
    assert all(v.path == "ray_tpu_torch/_private/wire_constants.py"
               for v in found)


def test_proto_catches_unreachable_chaos_flag(mapped):
    found = protocheck.check(mapped["unreachable_chaos"])
    assert "proto/chaos-lane-off" in _rules(found), found
    off = next(v for v in found if v.rule == "proto/chaos-lane-off")
    assert off.path == "ray_tpu_torch/_private/rpc_fixture.py"
    assert "RTPU_TESTING_RPC_FAILURE" in off.message
    assert "OFF" in off.message


_OWNER = {
    "drifted": drift, "inversion": locks, "impure": purity,
    "unprefixed_metric": metrics_lint,
    "bad_axis": shardcheck, "dead_rule": shardcheck,
    "uncovered_param": shardcheck,
    "unhandled_opcode": protocheck, "unreachable_chaos": protocheck,
}


@pytest.mark.parametrize("name", list(_OWNER))
def test_each_fixture_needs_its_own_pass(mapped, name):
    """The cross-product is silent: a fixture trips only the pass that
    owns its rule family, so a finding proves that specific pass."""
    for mod in MODULES:
        found = mod.check(_fixture(mapped, name))
        if mod is _OWNER[name]:
            assert found, f"{name} must trip {mod.__name__}"
        else:
            assert not found, (f"{name} leaked into {mod.__name__}: "
                               + "\n".join(v.format() for v in found))


# --- parity with the JAX package's passes ------------------------------------

def _jax_pass(mod):
    import importlib

    return importlib.import_module(
        f"ray_tpu._private.staticcheck.{mod.__name__.rsplit('.', 1)[1]}")


def _mapped_findings(violations):
    return [(v.rule, v.path.replace("ray_tpu/", "ray_tpu_torch/", 1),
             v.line, v.message) for v in violations]


@pytest.mark.parametrize("name", MAPPED)
def test_mapped_jax_fixtures_give_jaxs_findings(mapped, name):
    """Every pass, on JAX's fixture and on its renamed copy: the same
    rules, lines and messages, paths mapped."""
    for mod in MODULES:
        want = _mapped_findings(_jax_pass(mod).check(
            os.path.join(_JAX_FIXTURES, name)))
        got = [(v.rule, v.path, v.line, v.message)
               for v in mod.check(mapped[name])]
        assert got == want, mod.__name__


@pytest.mark.parametrize("mod", [drift, locks], ids=["drift", "locks"])
def test_native_findings_match_jaxs_on_the_real_trees(mod):
    """The two ``native/`` trees are the same bytes but for comments, so
    the C++ findings (including the allowlisted ones) are the same."""
    def native(violations):
        return [v for v in violations if v.path.endswith((".cc", ".h"))]

    want = _mapped_findings(native(_jax_pass(mod).check(repo_root())))
    got = [(v.rule, v.path, v.line, v.message)
           for v in native(mod.check(repo_root()))]
    assert got == want
    if mod is locks:
        assert len(got) >= 2  # the reviewed send_mu / mu_ findings


# The device telemetry is each package's own (``_private/profiling.py``):
# XLA's device memory and jit compiles in JAX's, the CUDA caching
# allocator's memory and the kernels' nvcc builds in the port's.  Spelled
# as a prefix plus suffixes (module docstring).
JAX_ONLY_FAMILIES = {"jax_" + s for s in (
    "device_memory_bytes_in_use", "device_memory_peak_bytes",
    "jit_compilations_total", "jit_compile_seconds_total")}
PORT_ONLY_FAMILIES = {"cuda_" + s for s in (
    "device_memory_bytes_in_use", "device_memory_peak_bytes",
    "kernel_builds_total", "kernel_build_seconds_total")}


def test_metrics_finds_jaxs_family_set():
    """The families the port's pass finds in ``ray_tpu_torch/`` are the
    ones JAX's finds in ``ray_tpu/``, but for the device telemetry."""
    from ray_tpu._private.staticcheck import metrics_lint as jax_lint

    want = set(jax_lint._scan_registrations(repo_root(), []))
    got = metrics_lint.families(repo_root())
    assert want - got == JAX_ONLY_FAMILIES
    assert got - want == PORT_ONLY_FAMILIES
    assert len(got) > 50


def test_metrics_resolves_names_spelled_in_two_parts():
    """The prefix-plus-suffix tables of the engine, the data executor and
    the data service, and the goodput tracker's local alias, are found."""
    from ray_tpu_torch._private import data_service
    from ray_tpu_torch.data import executor
    from ray_tpu_torch.llm import engine

    got = metrics_lint.families(repo_root())
    for mod in (engine, executor, data_service):
        names = {mod._FAMILY_PREFIX + row[1 if mod is executor else 2]
                 for row in mod._FAMILIES}
        assert len(names) == len(mod._FAMILIES) and names <= got, mod
    from ray_tpu_torch.util import goodput

    assert {goodput._FAMILY_PREFIX + "mfu",
            goodput._FAMILY_PREFIX + "step_s"} <= got


def test_metrics_resolver_forms(tmp_path):
    """Each spelling the resolver follows, in one module: a constant, a
    ``+`` of constants, a class constant read through ``self``, a local
    alias, and a tuple table unpacked by a comprehension and by a loop
    (its rows' classes and descriptions too)."""
    pkg = tmp_path / "ray_tpu_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "fixture.py").write_text(
        'from m import Counter, Gauge, Histogram\n'
        'P = "fx_"\n'
        'NAME = P + "plain_total"\n'
        'TABLE = (("a", Counter, "a_total", "help a"),\n'
        '         ("b", Gauge, "b_value", ""))\n'
        'ROWS = (("Histogram", "c_s", "help c"),)\n'
        'Counter(NAME, "help")\n'
        'class T:\n'
        '    PREFIX = "fx_cls_"\n'
        '    NAME = PREFIX + "gauge"\n'
        '    def make(self):\n'
        '        return Gauge(self.NAME, "help")\n'
        'def make():\n'
        '    p = P\n'
        '    made = {k: cls(p + s, h) for k, cls, s, h in TABLE}\n'
        '    for kind, s, h in ROWS:\n'
        '        made[s] = getattr(M, kind)(P + s, description=h)\n'
        '    return made\n')
    from ray_tpu_torch._private.staticcheck.common import source

    regs = metrics_lint.registrations(
        source(str(tmp_path), "ray_tpu_torch/core/fixture.py"))
    assert sorted(regs) == sorted([
        ("Counter", "fx_plain_total", "help", 7),
        ("Gauge", "fx_cls_gauge", "help", 12),
        ("Counter", "fx_a_total", "help a", 4),
        ("Gauge", "fx_b_value", "", 5),
        ("Histogram", "fx_c_s", "help c", 6)])
    found = metrics_lint.check(str(tmp_path))
    assert any(v.rule == "metrics/missing-help" and "fx_b_value" in v.message
               and v.line == 5 for v in found)


# --- the real tree -------------------------------------------------------------

def test_real_tree_is_clean_modulo_allowlist():
    report = staticcheck.run()
    assert report.ok, "\n".join(v.format() for v in report.violations)
    assert report.suppressed, "allowlist should be exercised by the tree"
    assert not report.unused_allows, [
        (a.rule, a.path) for a in report.unused_allows]


def test_allowlist_entries_all_carry_reasons():
    from ray_tpu_torch._private.staticcheck.allowlist import ALLOWLIST

    assert not validate_allowlist(ALLOWLIST)
    for entry in ALLOWLIST:
        assert len(entry.reason.strip()) > 20, (
            f"{entry.rule} on {entry.path}: reason too thin to review")
        assert entry.path.startswith("ray_tpu_torch/"), entry.path


def test_allowlist_matching_and_reason_enforcement():
    v = Violation("locks/blocking-under-mutex", "ray_tpu_torch/native/x.cc",
                  7, "F: blocking call send() while holding mu")
    hit = Allow("locks/*", "ray_tpu_torch/native/*.cc", "send()",
                reason="why")
    miss = Allow("drift/*", "*", "", reason="why")
    report = apply_allowlist([v], [miss, hit])
    assert not report.violations
    assert report.suppressed == [(v, hit)]
    assert report.unused_allows == [miss]
    assert validate_allowlist([Allow("x", "y", "", reason="  ")])


def test_check_is_fast_and_imports_neither_torch_nor_jax():
    """The checker's child process uses under the JAX checker's 10 s
    budget of CPU time (user + sys, from ``os.wait4``: its wall time
    depends on how many test workers share the machine) and imports
    neither torch nor JAX."""
    code = ("import json, sys\n"
            "from ray_tpu_torch._private import staticcheck\n"
            "report = staticcheck.run()\n"
            "print(json.dumps({'ok': report.ok, 'modules': sorted(\n"
            "    m for m in ('torch', 'jax') if m in sys.modules)}))\n")
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo_root(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out, err = proc.stdout.read(), proc.stderr.read()
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    wall = time.monotonic() - t0
    assert proc.returncode == 0, out + err
    assert json.loads(out) == {"ok": True, "modules": []}
    cpu = usage.ru_utime + usage.ru_stime
    assert cpu < BUDGET_CPU_S, f"{cpu:.2f} s of CPU ({wall:.2f} s wall)"


def _cli(*args, module="ray_tpu_torch.scripts.cli"):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=repo_root(),
                          timeout=120)


@pytest.mark.parametrize("module", ["ray_tpu_torch.scripts.cli check",
                                    "ray_tpu_torch._private.staticcheck"])
def test_cli_check_exits_zero_on_clean_tree(module):
    mod, *args = module.split()
    proc = _cli(*args, module=mod)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout
    assert "6 pass(es)" in proc.stdout
    assert "unused allowlist" not in proc.stdout


def test_run_registers_six_passes():
    assert set(staticcheck.PASSES) == {
        "drift", "locks", "purity", "metrics", "shard", "proto"}


def test_cli_pass_selection_csv():
    """``check shard,proto`` runs exactly the named passes."""
    proc = _cli("check", "shard,proto")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 pass(es)" in proc.stdout
    bad = _cli("check", "nope")
    assert bad.returncode != 0
    assert "unknown pass" in bad.stderr


def test_cli_json_findings_shape(capsys):
    """--json has the JAX checker's keys: pass, rule, file, line,
    message, allowlisted (+ reason) per finding."""
    from ray_tpu._private import staticcheck as jax_check

    proc = _cli("check", "shard,proto", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert jax_check.main(["shard,proto", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(doc) == set(want)
    assert doc["ok"] is True and doc["unused_allows"] == []
    assert set(doc["passes"]) == {"shard", "proto"}
    assert doc["findings"], "the reviewed shard/proto findings must appear"
    for f in doc["findings"]:
        assert set(f) == set(want["findings"][0])
        assert f["pass"] in ("shard", "proto")
        assert f["allowlisted"] is True  # tree is clean modulo allowlist
        assert len(f["reason"]) > 20
