"""The port's job submission and remote-driver client
(``ray_tpu_torch/_private/job_manager.py``, ``job_submission/``,
``util/client/``), each scenario of the JAX package's
``tests/test_job_submission.py`` and ``tests/test_client.py`` against one
port cluster of this module.

A submitted job is a shell command on the head that attaches to the
cluster through ``RAY_TPU_ADDRESS``: it succeeds with its output in the
logs, fails with its exit code, or is stopped.  An ``rtpu://`` address
attaches a driver in another process with no node of its own through the
head's ``ClientServer``: tasks, objects, ``wait``, actors, the cluster's
state and remote errors cross it, and a wrong token is refused.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch as rt

    node = rt.init(min_workers=1, resources={"CPU": 2.0})
    try:
        yield rt, node
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def client(port):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    _, node = port
    return JobSubmissionClient(node.scheduler.socket_path)


@pytest.fixture(scope="module")
def client_server(port):
    from ray_tpu_torch.util.client import ClientServer

    server = ClientServer(host="127.0.0.1", port=0)
    yield server
    server.shutdown()


def test_head_runs_a_job_manager(port):
    _, node = port
    assert node.scheduler.job_manager is not None
    assert node.dashboard_url


def test_no_address_finds_only_the_clusters_of_its_own_tmpdir(
        port, tmp_path, monkeypatch):
    """Without an address the job client, the CLI and ``address="auto"``
    look under ``session_root()`` of the caller's TMPDIR and nowhere else:
    a session planted under a scratch TMPDIR is found and resolved to its
    head, and under an empty one nothing is, though live clusters run
    under the default temporary directory."""
    import shutil
    import tempfile

    from ray_tpu_torch import api
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.scripts import cli

    _, node = port
    head_sock = node.scheduler.socket_path

    def use_tmpdir(path):
        os.makedirs(path, exist_ok=True)
        monkeypatch.setenv("TMPDIR", str(path))
        monkeypatch.setattr(tempfile, "tempdir", None)
        return node_mod.session_root()

    root = use_tmpdir(tmp_path / "mine")
    planted = os.path.join(root, "session_planted", "sched.sock")
    try:
        os.makedirs(os.path.dirname(planted))
        os.symlink(head_sock, planted)
        assert node_mod.live_session_sockets() == [planted]
        assert cli.find_address(None) == planted
        assert JobSubmissionClient()._sock == head_sock

        use_tmpdir(tmp_path / "empty")
        assert node_mod.live_session_sockets() == []
        with pytest.raises(ConnectionError):
            JobSubmissionClient()
        with pytest.raises(SystemExit):
            cli.find_address(None)
        with pytest.raises(ConnectionError):
            api._find_gcs_address()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_job_lifecycle(client, tmp_path):
    from ray_tpu_torch.job_submission import JobStatus

    (tmp_path / "driver.py").write_text(
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"  # attaches via RAY_TPU_ADDRESS
        "@ray_tpu_torch.remote\n"
        "def sq(x):\n"
        "    return x * x\n"
        "print('total:', sum(ray_tpu_torch.get([sq.remote(i) "
        "for i in range(5)])))\n"
        "ray_tpu_torch.shutdown()\n")
    sub_id = client.submit_job(entrypoint="python driver.py",
                               runtime_env={"working_dir": str(tmp_path)})
    status = client.wait_until_finished(sub_id, timeout=180)
    logs = client.get_job_logs(sub_id)
    assert status == JobStatus.SUCCEEDED, logs
    assert "total: 30" in logs
    assert any(j.submission_id == sub_id for j in client.list_jobs())


def test_job_failure_reported(client):
    from ray_tpu_torch.job_submission import JobStatus

    sub_id = client.submit_job(entrypoint="python -c 'raise SystemExit(3)'")
    assert client.wait_until_finished(sub_id, timeout=60) == JobStatus.FAILED
    assert "exit code 3" in client.get_job_info(sub_id).message


def test_job_stop(client):
    from ray_tpu_torch.job_submission import JobStatus

    sub_id = client.submit_job(entrypoint="sleep 120")
    deadline = time.monotonic() + 30
    while (client.get_job_status(sub_id) == JobStatus.PENDING
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert client.stop_job(sub_id)
    assert client.wait_until_finished(sub_id, timeout=30) == JobStatus.STOPPED


def _run(script: str, timeout: float = 180) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _run_client(server, body: str) -> str:
    return _run(textwrap.dedent(f"""
        import ray_tpu_torch
        assert ray_tpu_torch.init(address="{server.address}") is None
    """) + textwrap.dedent(body))


def test_client_tasks_and_objects(client_server):
    out = _run_client(client_server, """
        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        ref = ray_tpu_torch.put(40)
        print("task:", ray_tpu_torch.get(add.remote(ref, 2)))
        refs = [add.remote(i, i) for i in range(4)]
        ready, pending = ray_tpu_torch.wait(refs, num_returns=4, timeout=60)
        print("wait:", len(ready), len(pending))
        print("vals:", sorted(ray_tpu_torch.get(refs)))
        ray_tpu_torch.shutdown()
    """)
    assert "task: 42" in out
    assert "wait: 4 0" in out
    assert "vals: [0, 2, 4, 6]" in out


def test_client_actors_and_state(client_server):
    out = _run_client(client_server, """
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0
            def incr(self):
                self.n += 1
                return self.n

        c = Counter.remote()
        print("counts:", [ray_tpu_torch.get(c.incr.remote())
                          for _ in range(3)])
        print("nodes:", len(ray_tpu_torch.nodes()) >= 1)
        print("cpus:", ray_tpu_torch.cluster_resources().get("CPU", 0) > 0)
        ray_tpu_torch.kill(c)
    """)
    assert "counts: [1, 2, 3]" in out
    assert "nodes: True" in out
    assert "cpus: True" in out


def test_client_error_propagation(client_server):
    out = _run_client(client_server, """
        @ray_tpu_torch.remote
        def boom():
            raise ValueError("remote kaboom")

        try:
            ray_tpu_torch.get(boom.remote())
            print("NO ERROR")
        except ValueError as e:
            print("caught:", "remote kaboom" in str(e))
    """)
    assert "caught: True" in out


def test_client_auth_rejected(client_server):
    out = _run(textwrap.dedent(f"""
        import ray_tpu_torch
        try:
            ray_tpu_torch.init(
                address="rtpu://wrong-token@127.0.0.1:{client_server.port}")
            print("CONNECTED")
        except ConnectionError:
            print("rejected")
    """), timeout=120)
    assert "rejected" in out
