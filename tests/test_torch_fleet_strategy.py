"""A fleet whose worker takes ``--strategy``, end to end on the CPU:
``cli.fleet --fleet 1 --strategy tp:2 --platform cpu`` (and ``dp:2+tp:2``:
two replicas, each over both ranks) is the router and one worker of two
gloo ranks (``fleet.worker.run_group``), serving a checkpoint written by
the JAX package. Held: greedy ``/generate`` equals the JAX engine's tokens
on the same tree, token for token, in f32, from every replica; a SIGKILL
of rank 1 takes the whole group down, the router counts one restart and
no process of the old group survives; ``POST /admin/reload`` swaps every
rank of every replica to the new checkpoint's tokens, and a checkpoint
the ranks refuse keeps the old weights on all of them (503, the JAX
``WeightSwapError`` text). Each wait has its own time limit."""

import concurrent.futures
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch_fleet_cases as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ([7, 3, 9, 1, 4], [2, 8, 8, 5, 1, 6, 3])
BOOT_S, RESTART_S, HTTP_S = 60.0, 60.0, 30.0


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX checkpoints of versions 0 and 1 (seeds 2 and 3, whose greedy
    chains wander), one of a wider model, and each version's greedy
    tokens of PROMPTS from the JAX engine."""
    root = tmp_path_factory.mktemp("fleet_tp")
    got = C.jax_checkpoints(root, (2, 3), PROMPTS)
    out = {0: got[2], 1: got[3]}
    assert out[0]["tokens"] != out[1]["tokens"]
    assert all(len(set(t)) > 1 for t in out[0]["tokens"] + out[1]["tokens"])
    m = C.jax_lm(2 * C.D)
    out["wide"] = C.save_jax_checkpoint(m, C.random_tree(m, 0),
                                        root / "wide")
    return out


def _req(port, method, path, body=None, timeout=HTTP_S):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               method=method,
                               headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _generate(port):
    out = []
    for p in PROMPTS:
        st, body = _req(port, "POST", "/generate",
                        {"tokens": p, "max_new_tokens": 8})
        assert st == 200, body
        out.append(body["tokens"])
    return out


def _served(worker_port) -> dict:
    """{replica: tokens generated} from the worker's /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{worker_port}/metrics",
                                timeout=HTTP_S) as r:
        page = r.read().decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^bigdl_serving_generated_tokens_total\{replica="(\d+)"\} (\S+)',
        page, re.M)}


def _every_replica_generates(port, worker_port, want, n_replicas):
    """Concurrent bursts of PROMPTS through the router, each answer held
    to ``want``, until every replica has generated since the first
    burst (the replicas route to the least loaded, ties to replica 0)."""
    before = _served(worker_port)
    t_end = time.monotonic() + HTTP_S
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        while True:
            got = list(pool.map(lambda p: _req(port, "POST", "/generate", {
                "tokens": p, "max_new_tokens": 8}), PROMPTS * 2))
            assert all(st == 200 for st, _ in got), got
            assert [b["tokens"] for _, b in got] == want * 2
            now = _served(worker_port)
            if len(now) == n_replicas and all(
                    now[r] > before.get(r, 0) for r in now):
                return
            assert time.monotonic() < t_end, (before, now)


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _group(pgid: int) -> list:
    """The live processes of process group ``pgid``."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[2]) == pgid and fields[0] != "Z":
                out.append(int(d))
    return out


def _until(fn, limit_s, what):
    t_end = time.monotonic() + limit_s
    while time.monotonic() < t_end:
        v = fn()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"{what} within {limit_s:.0f}s")


@contextlib.contextmanager
def _fleet(ckpts, strategy):
    """``cli.fleet --fleet 1 --strategy <strategy>`` over version 0: (router
    port, lines of its output, a stop function: SIGTERM to the router)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu_torch.cli.fleet"] + C.LM_ARGS
        + ["--fleet", "1", "--strategy", strategy, "--platform", "cpu",
           "--model", ckpts[0]["path"], "--port", "0",
           "--fleetHeartbeatS", "0.2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, start_new_session=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines: list = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True
                     ).start()

    def port():
        for ln in list(lines):
            m = re.search(r"fleet on http://[^:]+:(\d+)", ln)
            if m:
                return int(m.group(1))
        assert proc.poll() is None, "".join(lines[-30:])
        return None

    def stop():
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
            raise

    try:
        yield _until(port, BOOT_S, "the fleet's banner"), lines, stop
    finally:
        stop()


def _serves_restarts_and_swaps(ckpts, strategy, n_replicas):
    with _fleet(ckpts, strategy) as (port, lines, stop):
        _drive(ckpts, port, lines, stop, n_replicas)


def test_tp2_fleet_serves_restarts_and_swaps_as_one_process(ckpts):
    _serves_restarts_and_swaps(ckpts, "tp:2", 1)


def test_dp2_tp2_fleet_swaps_every_replica_on_every_rank(ckpts):
    """Two replicas a rank, each its own process group and ``TPLink``:
    both answer with the JAX tokens before the kill, after the restart
    and after the reload (each replica's tokens need both ranks' shards
    of that replica)."""
    _serves_restarts_and_swaps(ckpts, "dp:2+tp:2", 2)


def _drive(ckpts, port, lines, stop, n_replicas):
    def generate(worker_port, seed):
        assert _generate(port) == ckpts[seed]["tokens"]
        if n_replicas > 1:
            _every_replica_generates(port, worker_port,
                                     ckpts[seed]["tokens"], n_replicas)

    st, fl = _req(port, "GET", "/debug/fleet")
    w = fl["workers"][0]
    assert st == 200 and w["restarts"] == 0
    generate(w["port"], 0)
    st, body = _req(w["port"], "GET", "/debug/ranks")
    ranks = body["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    old = [w["pid"]] + [r["pid"] for r in ranks]
    assert set(old[1:]) <= set(_group(w["pid"]))

    # all or none: rank 1 killed takes the group down; one restart
    os.kill(ranks[1]["pid"], signal.SIGKILL)

    def back():
        w2 = _req(port, "GET", "/debug/fleet")[1]["workers"][0]
        return w2 if (w2["restarts"] == 1 and w2["state"] == "ready"
                      and w2["pid"] != w["pid"]) else None

    w2 = _until(back, RESTART_S, "the group's restart")
    assert not [p for p in old if _alive(p)] and not _group(w["pid"])
    generate(w2["port"], 0)

    # the rolling swap reaches both ranks (of every replica)
    st, body = _req(port, "POST", "/admin/reload",
                    {"checkpoint": ckpts[1]["path"], "version": "v1"},
                    timeout=60)
    assert st == 200 and body["workers"][0]["status"] == "reloaded", body
    generate(w2["port"], 1)
    # a checkpoint every rank refuses: 503, and both keep v1
    st, body = _req(w2["port"], "POST", "/admin/reload",
                    {"checkpoint": ckpts["wide"], "version": "v2"},
                    timeout=60)
    assert st == 503 and re.match(
        r"restore failed for .*weights NOT swapped", body["error"]), body
    assert _req(w2["port"], "GET", "/control/state")[1][
        "model_version"] == "v1"
    # the router saw "reloading" on a heartbeat of that direct reload:
    # routable again once a "ready" one lands
    _until(lambda: _req(port, "GET", "/debug/fleet")[1]["workers"][0][
        "routable"], HTTP_S, "the worker back in rotation")
    generate(w2["port"], 1)
    new = [w2["pid"]] + [r["pid"] for r in _req(
        w2["port"], "GET", "/debug/ranks")[1]["ranks"]]
    assert not set(new) & set(old)
    assert any("worker group: rank 1 of 2 exited with -9" in ln
               for ln in lines), "".join(lines[-30:])
    # the router's close leaves no process of the group
    assert stop() == 0
    assert not [p for p in new if _alive(p)] and not _group(w2["pid"])
