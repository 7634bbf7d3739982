"""The port's multi-device serving (``serving.sharding``,
``serving.replicas``, ``serve --strategy tp:K|dp:N``) against the JAX
package's on the CPU. The tp:2 engines run in 2 gloo ranks started by
``parallel.launch.spawn`` with a time limit (the cases are in
tests/torch_tp_cases.py): rank 0 leads, rank 1 follows.

Held (the tests of tests/test_serving_tp.py, ported): the serving
strategy grammar; ``replica_device_groups``; the ``kv_spec``, scale and
parameter rules against JAX's ``ServingSharding``; a page pool on a
rank's KV heads round-tripping (scatter, copy, gather) as the whole
pool's slice; tp:2 greedy and sampled tokens equal to tp:1 with dense KV,
speculation, paged KV and the prefix cache (the paged engine's weights
restored by ``restore_for_serving`` from a checkpoint written under tp),
the greedy ones equal to the JAX engine's; /predict scores; ``serve
--strategy tp:2`` through the CLI; ``ReplicaSet``'s deterministic
routing, fleet ``/readyz`` and shed, and aggregate gauges on the same fake
scenario in both packages; labelled series; a dp:2 HTTP round trip;
a checkpoint written under tp:2 resumed under FSDP; ``serve`` and
``batch-predict`` of an image model at tp:2 and dp:2+tp:2, and the LM at
dp:2+tp:2, against one process.
"""

import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import torch_tp_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import MetricsRegistry as JaxRegistry
from bigdl_tpu.serving import Replica as JaxReplica
from bigdl_tpu.serving import ReplicaSet as JaxReplicaSet
from bigdl_tpu.serving import ServingSharding as JaxServingSharding
from bigdl_tpu.serving import serving_mesh as jax_serving_mesh
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.serving import (DecodeEngine, MetricsRegistry, Replica,
                                     ReplicaSet, ServingApp, ServingSharding,
                                     WorkerDied, replica_device_groups,
                                     serving_mesh)

JOB_TIMEOUT_S = 200
ENV = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX serving LM and an init of it (the embedding scaled by 0.1,
    so greedy decoding does not repeat the prompt's last token)."""
    m = jax_models.transformer_lm(C.SERVE_LM["vocab"],
                                  d_model=C.SERVE_LM["d_model"],
                                  num_layers=C.SERVE_LM["num_layers"],
                                  num_heads=C.SERVE_LM["num_heads"],
                                  max_len=C.SERVE_LM["max_len"])
    p = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(1)))
    p["emb"]["weight"] = p["emb"]["weight"] * np.float32(0.1)
    return m, p


# ------------------------------------------------------- strategy parsing
def test_parse_serving_strategy_as_jax():
    from bigdl_tpu.cli.common import parse_serving_strategy as jparse
    for spec in ("tp", "tp:2", "dp", "dp:4", "dp:2+tp:4", "tp:4+dp:2",
                 "dp+tp:2", "dp:2+tp", None):
        assert common.parse_serving_strategy(spec, 8) == jparse(spec, 8)
    for bad in ("pp:2", "tp:0", "tp:x", "tp:2+tp:2", "dp:4+tp:4"):
        with pytest.raises(SystemExit):
            common.parse_serving_strategy(bad, 8)
        with pytest.raises(SystemExit):
            jparse(bad, 8)


def test_replica_device_groups_disjoint():
    devs = [torch.device("cpu")] * 4
    groups = replica_device_groups(2, 2, devs)
    assert [len(g) for g in groups] == [2, 2]
    assert [d for g in groups for d in g] == devs[:4]
    assert replica_device_groups(2, 1, ["cpu", "cpu"]) == [["cpu"],
                                                           ["cpu"]]
    with pytest.raises(ValueError, match="needs 16 devices"):
        replica_device_groups(8, 2, devs)


# ------------------------------------------------------ tp sharding rules
def test_serving_sharding_rules_match_jax(jax_lm):
    """kv_spec and scale_spec on the same shapes and specs, and the
    parameter specs of the serving LM, as JAX's ServingSharding gives
    them over 2 devices."""
    from jax.sharding import PartitionSpec as P
    jm, jp = jax_lm
    js = JaxServingSharding(jax_serving_mesh(jax.devices()[:2]))
    ts = ServingSharding(serving_mesh())
    assert ts.n_shard == 1  # one process: one rank on the model axis
    from bigdl_tpu_torch.parallel.mesh import Mesh
    ts = ServingSharding(Mesh("model", 2, 0))
    assert ts.n_shard == js.n_shard == 2
    for shape in ((4, 2, 64, 16), (4, 3, 64, 16), (4, 4, 8, 2), (8, 16),
                  (2, 2, 2)):
        leaf = np.zeros(shape, np.float32)
        assert P(*ts.kv_spec(leaf)) == js.kv_spec(leaf)
    for spec in ((None, "model"), ("model", None), (), (None, None)):
        assert P(*ts.scale_spec(spec)) == js.scale_spec(P(*spec))
    want = js.param_specs(jm, jp)
    got = ts.param_specs(C.serve_lm())

    def leaves(t, path=""):
        if not isinstance(t, dict):
            return {path: t}
        out = {}
        for k, v in t.items():
            out.update(leaves(v, f"{path}/{k}"))
        return out

    assert {k: P(*v) for k, v in leaves(got).items()} == leaves(want)


# --------------------------------------------------- the tp:2 engines
def _image_shards(root, rs) -> str:
    """Record shards of 10 seeded 40 x 48 PNGs in two classes (2 batches
    of 4 and a tail of 2 at -b 4)."""
    from PIL import Image

    from bigdl_tpu_torch.dataset.recordfile import write_image_shards
    for cls in ("a", "b"):
        d = root / "imgs" / cls
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rs.randint(0, 255, (40, 48, 3)).astype(
                np.uint8)).save(d / f"{i}.png")
    out = str(root / "shards")
    write_image_shards(str(root / "imgs"), out, images_per_shard=4)
    return out


@pytest.fixture(scope="module")
def tp_serving(tmp_path_factory, jax_lm):
    """Inputs (the JAX init in the port's names, seeded pool contents and
    rows), one 2-rank job that trains under tp and checkpoints, then
    serves (engines and the CLI); the single-process references."""
    root = tmp_path_factory.mktemp("serving_tp")
    _, jp = jax_lm
    rs = np.random.RandomState(0)
    inp = {f"serve/{k}": v.numpy() for k, v in
           tensors_from_jax(C.serve_lm(), jp).items()}
    for i in range(C.SERVE_LM["num_layers"]):
        for n in ("k", "v"):
            inp[f"pool/{i}/{n}"] = rs.randn(1, 2, 64, 16).astype(np.float32)
    inp["predict_x"] = rs.randint(0, 50, (2, 16)).astype(np.int32)
    inp["serve_x"] = rs.randint(0, 50, (8, 16)).astype(np.int32)
    inp["serve_y"] = rs.randint(0, 50, (8, 16)).astype(np.int32)
    inp["image_x"] = rs.randn(5, 32, 32, 3).astype(np.float32)
    np.savez(root / "inputs.npz", **inp)
    ck = str(root / "ckpt")
    shards = _image_shards(root, rs)
    # one job: the tp training writes the checkpoint the engines serve;
    # then the image and dp:N+tp:K topologies of serve and batch-predict
    spawn("torch_tp_cases:run_all", 2,
          {"dir": str(root), "cases": ["tp_ckpt", "serve", "serve_cli",
                                       "serve_strategies"],
           "ckpt": ck, "k": 2, "shards": shards}, timeout_s=JOB_TIMEOUT_S,
          backend="gloo", env=ENV)
    got = [dict(np.load(root / f"serve_r{r}.npz")) for r in range(2)]
    cli = dict(np.load(root / "serve_cli_r0.npz"))
    trained = dict(np.load(root / "tp_ckpt_r0.npz"))
    return root, np.load(root / "inputs.npz"), got, cli, trained, ck


def _one_rank_tokens(inp, name, ck=None):
    model = C.load(C.serve_lm(), inp, "serve")
    if ck is not None:
        from bigdl_tpu_torch.serving.sharding import restore_for_serving
        model.load_state_dict(restore_for_serving(ck, model)[0],
                              strict=False)
    return C._decode(model, None, C.ENGINES[name])


@pytest.mark.parametrize("name", list(C.ENGINES))
def test_tp2_tokens_equal_tp1(name, tp_serving):
    """tp:2 greedy and seeded sampled tokens, token for token, equal to
    one rank's: dense, dense speculative, and paged speculative with the
    prefix cache hit by the second prompt (its weights restored from the
    checkpoint written under tp)."""
    _, inp, got, _, _, ck = tp_serving
    want = _one_rank_tokens(inp, name, ck if name == "paged" else None)
    assert got[0][f"tokens/{name}"].tolist() == [
        t + [-1] * (8 - len(t)) for t in want]


def test_tp2_greedy_equals_jax_engine(tp_serving, jax_lm):
    """The greedy prompts' tp:2 tokens equal the JAX engine's."""
    jm, jp = jax_lm
    eng = JaxDecodeEngine(jm, jax.tree_util.tree_map(jax.numpy.asarray, jp),
                          slots=2)
    try:
        want = [eng.generate(p, 8) for p, o in C.PROMPTS if not o]
    finally:
        eng.close()
    got = tp_serving[2][0]["tokens/plain"].tolist()
    assert got[:len(want)] == want


def test_checkpoint_written_under_tp_is_whole(tp_serving):
    """The checkpoint the tp:2 job wrote holds whole tensors: restored in
    one process, they are the job's final parameters."""
    from bigdl_tpu_torch.serving.sharding import restore_for_serving
    _, _, _, _, trained, ck = tp_serving
    params, _ = restore_for_serving(ck, C.serve_lm())
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), trained[k], err_msg=k)
    with pytest.raises(SystemExit, match="does not exist"):
        restore_for_serving(ck + "_missing", C.serve_lm())


def test_tp_checkpoint_resumes_under_fsdp(tp_serving):
    """The tp:2 job's checkpoint (iteration 2, SGD momentum state
    included) resumed under FullyShardedDataParallel at 2 ranks to
    iteration 4 equals one process's uninterrupted 4 steps (1e-5): any
    training topology restores into any other."""
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    _, inp, _, _, trained, _ = tp_serving
    m = C.load(C.serve_lm(), inp, "serve")
    Optimizer(m, BatchDataSet(inp["serve_x"], inp["serve_y"], 4),
              C._LMCriterion(), optim_method=SGD(0.1, momentum=0.9),
              end_when=Trigger.max_iteration(4), device="cpu").optimize()
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(trained[f"resumed/{k}"], v.numpy(),
                                   atol=1e-5, err_msg=k)


def test_sharded_page_pool_roundtrip(tp_serving):
    """scatter, copy and gather on each rank's KV-head slice of the pools
    give that slice of the whole pools' result, bit for bit."""
    from bigdl_tpu_torch.serving.kv_pages import (PagedKvCache, copy_pages,
                                                  gather_cache,
                                                  scatter_pages)
    _, inp, got, _, _, _ = tp_serving
    model = C.load(C.serve_lm(), inp, "serve")
    kv = PagedKvCache(model.encoder, slots=2, max_len=64, page_tokens=16,
                      dtype=torch.float32, device="cpu")
    assert kv.reserve(0, 64)
    cache = [{n: torch.from_numpy(inp[f"pool/{i}/{n}"]) for n in ("k", "v")}
             for i in range(C.SERVE_LM["num_layers"])]
    pages = kv.page_table[0]
    scatter_pages(kv.pools, cache, pages)
    copy_pages(kv.pools, pages[:2], pages[2:4])
    whole = gather_cache(kv.pools, pages)
    for r in range(2):
        for i, layer in enumerate(whole):
            for n, t in layer.items():
                np.testing.assert_array_equal(
                    got[r][f"pool/{i}/{n}"], t[r:r + 1].numpy())


def test_tp2_predict_and_cli(tp_serving):
    """/predict scores at tp:2 against one rank (the row-split products
    reorder the sum: 1e-5), and ``serve --strategy tp:2`` through the CLI:
    its /generate tokens are a one-rank server's, its provenance names
    serving_tp."""
    _, inp, got, cli, _, _ = tp_serving
    from bigdl_tpu_torch.serving import InferenceEngine
    model = C.load(C.serve_lm(), inp, "serve")
    want = InferenceEngine(model, buckets=(2,), device="cpu",
                           graphs=False).predict_scores(inp["predict_x"])
    np.testing.assert_allclose(got[0]["predict"], want, atol=1e-5)
    from bigdl_tpu_torch.cli import serve as serve_cli
    argv = ["transformer_lm", "--randomInit", "--platform", "cpu",
            "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
            "--numHeads", "2", "--seq", "64", "--slots", "2",
            "--buckets", "1,2"]
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser()
                                       .parse_args(argv))
    try:
        for i, (p, o) in enumerate(C.PROMPTS):
            st, body = app.dispatch_post("/generate", {
                "tokens": p, "max_new_tokens": 8, **o})
            assert st == 200 and body["tokens"] == cli[f"gen/{i}"].tolist()
        st, body = app.dispatch_post("/predict", {
            "inputs": inp["predict_x"].tolist(), "return_scores": True})
        np.testing.assert_allclose(cli["scores"], body["scores"], atol=1e-5)
    finally:
        app.close()
    assert cli["prov_ok"].tolist() == [True]


# ------------------------------------- image tp:K and dp:N+tp:K (2 ranks)
@pytest.fixture(scope="module")
def strategies(tp_serving):
    """Rank 0's results of the job's ``serve_strategies`` case."""
    return dict(np.load(tp_serving[0] / "serve_strategies_r0.npz"))


def _app(argv):
    from bigdl_tpu_torch.cli import serve as serve_cli
    return serve_cli.build_app(serve_cli.build_parser().parse_args(argv))[0]


@pytest.mark.parametrize("strategy", C.STRATEGIES)
def test_image_serve_tp_matches_one_process(strategy, tp_serving,
                                            strategies):
    """``serve resnet20_cifar --strategy tp:2`` and ``dp:2+tp:2``: each
    /predict's scores equal one process's within 1e-5 (the split convs'
    output channels gathered whole: exact here), and the /metrics
    provenance names the topology and carries the shared core."""
    tag = strategy.replace(":", "").replace("+", "_")
    app = _app(C.IMAGE_ARGV)
    try:
        st, body = app.dispatch_post("/predict", {
            "inputs": tp_serving[1]["image_x"].tolist(),
            "return_scores": True})
    finally:
        app.close()
    assert st == 200
    np.testing.assert_allclose(strategies[f"image/{tag}"], body["scores"],
                               atol=1e-5)
    page = strategies[f"metrics/{tag}"].tobytes().decode()
    info = next(ln for ln in page.splitlines()
                if ln.startswith("bigdl_serving_info"))
    reps = 2 if strategy.startswith("dp") else 1
    for kv in (f'strategy="{strategy}"', f'serving_replicas="{reps}"',
               'serving_tp="2"', 'bn_fused="off"', 'autotune="off"',
               'conv_layouts="default"', 'conv_geom_decisions="0"',
               'cuda_graphs="False"'):
        assert kv in info, kv


@pytest.mark.parametrize("strategy", C.STRATEGIES)
def test_batch_predict_tp_matches_one_process(strategy, tp_serving,
                                              strategies, tmp_path):
    """``batch-predict --strategy tp:2`` and ``dp:2+tp:2``: every record
    once, scores equal one process's within 1e-5."""
    from bigdl_tpu_torch.cli import batch_predict
    from bigdl_tpu_torch.serving import bulk
    tag = strategy.replace(":", "").replace("+", "_")
    batch_predict.main(
        ["--modelName", "resnet20_cifar", "--randomInit", "-f",
         "record:" + str(tp_serving[0] / "shards"), "--out",
         str(tmp_path), "-b", "4", "--classNum", "10", "--scores",
         "--platform", "cpu"])
    rows = bulk.merge_shards(str(tmp_path))
    assert strategies[f"bp/{tag}/i"].tolist() == list(range(10))
    assert strategies[f"bp/{tag}/groups"].tolist() == [
        2 if strategy.startswith("dp") else 1, 2]
    np.testing.assert_allclose(strategies[f"bp/{tag}/scores"],
                               [r["scores"] for r in rows], atol=1e-5)


def test_lm_serve_dp2_tp2_matches_one_process(tp_serving, strategies):
    """``serve transformer_lm --strategy dp:2+tp:2`` (once refused by
    name): /generate tokens equal one process's, /predict scores within
    1e-5 (the row-split products reorder the sum)."""
    app = _app(C.LM_ARGV)
    try:
        for i, (p, o) in enumerate(C.PROMPTS):
            st, body = app.dispatch_post("/generate", {
                "tokens": p, "max_new_tokens": 8, **o})
            assert st == 200
            assert body["tokens"] == strategies[f"lm/gen/{i}"].tolist()
        st, body = app.dispatch_post("/predict", {
            "inputs": tp_serving[1]["predict_x"].tolist(),
            "return_scores": True})
    finally:
        app.close()
    np.testing.assert_allclose(strategies["lm/scores"], body["scores"],
                               atol=1e-5)


# ------------------------------------------------------------ dp routing
class _FakeBatcher:
    def __init__(self, depth=0, up=True, max_queue=8):
        self.queue_depth = depth
        self.max_queue = max_queue
        self.up = up

    def alive(self):
        return self.up

    def close(self):
        pass


class _FakeDecoder:
    _m_tokens = None

    def __init__(self, load=0, waiting=0, up=True, max_waiting=8,
                 kv=100, pages=3):
        self.load = load
        self._waiting = [None] * waiting
        self.max_waiting = max_waiting
        self.up = up
        self._kv, self._pages = kv, pages

    def queue_load(self):
        return self.load

    def alive(self):
        return self.up

    def kv_bytes(self):
        return self._kv

    def kv_pages_in_use(self):
        return self._pages

    def debug_snapshot(self):
        return {"slots": [], "waiting": len(self._waiting)}

    def close(self):
        pass


def _scenario(replica_cls, set_cls, registry):
    """The JAX test's routing, readiness, shed and gauge scenario; the
    trace of what the set answered."""
    reg = registry()
    reps = [replica_cls(i, batcher=_FakeBatcher(), decoder=_FakeDecoder())
            for i in range(3)]
    rs = set_cls(reps, metrics=reg)
    trace = [[rs.pick_generate().index for _ in range(3)],
             rs.pick_predict().index]
    reps[0].decoder.load, reps[1].decoder.load = 5, 2
    reps[2].decoder.load = 5
    trace.append(rs.pick_generate().index)
    reps[0].batcher.queue_depth = 4
    trace.append(rs.pick_predict().index)
    reps[1].decoder.up = False
    trace.append(rs.pick_generate().index)
    reps[0].decoder.load = 7
    trace.append(rs.pick_generate().index)
    trace.append([reg._metrics[n].value for n in (
        "replicas", "replicas_live", "kv_cache_bytes", "kv_pages_in_use")])
    reps[1].decoder.up = True
    ok, detail = rs.ready_detail()
    trace.append((ok, detail["replicas_live"]))
    reps[1].batcher.up = False
    ok, detail = rs.ready_detail()
    trace.append((ok, detail["replicas_live"], detail["replicas_dead"],
                  detail["replica_states"][1]["dead"]))
    reps[0].decoder._waiting = [None] * 8
    trace.append(rs.shed_generate(0.75))
    reps[2].batcher.queue_depth = 8
    trace.append(rs.shed_generate(0.75))
    reps[0].batcher.up = reps[2].batcher.up = False
    trace.append((rs.ready_detail()[0], rs.shed_generate(0.75)))
    for r in reps:
        r.decoder.up = False
    try:
        rs.pick_generate()
        trace.append("picked")
    except Exception as e:  # WorkerDied in both packages
        trace.append(str(e))
    return trace


def test_replica_set_as_jax():
    """Deterministic least-load routing (ties to the lowest index, dead
    replicas skipped), fleet readiness and shedding, the aggregate gauges
    and the all-dead 503: the same answers as the JAX ReplicaSet."""
    got = _scenario(Replica, ReplicaSet, MetricsRegistry)
    assert got == _scenario(JaxReplica, JaxReplicaSet, JaxRegistry)
    assert got[0] == [0, 0, 0] and got[-1] == "all engine replicas are dead"
    with pytest.raises(WorkerDied):
        ReplicaSet([Replica(0, decoder=_FakeDecoder(up=False))]
                   ).pick_generate()


def test_routed_pick_counts_until_released():
    """A reserved pick counts one in its replica's load until its block
    ends, an error included; the pure picks stay the JAX ones."""
    reps = [Replica(i, batcher=_FakeBatcher(), decoder=_FakeDecoder())
            for i in range(2)]
    rs = ReplicaSet(reps)
    with rs.routed("generate") as a, rs.routed("generate") as b, \
            rs.routed("generate") as c:
        assert [a.index, b.index, c.index] == [0, 1, 0]
        assert rs.pick_generate().index == 1
    with rs.routed("predict") as p:
        assert p.index == 0 and rs.pick_predict().index == 1
    with pytest.raises(RuntimeError):
        with rs.routed("generate"):
            raise RuntimeError("submit failed")
    assert [r.routing for r in reps] == [0, 0]
    assert rs.pick_generate().index == 0


class _SlowInstallDecoder(_FakeDecoder):
    """Like the real decoder, its submit runs the prefill before the
    request shows in ``queue_load``; the prefill waits on ``gate``."""

    def __init__(self, gate):
        super().__init__()
        self.gate, self.got = gate, []

    def submit(self, tokens, *args, **kwargs):
        assert self.gate.wait(30)
        self.got.append(list(tokens))
        self.load += 1
        fut = concurrent.futures.Future()
        fut.set_result(list(tokens))
        return fut


def _wait_for(cond, timeout=30.0):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(0.001)


def test_dp_generate_spreads_during_a_prefill():
    """Two /generate that arrive while the first one's submit is still
    prefilling go to different replicas, not both to replica 0."""
    gate = threading.Event()
    reps = [Replica(i, decoder=_SlowInstallDecoder(gate)) for i in range(2)]
    app = ServingApp(name="fake", metrics=MetricsRegistry(),
                     replicas=ReplicaSet(reps))
    out = {}

    def gen(i):
        out[i] = app.handle_generate({"tokens": [i + 1],
                                      "max_new_tokens": 1})

    threads = [threading.Thread(target=gen, args=(i,)) for i in range(2)]
    threads[0].start()
    _wait_for(lambda: reps[0].routing == 1)
    threads[1].start()
    _wait_for(lambda: reps[1].routing == 1)
    gate.set()
    for t in threads:
        t.join(30)
    assert out == {0: (200, {"tokens": [1], "prompt_len": 1}),
                   1: (200, {"tokens": [2], "prompt_len": 1})}
    assert [r.decoder.got for r in reps] == [[[1]], [[2]]]
    assert [r.routing for r in reps] == [0, 0]


def test_labelled_metrics_render_as_jax():
    pages = []
    for reg in (MetricsRegistry(clock=lambda: 0.0),
                JaxRegistry(clock=lambda: 0.0)):
        reg.labelled(replica="0").counter("generated_tokens_total",
                                          "t").inc(3)
        reg.labelled(replica="1").counter("generated_tokens_total",
                                          "t").inc(4)
        reg.gauge("kv_cache_bytes", "agg", fn=lambda: 7)
        reg.labelled(replica="1").histogram("latency_ms", "h").observe(2.0)
        pages.append(reg.render())
    assert pages[0] == pages[1]
    assert 'bigdl_serving_generated_tokens_total{replica="1"} 4' in pages[0]


# ------------------------------------------------- dp HTTP end-to-end
def _post(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_dp2_http_end_to_end():
    """dp:2 in one process behind one front door: /generate equals one
    engine's tokens, /metrics carries replica-labelled series and the
    fleet gauges, /readyz names both replicas, one dead replica is routed
    around (200), both dead answer 503."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import make_server

    argv = ["transformer_lm", "--randomInit", "--vocabSize", "50",
            "--dModel", "32", "--numLayers", "2", "--numHeads", "2",
            "--seq", "64", "--slots", "2", "--buckets", "1,2",
            "--maxWaitMs", "2", "--platform", "cpu", "--reqTrace", "on"]
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser().parse_args(
        argv + ["--strategy", "dp:2", "--devices", "cpu,cpu"]))
    oracle = TransformerLM(50, d_model=32, num_layers=2, num_heads=2,
                           max_len=64, attn_impl="flash",
                           generator=torch.Generator().manual_seed(0))
    eng = DecodeEngine(oracle, slots=2, device="cpu")
    prompt = [3, 1, 4, 1, 5]
    want = eng.generate(prompt, 6)
    eng.close()
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        st, out = _post(port, "/generate",
                        {"tokens": prompt, "max_new_tokens": 6})
        assert st == 200 and out["tokens"] == want
        st, body = _get(port, "/readyz")
        assert st == 200 and json.loads(body)["replicas_live"] == 2
        st, page = _get(port, "/metrics")
        ns = app.metrics.namespace
        assert f'{ns}_decode_worker_up{{replica="0"}} 1' in page
        assert f'{ns}_decode_worker_up{{replica="1"}} 1' in page
        assert f"{ns}_replicas 2" in page
        assert f"{ns}_fleet_generated_tokens_total 6" in page
        assert 'strategy="dp:2"' in page
        assert 'serving_replicas="2"' in page
        st, body = _get(port, "/debug/requests")
        assert any(r.get("replica") in (0, 1)
                   for r in json.loads(body)["recent"])
        app.replicas.replicas[0].decoder.declare_dead(
            RuntimeError("drill: replica 0 decode loop declared dead"))
        st, body = _get(port, "/readyz")
        assert st == 200 and json.loads(body)["replicas_dead"] == [0]
        st, out = _post(port, "/generate",
                        {"tokens": prompt, "max_new_tokens": 4})
        assert st == 200 and out["tokens"] == want[:4]
        app.replicas.replicas[1].decoder.declare_dead(
            RuntimeError("drill: replica 1 decode loop declared dead"))
        assert _get(port, "/readyz")[0] == 503
        assert _post(port, "/generate",
                     {"tokens": prompt, "max_new_tokens": 4})[0] == 503
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
