"""The tensor-parallel and FSDP cases that tests/test_torch_tensor_parallel.py,
tests/test_torch_fsdp.py and tests/test_torch_serving_tp.py run in 2 and 4
gloo ranks (through ``bigdl_tpu_torch.parallel.launch.spawn``). It imports
torch and the port only: each rank is a fresh process, and no rank imports
jax.

Every case reads its inputs from ``inputs.npz`` in ``args["dir"]`` and
writes ``<case>_r<rank>.npz`` beside it; ``run_all`` returns a small
JSON-able dict of each case's counts.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

STEPS = 3
LM = dict(vocab=32, d_model=16, num_layers=2, num_heads=4, max_len=8)


def mlp():
    """The JAX tensor-parallel test's model (tests/test_tensor_parallel.py)."""
    return Sequential(nn.Linear(8, 32), nn.Tanh(), nn.Linear(32, 4),
                      nn.LogSoftMax())


def lm(num_kv_heads=None, dropout=0.0):
    return models.TransformerLM(LM["vocab"], d_model=LM["d_model"],
                                num_layers=LM["num_layers"],
                                num_heads=LM["num_heads"],
                                max_len=LM["max_len"], dropout=dropout,
                                num_kv_heads=num_kv_heads)


def dropout_mlp():
    return Sequential(nn.Linear(8, 32), nn.Dropout(0.5), nn.Linear(32, 4),
                      nn.LogSoftMax())


def conv_net():
    return Sequential(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
                      nn.SpatialBatchNormalization(8), nn.ReLU(),
                      nn.SpatialConvolution(8, 4, 3, 3),
                      nn.Reshape([4 * 4 * 4]), nn.Linear(64, 5),
                      nn.LogSoftMax())


def load(model, inp, prefix):
    sd = dict(model.state_dict())
    sd.update({k[len(prefix) + 1:]: torch.from_numpy(np.array(inp[k]))
               for k in inp.files if k.startswith(prefix + "/")})
    model.load_state_dict(sd, strict=True)
    return model


def make_method(name, lr):
    """SGD(lr, momentum 0.9), or a per-tensor-norm method: LARS(lr,
    momentum 0.9, weight decay 1e-4) or LAMB(lr, weight decay 1e-2)."""
    from bigdl_tpu_torch.optim import LAMB, LARS
    if name == "lars":
        return LARS(lr, momentum=0.9, weight_decay=1e-4)
    if name == "lamb":
        return LAMB(lr, weight_decay=1e-2)
    return SGD(lr, momentum=0.9)


def train(model, x, y, batch, steps, strategy=None, crit=None, lr=0.5,
          clip=None, method="sgd", **kw):
    """``steps`` Optimizer steps of ``make_method(method, lr)`` over
    BatchDataSet(x, y, batch) in order (gradients clipped to a global L2
    norm of ``clip``); returns the whole parameters."""
    crit = crit or nn.ClassNLLCriterion()
    opt = Optimizer(model, BatchDataSet(x, y, batch), crit,
                    optim_method=make_method(method, lr),
                    end_when=Trigger.max_iteration(steps),
                    strategy=strategy, device="cpu", **kw)
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.optimize()
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _LMCriterion():
    """The LM rows' criterion (``cli.perf``'s)."""
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion())


def _mesh(args):
    from bigdl_tpu_torch.parallel import make_mesh
    import torch.distributed as dist
    k = int(args.get("k", 2))
    return make_mesh({"data": dist.get_world_size() // k, "model": k})


# name -> (builder, x, y, global batch, train kwargs)
TP_MODELS = {
    "mlp": (mlp, "mlp_x", "mlp_y", 64, {}),
    "lm": (lm, "lm_x", "lm_y", 4, {"lr": 0.1, "crit": "lm"}),
    "gqa": (lambda: lm(2), "lm_x", "lm_y", 4, {"lr": 0.1, "crit": "lm"}),
    "drop": (dropout_mlp, "mlp_x", "mlp_y", 64, {}),
    "conv": (conv_net, "conv_x", "conv_y", 8, {"lr": 0.05}),
    # the global-norm clip across split and replicated leaves
    "clip": (lm, "lm_x", "lm_y", 4, {"lr": 0.1, "crit": "lm",
                                     "clip": 0.05}),
    # per-tensor norms of split leaves: the whole leaf's under tp
    "lars": (mlp, "mlp_x", "mlp_y", 64, {"lr": 1.0, "method": "lars"}),
    "lamb": (mlp, "mlp_x", "mlp_y", 64, {"lr": 0.01, "method": "lamb"}),
}


def train_named(name, inp, strategy=None):
    """Model ``name`` of TP_MODELS trained STEPS steps from ``inp``."""
    build, x, y, batch, kw = TP_MODELS[name]
    kw = dict(kw)
    if kw.get("crit") == "lm":
        kw["crit"] = _LMCriterion()
    m = load(build(), inp, {"clip": "lm", "lars": "mlp",
                            "lamb": "mlp"}.get(name, name))
    strat = strategy(m) if strategy is not None else None
    return train(m, inp[x], inp[y], batch, STEPS, strat, **kw)


def case_tp(args, inp):
    """``args["models"]`` of TP_MODELS under ``TensorParallel``
    (``--strategy tp`` at K = args["k"] over the job's ranks)."""
    from bigdl_tpu_torch.parallel import TensorParallel
    out = {}
    mesh = _mesh(args)
    for name in args["models"]:
        out.update({f"{name}/{k}": v for k, v in train_named(
            name, inp, lambda m: TensorParallel(mesh, m)).items()})
    return out


CASES = {"tp": case_tp}


def run_all(args):
    """Each case in ``args["cases"]``, writing ``<case>_r<rank>.npz``;
    with ``args["runs"]``, each run's overrides of ``args`` in turn in
    this one job, its files named ``<prefix><case>_r<rank>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = dist.get_rank()
    inp = np.load(os.path.join(args["dir"], "inputs.npz"))
    info = {}
    for run in args.get("runs") or [{}]:
        a = {**args, **run}
        pre = a.get("prefix", "")
        for name in a["cases"]:
            got = CASES[name](a, inp)
            info[pre + name] = len(got)
            np.savez(os.path.join(a["dir"], f"{pre}{name}_r{rank}.npz"),
                     **got)
    return info


def case_fsdp(args, inp):
    """The MLP, the conv net (synced BN) and the LM under
    ``FullyShardedDataParallel`` and under ``DataParallel``, with the
    hooks' accounting."""
    from bigdl_tpu_torch.parallel import (DataParallel,
                                          FullyShardedDataParallel,
                                          local_mesh)
    out = {}
    for kind, make in (("fsdp", FullyShardedDataParallel),
                       ("dp", DataParallel)):
        mesh = local_mesh()
        for name, model, x, y, batch, kw in (
                ("mlp", mlp, "mlp_x", "mlp_y", 64, {}),
                ("conv", conv_net, "conv_x", "conv_y", 8, {"lr": 0.05}),
                ("lm", lm, "lm_x", "lm_y", 4, {"lr": 0.1})):
            m = load(model(), inp, name)
            strat = make(mesh)
            if name == "lm":
                kw = dict(kw, crit=_LMCriterion())
            out.update({f"{kind}/{name}/{k}": v for k, v in train(
                m, inp[x], inp[y], batch, STEPS, strat, **kw).items()})
            if kind == "fsdp":
                out[f"acct/{name}"] = np.asarray(
                    [strat.gathers, strat.max_whole_modules,
                     len(strat._module_params)], np.int64)
    # what a rank holds once placed: its own parameters' storage and
    # optimizer state only
    from bigdl_tpu_torch.interop.checkpoint import model_tensors
    m = load(lm(), inp, "lm")
    params = dict(m.named_parameters())
    total = sum(p.numel() * p.element_size() for p in params.values())
    strat = FullyShardedDataParallel(local_mesh())
    method = SGD(0.1, momentum=0.9)
    _, _, state = strat.bind(m).place(params, model_tensors(m)[1],
                                      method.init(params))
    out["resident"] = np.asarray([strat.resident_bytes(), total, sum(
        v.numel() * v.element_size() for v in state["velocity"].values())])
    strat.unplace(m)
    return out


CASES["fsdp"] = case_fsdp


SERVE_LM = dict(vocab=50, d_model=32, num_layers=2, num_heads=2, max_len=64)
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # one 16-token page
PROMPTS = [(SHARED + [2, 3], {}), (SHARED + [7, 1], {}),  # a prefix hit
           ([8, 6, 7], dict(temperature=1.5, top_k=5, top_p=0.9, seed=11))]
ENGINES = {"plain": {}, "dense_spec": dict(speculate=3),
           "paged": dict(kv_page_tokens=16, speculate=3, prefix_cache=True)}


def serve_lm(num_kv_heads=None):
    return models.TransformerLM(SERVE_LM["vocab"],
                                d_model=SERVE_LM["d_model"],
                                num_layers=SERVE_LM["num_layers"],
                                num_heads=SERVE_LM["num_heads"],
                                max_len=SERVE_LM["max_len"],
                                num_kv_heads=num_kv_heads)


def _decode(model, link, kw):
    """Each PROMPTS' 8 tokens through a DecodeEngine of ``kw`` (the
    leader's; a follower serves until the leader closes)."""
    from bigdl_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, slots=2, device="cpu", graphs=False, tp=link,
                       **kw)
    if link is not None and not link.leader:
        link.serve()
        return None
    try:
        return [eng.generate(p, 8, **o) for p, o in PROMPTS]
    finally:
        eng.close()
        if link is not None:
            link.close()


def case_serve(args, inp):
    """tp:K decoding (K the job's ranks) of the serving LM, from its
    weights or from a checkpoint written under tp
    (``restore_for_serving``), for each engine of ENGINES; the page-pool
    round trip on this rank's head slice; /predict scores."""
    import torch.distributed as dist
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.sharding import (ServingSharding, TPLink,
                                                  restore_for_serving,
                                                  serving_mesh)
    out = {}
    mesh = serving_mesh()
    sh = ServingSharding(mesh)
    ck = args.get("ckpt")
    for name, kw in ENGINES.items():
        model = load(serve_lm(), inp, "serve")
        if ck and name == "paged":
            model.load_state_dict({**restore_for_serving(ck, model)[0]},
                                  strict=False)
        sh.place_params(model)
        toks = _decode(model, TPLink(mesh), kw)
        if toks is not None:
            out[f"tokens/{name}"] = np.asarray(
                [t + [-1] * (8 - len(t)) for t in toks], np.int64)
    # a page pool on this rank's KV heads: scatter, copy, gather
    from bigdl_tpu_torch.serving.kv_pages import (PagedKvCache, copy_pages,
                                                  gather_cache,
                                                  scatter_pages)
    model = sh.place_params(load(serve_lm(), inp, "serve"))
    kv = PagedKvCache(model.encoder, slots=2, max_len=64, page_tokens=16,
                      dtype=torch.float32, device="cpu")
    assert kv.reserve(0, 64)
    cache = [{n: torch.from_numpy(inp[f"pool/{i}/{n}"]).narrow(
        1, mesh.rank * model.encoder[0].mha.num_kv_heads,
        model.encoder[0].mha.num_kv_heads).contiguous()
        for n in ("k", "v")} for i in range(SERVE_LM["num_layers"])]
    pages = kv.page_table[0]
    scatter_pages(kv.pools, cache, pages)
    copy_pages(kv.pools, pages[:2], pages[2:4])
    got = gather_cache(kv.pools, pages)
    for i, layer in enumerate(got):
        for n, t in layer.items():
            out[f"pool/{i}/{n}"] = t.numpy()
    # /predict through the leader
    link = TPLink(mesh)
    eng = InferenceEngine(model, buckets=(2,), device="cpu", graphs=False,
                          tp=link)
    if link.leader:
        out["predict"] = eng.predict_scores(inp["predict_x"])
        link.close()
    else:
        link.serve()
    out["kv_spec"] = np.asarray([len(sh.kv_spec(np.zeros((4, 2, 64, 16)))),
                                 len(sh.kv_spec(np.zeros((4, 3, 64, 16))))])
    dist.barrier()
    return out


def case_tp_ckpt(args, inp):
    """Two SGD steps of the serving LM under TensorParallel with a
    checkpoint at the end (``args["ckpt"]``); then that checkpoint resumed
    under FullyShardedDataParallel for two more steps (one topology into
    another), saved as ``resumed/<name>``."""
    from bigdl_tpu_torch.parallel import (FullyShardedDataParallel,
                                          TensorParallel, local_mesh)

    def optimizer(m, strategy, steps):
        return Optimizer(m, BatchDataSet(inp["serve_x"], inp["serve_y"], 4),
                         _LMCriterion(), optim_method=SGD(0.1, momentum=0.9),
                         end_when=Trigger.max_iteration(steps),
                         strategy=strategy, device="cpu")

    m = load(serve_lm(), inp, "serve")
    opt = optimizer(m, TensorParallel(_mesh(args), m), 2)
    opt.set_checkpoint(Trigger.several_iteration(2), args["ckpt"])
    opt.optimize()
    out = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    r = serve_lm()
    optimizer(r, FullyShardedDataParallel(local_mesh()), 4).resume(
        args["ckpt"]).optimize()
    out.update({f"resumed/{k}": v.detach().numpy().copy()
                for k, v in r.state_dict().items()})
    return out


CASES["serve"] = case_serve
CASES["tp_ckpt"] = case_tp_ckpt


def case_serve_cli(args, inp):
    """``serve --strategy tp:K`` through ``cli.serve.build_app`` on every
    rank: rank 0's app answers /generate and /predict (its dispatch, no
    socket), then closes and releases the followers."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    argv = ["transformer_lm", "--randomInit", "--platform", "cpu",
            "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
            "--numHeads", "2", "--seq", "64", "--slots", "2",
            "--buckets", "1,2", "--strategy", f"tp:{args['k']}"] + \
        args.get("extra", [])
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser()
                                       .parse_args(argv))
    if getattr(app, "follower", False):
        app.serve()
        app.close()
        return {}
    out = {}
    try:
        for i, (p, o) in enumerate(PROMPTS):
            st, body = app.dispatch_post("/generate", {
                "tokens": p, "max_new_tokens": 8, **o})
            assert st == 200, body
            out[f"gen/{i}"] = np.asarray(body["tokens"])
        st, body = app.dispatch_post("/predict", {
            "inputs": inp["predict_x"].tolist(), "return_scores": True})
        assert st == 200, body
        out["scores"] = np.asarray(body["scores"])
        page = app.handle_metrics()
        out["prov_ok"] = np.asarray([f'serving_tp="{args["k"]}"' in page])
    finally:
        app.close()
    return out


CASES["serve_cli"] = case_serve_cli


# the image model of the serving strategies case, and its flags
IMAGE_ARGV = ["resnet20_cifar", "--randomInit", "--platform", "cpu",
              "--classes", "10", "--buckets", "1,2,4"]
LM_ARGV = ["transformer_lm", "--randomInit", "--platform", "cpu",
           "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
           "--numHeads", "2", "--seq", "64", "--slots", "2",
           "--buckets", "1,2"]
STRATEGIES = ("tp:2", "dp:2+tp:2")


def _serve_image(argv, x):
    """/predict scores of ``x`` (rows sent one request a row pair) and the
    /metrics page from rank 0 of ``serve argv``; {} on a follower."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser()
                                       .parse_args(argv))
    if getattr(app, "follower", False):
        try:
            app.serve()
        finally:
            app.close()
        return None, None
    try:
        scores = []
        for i in range(0, len(x), 2):
            st, body = app.dispatch_post("/predict", {
                "inputs": x[i:i + 2].tolist(), "return_scores": True})
            assert st == 200, body
            scores.append(np.asarray(body["scores"]))
        return np.concatenate(scores), app.handle_metrics()
    finally:
        app.close()


def case_serve_strategies(args, inp):
    """``serve`` and ``batch-predict`` at tp:2 and dp:2+tp:2 on every rank:
    the image model's /predict scores and /metrics page, its batch-predict
    shards over ``args["shards"]``, and the LM's dp:2+tp:2 /generate
    tokens and /predict scores (rank 0's)."""
    from bigdl_tpu_torch.cli import batch_predict
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import bulk
    out = {}
    for strat in STRATEGIES:
        tag = strat.replace(":", "").replace("+", "_")
        scores, page = _serve_image(IMAGE_ARGV + ["--strategy", strat],
                                    inp["image_x"])
        if scores is not None:
            out[f"image/{tag}"] = scores
            out[f"metrics/{tag}"] = np.frombuffer(page.encode(), np.uint8)
        d = os.path.join(args["dir"], f"bp_{tag}")
        rep = batch_predict.main(
            ["--modelName", "resnet20_cifar", "--randomInit", "-f",
             "record:" + args["shards"], "--out", d, "-b", "4",
             "--classNum", "10", "--scores", "--platform", "cpu",
             "--strategy", strat])
        if rep is not None:
            rows = bulk.merge_shards(d)
            out[f"bp/{tag}/i"] = np.asarray([r["i"] for r in rows])
            out[f"bp/{tag}/scores"] = np.asarray([r["scores"] for r in rows])
            out[f"bp/{tag}/groups"] = np.asarray([rep["groups"], rep["tp"]])
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser().parse_args(
        LM_ARGV + ["--strategy", "dp:2+tp:2"]))
    if getattr(app, "follower", False):
        try:
            app.serve()
        finally:
            app.close()
        return out
    try:
        for i, (p, o) in enumerate(PROMPTS):
            st, body = app.dispatch_post("/generate", {
                "tokens": p, "max_new_tokens": 8, **o})
            assert st == 200, body
            out[f"lm/gen/{i}"] = np.asarray(body["tokens"])
        st, body = app.dispatch_post("/predict", {
            "inputs": inp["predict_x"].tolist(), "return_scores": True})
        assert st == 200, body
        out["lm/scores"] = np.asarray(body["scores"])
    finally:
        app.close()
    return out


CASES["serve_strategies"] = case_serve_strategies


def case_perf(args, inp):
    """``cli.perf`` rows at ``--strategy tp`` (a small LM row) and the
    time-to-accuracy run at ``--strategy dp`` with ``--gradCompress``."""
    from bigdl_tpu_torch.cli import perf
    perf.LM_CONFIGS["tp_test_lm"] = dict(d_model=32, num_layers=2,
                                         num_heads=4, max_len=16,
                                         pos_encoding="rope", num_kv_heads=2)
    line = perf.run("tp_test_lm", batch=4, iterations=2, warmup=1,
                    dtype=torch.float32, device="cpu", seq_len=16,
                    strategy="tp")
    tta = perf.run_time_to_acc(
        "resnet20_cifar", 8, 0.99, max_epochs=1, image_size=32,
        train_per_class=2, val_per_class=1, use_bf16=False, device="cpu",
        strategy="dp", grad_compress="bf16", grad_buckets="1")
    return {"losses": np.asarray(line["losses"]),
            "tp_line": np.asarray([line["n_devices"],
                                   line["mesh"]["model"],
                                   int(line["strategy"] == "tp")]),
            "tta": np.asarray([int(tta["grad_compress"] == "bf16"),
                               tta["grad_buckets"] or 0,
                               int(tta["val_points"] >= 1)])}


CASES["perf"] = case_perf
