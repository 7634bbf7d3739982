"""``serve`` with an image classifier: ``resnet20_cifar --classes 10`` on
a checkpoint the JAX package wrote, served over HTTP by the port
(``cli.serve.build_app``), its ``/predict`` scores held against the JAX
``InferenceEngine`` on the same parameters and running statistics within
1e-4 (f32 convolutions summed in another order); plain, and with
``--fusedBN apply --autotune cached`` (an eval-mode BN reads its running
statistics, so the scores are the same program's)."""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import InferenceEngine as JaxInferenceEngine
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import tuning
from bigdl_tpu_torch.cli import serve as serve_cli
from bigdl_tpu_torch.ops import conv2d as c2d
from bigdl_tpu_torch.serving.server import make_server


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX resnet_cifar(20) checkpoint with seeded running statistics
    (so eval-mode BN is not the identity)."""
    jm = jax_models.resnet_cifar(20, 10)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)

    def stat(path, x):
        x = np.asarray(x)
        if "var" in jax.tree_util.keystr(path):
            return (0.5 + rs.rand(*x.shape)).astype(x.dtype)
        return (0.1 * rs.randn(*x.shape)).astype(x.dtype)

    state = jax.tree_util.tree_map_with_path(stat, jm.init_state())
    d = tmp_path_factory.mktemp("ck")
    jfile.save_pytree({"params": params, "mod_state": state},
                      str(d / "model.1"))
    return jm, params, state, str(d)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("extra", [[], ["--fusedBN", "apply", "--autotune",
                                        "cached"]],
                         ids=["plain", "fused_cached"])
def test_vision_predict_matches_jax_engine(jax_ckpt, extra, tmp_path,
                                           monkeypatch):
    jm, params, state, ck = jax_ckpt
    monkeypatch.setenv("BIGDL_TPU_AUTOTUNE_CACHE", str(tmp_path))
    tuning.reset()
    args = serve_cli.build_parser().parse_args(
        ["resnet20_cifar", "--classes", "10", "--model", ck, "--platform",
         "cpu", "--buckets", "1,2,4", "--port", "0"] + extra)
    try:
        app, engine, in_shape, in_dtype = serve_cli.build_app(args)
        assert tuple(in_shape) == (32, 32, 3) and in_dtype == np.float32
        assert engine.lengths is None
        srv = make_server(app, "127.0.0.1", 0)
        thr = threading.Thread(target=srv.serve_forever, daemon=True)
        thr.start()
        port = srv.server_address[1]
        x = np.random.RandomState(2).randn(7, 32, 32, 3).astype(np.float32)
        try:
            outs = [_post(port, {"inputs": x[i:j].tolist(),
                                 "return_scores": True})
                    for i, j in ((0, 5), (5, 7))]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=30) as r:
                health = r.status
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=30) as r:
                page = r.read().decode()
        finally:
            srv.shutdown()
            srv.server_close()
            app.close()
            thr.join(10.0)
        assert health == 200 and all(st == 200 for st, _ in outs)
        got = np.concatenate([np.asarray(o["scores"], np.float32)
                              for _, o in outs])
        assert sum((o["predictions"] for _, o in outs), []) == \
            got.argmax(-1).tolist()
        ref = JaxInferenceEngine(jm, params, state,
                                 buckets=(1, 2, 4)).predict_scores(x)
        assert got.shape == (7, 10)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
        prov = json.loads([ln for ln in page.splitlines()
                           if ln.startswith("# provenance ")][0][13:])
        assert prov["classes"] == 10 and prov["in_shape"] == "32,32,3"
        assert prov["autotune"] == ("cached" if extra else "off")
        assert prov["fused_bn"] == ("apply" if extra else "off")
        if extra:
            from bigdl_tpu_torch.nn import bn_fused_mode
            assert bn_fused_mode(engine.module) == "apply"
            ann = tuning.annotation()["decisions"]
            # the forward consulted each conv geometry's fwd decision
            # only (no backward when serving); none is cached here
            assert ann and all(k.startswith("conv_geom|") and "pass=fwd" in k
                               and v == "default" for k, v in ann.items())
            assert not os.listdir(tmp_path)  # cached never writes
    finally:
        tuning.reset()
        c2d.reset_conv_pass_layouts()
