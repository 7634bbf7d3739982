"""The long-context LM rows of the port's ``cli.perf``
(``transformer_lm_16k``/``_32k``) against the JAX harness's, on the CPU:
their configurations equal the JAX rows' (widths, heads, KV heads,
lengths, RoPE, remat); at a small width and seq 256, remat "dots" and
"full" give remat-off's loss and gradients through the flash Function
(its plain twins here), the flash forward recomputed in the backward;
and each row runs through ``cli.perf`` at that width, eager and graphed,
with its own remat."""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu.cli import perf as jperf
from bigdl_tpu_torch import models
from bigdl_tpu_torch.cli import perf
from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
from bigdl_tpu_torch.ops import attention_kernel as ak

ROWS = {"transformer_lm_16k": (16384, "dots"),
        "transformer_lm_32k": (32768, "full")}
SMALL = dict(d_model=64, num_layers=2, num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_config_equals_the_jax_row(row):
    jm, jshape = jperf.build_model(row)
    cfg = perf.LM_CONFIGS[row]
    mha = jm.encoder._modules[0].mha
    seq, remat = ROWS[row]
    assert jshape == (seq,) and cfg["max_len"] == jm.max_len == seq
    assert (cfg["d_model"], cfg["num_layers"], cfg["num_heads"],
            cfg["num_kv_heads"]) == (jm.d_model, len(jm.encoder._modules),
                                     mha.num_heads, mha.num_kv_heads) == \
        (1024, 12, 8, 2)
    assert mha.head_dim == 128 and jm.rope and cfg["pos_encoding"] == "rope"
    assert cfg["remat"] == jm.encoder.remat == remat


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_remat_offs_loss_and_gradients(remat, monkeypatch):
    """The same weights and tokens with remat off and on: equal loss and
    gradients (1e-6 of max|g|), and each layer's flash forward runs again
    in the backward."""
    calls = []
    real = ak.flash_fwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ak, "flash_fwd", counted)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, 97, (2, 256)).astype(np.int64))
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    out = {}
    for r in (False, remat):
        m = models.transformer_lm(
            97, max_len=256, pos_encoding="rope", attn_impl="flash",
            remat=r, generator=torch.Generator().manual_seed(0), **SMALL)
        m.train()
        calls.clear()
        loss = crit(m(toks[:, :-1]), toks[:, 1:])
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[r] = (float(loss.detach()), grads, len(calls))
    assert out[False][2] == 2 and out[remat][2] == 4
    assert out[remat][0] == out[False][0]
    scale = max(float(g.abs().max()) for g in out[False][1])
    for g0, g1 in zip(out[False][1], out[remat][1]):
        assert float((g0 - g1).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("row", sorted(ROWS))
def test_row_through_cli_perf(row, monkeypatch, capsys):
    """The row at a small width (its remat kept) through ``cli.perf``'s
    command line at --seq 256, eager and as graphed steps: its line names
    the row's remat, the losses are finite, the flash count is in."""
    monkeypatch.setitem(perf.LM_CONFIGS, row, dict(perf.LM_CONFIGS[row],
                                                   **SMALL))
    for extra in ([], ["--innerSteps", "2"]):
        out = perf.main(["-m", row, "--platform", "cpu", "--seq", "256",
                         "-b", "1", "-i", "1", "--f32"] + extra)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["remat"] == ROWS[row][1]
        assert line["tokens_per_second"] > 0
        assert all(np.isfinite(out["losses"]))
