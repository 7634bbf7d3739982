"""The tiny LM that the port's fleet tests serve (``LM_ARGS``, the serve
CLI's flags), and its seeded checkpoints written by the JAX package, with
the JAX engine's greedy tokens as the reference."""

import jax
import numpy as np

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.utils.file import save_pytree

VOCAB, D, LAYERS, HEADS, MAX_LEN = 50, 32, 2, 2, 64
LM_ARGS = ["transformer_lm", "--vocabSize", str(VOCAB), "--dModel", str(D),
           "--numLayers", str(LAYERS), "--numHeads", str(HEADS), "--seq",
           str(MAX_LEN), "--slots", "2", "--buckets", "1,2", "--maxWaitMs",
           "2", "--no-warmup", "--kvPageTokens", "8", "--prefixCache"]


def jax_lm(d_model: int = D):
    return jax_models.transformer_lm(VOCAB, d_model=d_model,
                                     num_layers=LAYERS, num_heads=HEADS,
                                     max_len=MAX_LEN)


def random_tree(m, seed):
    """A seeded parameter tree of JAX model ``m`` (numpy draws on its
    shapes: the layer norms near 1, the embedding small, the products
    x3, so that greedy chains wander)."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] == "emb":
            return (0.05 * rs.standard_normal(s.shape)).astype(s.dtype)
        if keys[-1] == "weight" and keys[-2].startswith("ln"):
            return (1 + 0.1 * rs.standard_normal(s.shape)).astype(s.dtype)
        scale = 0.1 if len(s.shape) == 1 else 3 * s.shape[0] ** -0.5
        return (scale * rs.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(m.init, jax.random.PRNGKey(0)))


def save_jax_checkpoint(m, params, directory) -> str:
    """``params`` of JAX model ``m`` as ``<directory>/model.1``."""
    save_pytree({"params": params, "mod_state": m.init_state()},
                f"{directory}/model.1")
    return str(directory)


def jax_checkpoints(root, seeds, prompts, n_new: int = 8) -> dict:
    """{seed: {"path", "params", "tokens"}}: a JAX checkpoint of
    ``jax_lm()`` for each seed under ``root``, and the JAX engine's greedy
    ``n_new`` tokens of each prompt on it."""
    m = jax_lm()
    eng, out = None, {}
    for seed in seeds:
        params = random_tree(m, seed)
        path = save_jax_checkpoint(m, params, root / f"s{seed}")
        if eng is None:
            eng = JaxDecodeEngine(m, params, slots=1)
        eng.params = params  # the compiled programs take the tree
        out[seed] = dict(path=path, params=params,
                         tokens=[eng.generate(p, n_new) for p in prompts])
    eng.close()
    return out
