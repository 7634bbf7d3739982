from bigdl_tpu_torch.interop.checkpoint import (load_model, load_state,
                                               save_model, save_state)
from bigdl_tpu_torch.interop.from_jax import (load_jax, params_from_jax,
                                             tensors_from_jax)

__all__ = ["load_jax", "params_from_jax", "tensors_from_jax", "load_model",
           "load_state", "save_model", "save_state"]
