from bigdl_tpu_torch.core.criterion import Criterion
from bigdl_tpu_torch.core.module import (Container, ElementwiseModule,
                                         Identity, Lambda, Module, Sequential,
                                         SimpleModule, resolve_device,
                                         uniform_fan_in, xavier_uniform)
from bigdl_tpu_torch.core.pytree import (flatten_params, tree_add, tree_cast,
                                         tree_global_norm, tree_scale,
                                         tree_size, tree_zeros_like)

__all__ = ["Container", "Criterion", "ElementwiseModule", "Identity",
           "Lambda", "Module", "Sequential", "SimpleModule", "flatten_params",
           "resolve_device", "tree_add", "tree_cast", "tree_global_norm",
           "tree_scale", "tree_size", "tree_zeros_like", "uniform_fan_in",
           "xavier_uniform"]
