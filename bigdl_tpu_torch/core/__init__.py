from bigdl_tpu_torch.core.criterion import Criterion
from bigdl_tpu_torch.core.module import (Container, ElementwiseModule,
                                         Identity, Lambda, Module, Sequential,
                                         SimpleModule, resolve_device,
                                         uniform_fan_in, xavier_uniform)

__all__ = ["Container", "Criterion", "ElementwiseModule", "Identity",
           "Lambda", "Module", "Sequential", "SimpleModule", "resolve_device",
           "uniform_fan_in", "xavier_uniform"]
