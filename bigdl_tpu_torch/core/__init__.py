from bigdl_tpu_torch.core.criterion import Criterion
from bigdl_tpu_torch.core.module import (Identity, Sequential, resolve_device,
                                         uniform_fan_in, xavier_uniform)

__all__ = ["Criterion", "Identity", "Sequential", "resolve_device",
           "uniform_fan_in", "xavier_uniform"]
