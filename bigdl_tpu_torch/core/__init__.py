from bigdl_tpu_torch.core.criterion import Criterion
from bigdl_tpu_torch.core.module import resolve_device, xavier_uniform

__all__ = ["Criterion", "resolve_device", "xavier_uniform"]
