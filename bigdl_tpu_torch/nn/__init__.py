"""bigdl_tpu_torch.nn: the layer zoo (counterpart of ``bigdl_tpu.nn``), with
the core module bases the JAX package exports beside it."""

from bigdl_tpu_torch.core.module import (Container, Identity, Lambda, Module,
                                         Sequential)
from bigdl_tpu_torch.nn import (activation, attention, conv, criterion,
                                linear, moe, norm, pool, recurrent,
                                structural)
from bigdl_tpu_torch.nn.activation import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.attention import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.conv import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.criterion import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.linear import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.moe import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.norm import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.pool import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.recurrent import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.structural import *  # noqa: F401,F403

__all__ = sorted(["Container", "Identity", "Lambda", "Module", "Sequential"]
                 + [n for m in (activation, attention, conv, criterion, linear,
                                moe, norm, pool, recurrent, structural)
                    for n in m.__all__])
