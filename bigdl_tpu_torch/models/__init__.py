from bigdl_tpu_torch.models.resnet import (basic_block, bottleneck_block,
                                           resnet, resnet50, resnet_cifar)
from bigdl_tpu_torch.models.transformer_lm import (PackedNLLCriterion,
                                                  TransformerLM,
                                                  packed_lm_targets,
                                                  transformer_lm)

__all__ = ["PackedNLLCriterion", "TransformerLM", "basic_block",
           "bottleneck_block", "packed_lm_targets", "resnet", "resnet50",
           "resnet_cifar", "transformer_lm"]
