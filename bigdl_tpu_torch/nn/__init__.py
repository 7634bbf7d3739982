from bigdl_tpu_torch.core.module import Identity, Sequential
from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEncoding,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          apply_rope, dot_product_attention,
                                          make_segment_mask, rope_tables)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.norm import (BatchNormalization,
                                     SpatialBatchNormalization,
                                     bn_fused_mode, set_bn_fused,
                                     set_bn_stat_sample)
from bigdl_tpu_torch.nn.pool import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.structural import (CAddTable, ConcatTable, Dropout,
                                           Padding, Reshape, absorb_bn_relu)

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion",
           "ConcatTable", "Dropout", "Identity", "LayerNorm", "Linear",
           "LogSoftMax", "LookupTable", "MultiHeadAttention", "Padding",
           "PositionalEncoding", "ReLU", "Reshape", "Sequential",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling",
           "TimeDistributedCriterion", "TransformerEncoder",
           "TransformerEncoderLayer", "absorb_bn_relu", "apply_rope",
           "bn_fused_mode", "dot_product_attention", "make_segment_mask",
           "rope_tables", "set_bn_fused", "set_bn_stat_sample"]
