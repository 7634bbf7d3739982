from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEncoding,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          apply_rope, dot_product_attention,
                                          make_segment_mask, rope_tables)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.linear import LookupTable
from bigdl_tpu_torch.nn.structural import Dropout

__all__ = ["ClassNLLCriterion", "Dropout", "LayerNorm", "LookupTable",
           "MultiHeadAttention", "PositionalEncoding",
           "TimeDistributedCriterion", "TransformerEncoder",
           "TransformerEncoderLayer", "apply_rope", "dot_product_attention",
           "make_segment_mask", "rope_tables"]
