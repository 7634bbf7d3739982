from bigdl_tpu_torch.models.transformer_lm import (PackedNLLCriterion,
                                                  TransformerLM,
                                                  packed_lm_targets,
                                                  transformer_lm)

__all__ = ["PackedNLLCriterion", "TransformerLM", "packed_lm_targets",
           "transformer_lm"]
