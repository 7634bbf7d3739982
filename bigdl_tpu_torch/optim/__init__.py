from bigdl_tpu_torch.optim.method import (EMA, LAMB, LARS, SGD, Adagrad, Adam,
                                          AdamW, OptimMethod, RMSprop,
                                          clip_by_global_norm, clip_by_value)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.schedules import (CosineAnnealing, Default,
                                             EpochDecay, EpochSchedule,
                                             EpochStep, LearningRateSchedule,
                                             Poly, Regime, Step, Warmup)
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Perplexity,
                                              PerplexityResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod)
from bigdl_tpu_torch.optim.validator import Validator

__all__ = ["AccuracyResult", "Adagrad", "Adam", "AdamW", "CosineAnnealing",
           "Default", "EMA", "EpochDecay", "EpochSchedule", "EpochStep",
           "LAMB", "LARS", "LearningRateSchedule", "Loss", "LossResult",
           "Metrics", "OptimMethod", "Optimizer", "Perplexity",
           "PerplexityResult", "Poly", "RMSprop", "Regime", "SGD", "Step",
           "Top1Accuracy", "Top5Accuracy", "TrainedModel", "Trigger",
           "ValidationMethod", "Validator", "Warmup", "clip_by_global_norm",
           "clip_by_value"]
