from bigdl_tpu_torch.optim.method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.schedules import (Default, EpochSchedule,
                                             LearningRateSchedule, Regime)
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod)
from bigdl_tpu_torch.optim.validator import Validator

__all__ = ["AccuracyResult", "Adam", "Default", "EpochSchedule",
           "LearningRateSchedule", "Loss", "LossResult", "Metrics",
           "OptimMethod", "Optimizer", "Regime", "SGD", "Top1Accuracy",
           "Top5Accuracy", "TrainedModel", "Trigger", "ValidationMethod",
           "Validator"]
