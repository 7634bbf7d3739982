from bigdl_tpu_torch.optim.method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.optim.triggers import Trigger

__all__ = ["Adam", "Default", "LearningRateSchedule", "Metrics",
           "OptimMethod", "Optimizer", "SGD", "TrainedModel", "Trigger"]
