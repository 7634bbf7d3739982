from bigdl_tpu_torch.dataset.cifar import TRAIN_MEAN, TRAIN_STD, load_cifar10
from bigdl_tpu_torch.dataset.dataset import BatchDataSet, DataSet, MiniBatch
from bigdl_tpu_torch.dataset.text import Dictionary, pack_sequences, tokenize

__all__ = ["BatchDataSet", "DataSet", "Dictionary", "MiniBatch",
           "TRAIN_MEAN", "TRAIN_STD", "load_cifar10", "pack_sequences",
           "tokenize"]
