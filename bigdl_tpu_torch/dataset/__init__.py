from bigdl_tpu_torch.dataset.dataset import BatchDataSet, DataSet, MiniBatch
from bigdl_tpu_torch.dataset.text import Dictionary, pack_sequences, tokenize

__all__ = ["BatchDataSet", "DataSet", "Dictionary", "MiniBatch",
           "pack_sequences", "tokenize"]
