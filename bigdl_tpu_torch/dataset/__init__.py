from bigdl_tpu_torch.dataset import image, native
from bigdl_tpu_torch.dataset.cifar import TRAIN_MEAN, TRAIN_STD, load_cifar10
from bigdl_tpu_torch.dataset.dataset import (BatchDataSet, DataSet,
                                             LocalArrayDataSet, MiniBatch,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.distributed import ShardedDataSet, host_shard
from bigdl_tpu_torch.dataset.folder import (IMAGENET_MEAN, IMAGENET_STD,
                                            ImageFolderDataSet,
                                            list_image_folder,
                                            load_image_folder)
from bigdl_tpu_torch.dataset.mixup import CutMix, Mixup, MixupCriterion
from bigdl_tpu_torch.dataset.mnist import load_mnist
from bigdl_tpu_torch.dataset.native import NativePrefetchDataSet
from bigdl_tpu_torch.dataset.pipeline import (ArraySampleSource,
                                              DeviceBatch, EpochPlan,
                                              ExecutorDataSet, StagedDataSet,
                                              StreamingSampleSource,
                                              wrap_pipeline)
from bigdl_tpu_torch.dataset.prefetch import PrefetchDataSet
from bigdl_tpu_torch.dataset.recordfile import (RecordReader, RecordWriter,
                                                list_shards,
                                                write_image_shards)
from bigdl_tpu_torch.dataset.streaming import (RecordImageDataSet,
                                               StreamingImageFolder)
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          LabeledSentenceToSample,
                                          pack_sequences, pad_sequences,
                                          sentences_to_ids, tokenize)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FnTransformer, Transformer)

__all__ = ["image", "native", "TRAIN_MEAN", "TRAIN_STD", "load_cifar10",
           "BatchDataSet", "DataSet", "LocalArrayDataSet", "MiniBatch",
           "TransformedDataSet", "ShardedDataSet", "host_shard",
           "IMAGENET_MEAN", "IMAGENET_STD", "ImageFolderDataSet",
           "list_image_folder", "load_image_folder", "CutMix", "Mixup",
           "MixupCriterion", "load_mnist", "NativePrefetchDataSet",
           "ArraySampleSource",
           "DeviceBatch", "EpochPlan", "ExecutorDataSet", "StagedDataSet",
           "StreamingSampleSource", "wrap_pipeline", "PrefetchDataSet",
           "RecordReader", "RecordWriter", "list_shards",
           "write_image_shards", "RecordImageDataSet",
           "StreamingImageFolder", "Dictionary", "LabeledSentence",
           "LabeledSentenceToSample", "pack_sequences", "pad_sequences",
           "sentences_to_ids", "tokenize", "ChainedTransformer",
           "FnTransformer", "Transformer"]
