from bigdl_tpu_torch.models.alexnet import alexnet
from bigdl_tpu_torch.models.autoencoder import autoencoder
from bigdl_tpu_torch.models.inception import (inception_module, inception_v1,
                                              inception_v1_no_aux,
                                              inception_v2)
from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.resnet import (SpaceToDepthStem, basic_block,
                                           bottleneck_block, resnet, resnet50,
                                           resnet_cifar)
from bigdl_tpu_torch.models.rnn import (birnn_classifier, lstm_classifier,
                                        simple_rnn, text_cnn)
from bigdl_tpu_torch.models.transformer_lm import (PackedNLLCriterion,
                                                  TransformerLM,
                                                  packed_lm_targets,
                                                  transformer_lm)
from bigdl_tpu_torch.models.vgg import vgg16, vgg19, vgg_for_cifar10
from bigdl_tpu_torch.models.vit import ViT, vit, vit_b16, vit_s16

__all__ = ["PackedNLLCriterion", "SpaceToDepthStem", "TransformerLM", "ViT",
           "alexnet", "autoencoder", "basic_block", "birnn_classifier",
           "bottleneck_block", "inception_module", "inception_v1",
           "inception_v1_no_aux", "inception_v2", "lenet5",
           "lstm_classifier", "packed_lm_targets", "resnet", "resnet50",
           "resnet_cifar", "simple_rnn", "text_cnn", "transformer_lm",
           "vgg16", "vgg19", "vgg_for_cifar10", "vit", "vit_b16", "vit_s16"]
