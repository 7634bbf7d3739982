from bigdl_tpu_torch.interop.caffe import (load_caffe, parse_caffemodel,
                                          parse_prototxt)
from bigdl_tpu_torch.interop.checkpoint import (load_model, load_state,
                                               save_model, save_state)
from bigdl_tpu_torch.interop.from_jax import (load_jax, params_from_jax,
                                             tensors_from_jax)
from bigdl_tpu_torch.interop.torch_import import (TorchFlatten,
                                                 load_torch_module,
                                                 save_torch_module)
from bigdl_tpu_torch.interop.torchfile import (TorchObject, load_t7,
                                              load_torch_params, save_t7)

__all__ = [
    "load_t7", "save_t7", "TorchObject", "load_torch_params",
    "load_torch_module", "save_torch_module", "TorchFlatten",
    "parse_caffemodel", "parse_prototxt", "load_caffe",
    "load_jax", "params_from_jax", "tensors_from_jax", "load_model",
    "load_state", "save_model", "save_state",
]
