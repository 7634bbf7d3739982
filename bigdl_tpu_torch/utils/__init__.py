"""Host-side utilities of the port (counterpart of ``bigdl_tpu/utils``)."""

from bigdl_tpu_torch.utils.gradcheck import check_gradients, numerical_grad

__all__ = ["check_gradients", "numerical_grad"]
