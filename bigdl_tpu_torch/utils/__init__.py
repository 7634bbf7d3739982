"""Host-side utilities of the port (counterpart of ``bigdl_tpu/utils``).
The gradient check loads on first use: ``utils.kineto`` and
``utils.table`` (which the fleet router reaches through ``obs``) import
no torch."""

__all__ = ["check_gradients", "numerical_grad"]


def __getattr__(name):
    if name in __all__:
        from bigdl_tpu_torch.utils import gradcheck
        return getattr(gradcheck, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
