"""Host-side utilities of the port (counterpart of ``bigdl_tpu/utils``)."""
