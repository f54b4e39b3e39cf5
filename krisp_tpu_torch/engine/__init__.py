"""Host orchestration of the device operators (counterpart of
``krisp_tpu.engine``)."""
