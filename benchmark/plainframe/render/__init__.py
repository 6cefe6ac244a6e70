"""Host side and frame graph of the port (counterparts of datum_tpu/render)."""
