"""Device ops of the port (counterparts of datum_tpu/ops)."""
