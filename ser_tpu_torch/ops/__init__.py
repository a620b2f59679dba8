"""Tensor ops of the MARN1_onlysp eval path, counterparts of ``ser_tpu.ops``."""
