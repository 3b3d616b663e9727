"""Optimizers (``adamw``: AdamW and Adafactor), the learning-rate schedule
(``schedule``) and int8 error-feedback gradient compression
(``compression``), as plain functions on trees of tensors."""
