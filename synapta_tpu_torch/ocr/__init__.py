"""ocr — see the synapta_tpu_torch package docstring."""
