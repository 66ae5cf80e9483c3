"""See the package docstring of cim_tpu_torch."""
