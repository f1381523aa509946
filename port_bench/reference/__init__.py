"""The plain reference the benchmark holds jpeg_tpu_torch to: torch and the
standard library only, nothing of the program."""
