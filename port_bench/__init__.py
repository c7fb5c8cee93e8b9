"""The benchmark of spectral_tpu_torch on the H100: see README.md."""
