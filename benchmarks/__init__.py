"""The benchmark of ``pointnetgpd_tpu_torch`` (see run.py)."""
