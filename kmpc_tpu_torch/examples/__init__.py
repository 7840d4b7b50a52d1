"""Runnable walkthroughs of kmpc_tpu_torch."""
