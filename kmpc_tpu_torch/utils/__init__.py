"""Weight import from kmpc_tpu run directories."""
