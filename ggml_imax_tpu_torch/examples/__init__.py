"""The example CLIs (counterparts of the JAX package's examples/): one
module each, run as ``python -m ggml_imax_tpu_torch.examples.<name>``, each
with ``main(argv)``. They run on the card; ``--device cpu`` runs the plain
PyTorch versions on the host."""
