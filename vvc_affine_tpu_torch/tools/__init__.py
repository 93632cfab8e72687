"""Command-line tools of the port, each named after its counterpart in the
JAX repository's ``tools/`` (run as ``python -m
vvc_affine_tpu_torch.tools.<name>``)."""
