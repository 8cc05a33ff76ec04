"""Command-line tools of the port; run them as `python -m regda_tpu_torch.tools.<name>`."""
