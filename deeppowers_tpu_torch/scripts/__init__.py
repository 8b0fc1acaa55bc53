"""Command-line entry points of the port (`python -m
deeppowers_tpu_torch.scripts.<name>`)."""
