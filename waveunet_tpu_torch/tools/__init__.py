"""Command-line tools of the port, run as ``python -m waveunet_tpu_torch.tools.<name>``."""
