"""``python -m waveunet_tpu_torch`` == ``python -m waveunet_tpu_torch.cli``."""

from waveunet_tpu_torch.cli import main

if __name__ == "__main__":
    main()
