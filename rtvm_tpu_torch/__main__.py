"""``python -m rtvm_tpu_torch mosaic <clip> ...``: see ``cli.py``."""

from rtvm_tpu_torch.cli import main

if __name__ == "__main__":
    main()
