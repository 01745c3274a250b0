import sys

from airwave_tpu_torch.shell.app import cli

if __name__ == "__main__":
    sys.exit(cli())
