"""`python -m featurebase_tpu_torch <command>`: the port's command line
(cli.py)."""
from featurebase_tpu_torch.cli import main

if __name__ == "__main__":
    import sys
    sys.exit(main())
