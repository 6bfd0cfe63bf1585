"""``python -m rayzen_tpu_torch [flags]``: the demo CLI (cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
