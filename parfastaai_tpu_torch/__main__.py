"""``python -m parfastaai_tpu_torch <db> <out.csv> [flags]``."""

from .cli import main

if __name__ == "__main__":
    main()
