"""``python -m debias_vision_lang_torch`` → the CLI (cli.py)."""

from .cli import main

if __name__ == "__main__":  # don't run argparse on a mere import
    main()
