"""CLI dispatcher: ``python -m xna_basecaller_tpu_torch basecaller|train ...``.

Port of ``xna_basecaller_tpu/cli/__init__.py``, with every subcommand of
JAX's: ``basecaller``, ``train``, ``evaluate``, ``view``, ``export``,
``duplex``, ``convert`` and ``download``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

__version__ = "0.1.0"

modules = [
    "basecaller", "train", "evaluate", "view", "convert", "export",
    "download", "duplex",
]


def main(argv=None):
    parser = argparse.ArgumentParser(
        "xnacall", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version=f"xnacall {__version__} (torch)")
    subparsers = parser.add_subparsers(
        title="subcommands", description="valid commands",
        help="additional help", dest="command")
    subparsers.required = True
    for module in modules:
        mod = importlib.import_module(f"xna_basecaller_tpu_torch.cli.{module}")
        p = subparsers.add_parser(module, parents=[mod.argparser()])
        p.set_defaults(func=mod.main)
    args = parser.parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
