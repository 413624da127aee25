"""CLI dispatcher: ``python -m xna_basecaller_tpu_torch basecaller|train ...``.

Port of ``xna_basecaller_tpu/cli/__init__.py``.  ``basecaller``,
``train``, ``evaluate``, ``view``, ``export`` and ``duplex`` are ported;
``convert`` and ``download`` are listed so that calling one says it is
not ported yet.
"""

from __future__ import annotations

import argparse
import importlib
import sys

__version__ = "0.1.0"

modules = ["basecaller", "train", "evaluate", "view", "export", "duplex"]
not_ported = ["convert", "download"]


def _not_ported(args):
    sys.exit(f"xnacall {args.command} is not ported to "
             "xna_basecaller_tpu_torch yet (use the JAX package)")


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
    for module in not_ported:
        p = subparsers.add_parser(module, help="not ported yet")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(func=_not_ported)
    args = parser.parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
