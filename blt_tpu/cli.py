"""Command-line interface.

Flag surface mirrors the reference binary exactly
(reference: src/main.rs:8-60 CliArgs; src/main.rs:100-103 error handling —
"Error running tokenizer: {e}" on stderr and exit code 1):

    blt [-i FILE] [-o FILE] [--merges FILE] [--passthrough]
        [--type text|audio|bin|video] [--threads N] [--memcap PCT]
        [--chunksize SIZE]

Omitted --input/--output mean stdin/stdout (io_handler.rs:52-75); ``-`` is
also honored per the reference's documented-but-unimplemented convention
(README.md:102-103, SURVEY.md 2.1.8). ``--engine`` is a new-framework flag
selecting the compute backend (auto/jax/numpy).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from blt_tpu._version import __version__


def _u8(value: str) -> int:
    """clap-style u8 parse for --memcap (reference: src/main.rs:48-52).

    The reference CLI types memcap as u8, so 300 / -1 are rejected at parse
    time ("invalid value ... for '--memcap <PERCENT>'").
    """
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid digit found in string: {value!r}")
    if not 0 <= n <= 255:
        raise argparse.ArgumentTypeError(f"{n} is not in 0..=255")
    return n


def _usize(value: str) -> int:
    """clap-style usize parse for --threads (reference: src/main.rs:44-46)."""
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid digit found in string: {value!r}")
    if n < 0:
        raise argparse.ArgumentTypeError(f"{n} is negative (expected usize)")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blt",
        description="Byte-level tokenizer on JAX accelerators (basic / BPE / passthrough)",
    )
    p.add_argument("-i", "--input", metavar="FILE", default=None,
                   help="Input file path (or - for stdin)")
    p.add_argument("-o", "--output", metavar="FILE", default=None,
                   help="Output file path (or - for stdout)")
    p.add_argument("--merges", metavar="FILE", default=None,
                   help="BPE merges file for advanced tokenization")
    p.add_argument("--passthrough", action="store_true",
                   help="Use passthrough mode (copy file without tokenization)")
    p.add_argument("--decode", action="store_true",
                   help="Invert a token stream produced by this tokenizer "
                        "(u16-BE tokens -> original bytes; use the same "
                        "--merges/--type the encoding run used)")
    p.add_argument("--type", dest="content_type", default=None,
                   choices=["text", "audio", "bin", "video"],
                   help="Prepend content-type token")
    p.add_argument("--threads", metavar="NUM", type=_usize, default=None,
                   help="Override worker count (default: auto based on cores)")
    p.add_argument("--memcap", metavar="PERCENT", type=_u8, default=None,
                   help="Max RAM usage fraction (e.g., 70 for 70%%)")
    p.add_argument("--chunksize", metavar="SIZE", default=None,
                   help="Min/Max chunk size (e.g. 4MB, 256KB).")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "jax", "numpy", "shard"],
                   help="Compute backend (default: auto; shard = all devices "
                        "of a multi-chip mesh)")
    p.add_argument("--version", action="version", version=f"blt {__version__}")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    from blt_tpu.config import ContentType, CoreConfig, Engine
    from blt_tpu.pipeline.runner import run_tokenizer
    from blt_tpu.utils.logging import configure

    configure()
    args = build_parser().parse_args(argv)

    try:
        config = CoreConfig.new_from_cli(
            input=Path(args.input) if args.input else None,
            output=Path(args.output) if args.output else None,
            merges=Path(args.merges) if args.merges else None,
            content_type=(
                ContentType.from_cli(args.content_type) if args.content_type else None
            ),
            threads=args.threads,
            chunksize=args.chunksize,
            memcap=args.memcap,
            passthrough=args.passthrough,
            decode=args.decode,
            engine=Engine(args.engine),
        )
        run_tokenizer(config)
    except (OSError, ValueError) as e:
        print(f"Error running tokenizer: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
