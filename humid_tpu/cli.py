"""Command-line interface, drop-in compatible with the reference binary.

Flag surface and defaults from humid.cc:413-429 (commandIO interface):

  -n 24   word length           -q      (toggle) write dedup FastQ [on]
  -m 1    allowed mismatches    -a      write annotated FastQ
  -l /dev/stderr  log file      -e      use edit distance
  -d .    output directory      -x      use maximum clustering method
  -s      calculate statistics  files   FastQ files (positional)

commandIO boolean flags TOGGLE their default, so ``-q`` turns the dedup
output OFF — replicated here with store_false.
"""

from __future__ import annotations

import argparse
import sys
import zlib

from .errors import InputError
from .pipeline import run

# Input errors (missing file, empty/corrupt/truncated FastQ or gzip)
# that get a clean CLI diagnostic instead of a traceback.  Internal
# errors (including generic ValueError) keep their tracebacks.
_INPUT_ERRORS = (OSError, EOFError, zlib.error, InputError)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="humid-tpu", description="Deduplicate a dataset."
    )
    p.add_argument("-n", type=int, default=24, metavar="WORDLENGTH",
                   help="word length (default 24)")
    p.add_argument("-m", type=int, default=1, metavar="MISMATCHES",
                   help="allowed mismatches (default 1)")
    p.add_argument("-l", type=str, default="/dev/stderr", metavar="LOG",
                   help="log file name")
    p.add_argument("-d", type=str, default=".", metavar="DIR",
                   help="output directory")
    p.add_argument("-s", action="store_true",
                   help="calculate statistics")
    p.add_argument("-q", action="store_false", dest="q",
                   help="toggle writing deduplicated FastQ files (default on)")
    p.add_argument("-a", action="store_true",
                   help="write annotated FastQ files")
    p.add_argument("-e", action="store_true",
                   help="use edit distance")
    p.add_argument("-x", action="store_true",
                   help="use maximum clustering method")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="jax.distributed coordinator address "
                        "(multi-host runs; extension over the reference)")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="N", help="number of hosts in the job")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="I", help="this host's index")
    p.add_argument("files", nargs="+", help="FastQ files")
    return p


def execute(args: argparse.Namespace):
    """Run the pipeline for parsed CLI ``args``: the single-host
    :class:`~humid_tpu.pipeline.PipelineResult`, or None for a
    multi-host run."""
    from ._util import configure_compile_cache

    configure_compile_cache()
    multihost = args.coordinator is not None or (
        args.num_processes or 0) > 1
    if multihost:
        from .parallel.multihost import init_distributed
        from .parallel.pipeline import run_distributed

        if args.coordinator is None:
            # Without a coordinator the hosts cannot exchange unique
            # tables; each would silently cluster only its own range.
            build_parser().error(
                "--num-processes > 1 requires --coordinator")
        try:
            init_distributed(args.coordinator, args.num_processes,
                             args.process_id)
        except ValueError as exc:
            # Underspecified cluster config (jax raises ValueError, e.g.
            # a coordinator with no --num-processes and no auto-detect
            # env): a user diagnostic, not a traceback.
            build_parser().error(str(exc))
        run_distributed(
            args.files,
            word_length=args.n,
            distance=args.m,
            log_name=args.l,
            dir_name=args.d,
            run_stats=args.s,
            write_dedup=args.q,
            write_annotated=args.a,
            edit=args.e,
            maximum=args.x,
            process_id=args.process_id,
            num_processes=args.num_processes,
        )
        return None
    return run(
        args.files,
        word_length=args.n,
        distance=args.m,
        log_name=args.l,
        dir_name=args.d,
        run_stats=args.s,
        write_dedup=args.q,
        write_annotated=args.a,
        edit=args.e,
        maximum=args.x,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        execute(args)
    except _INPUT_ERRORS as exc:
        print(f"humid-tpu: error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
