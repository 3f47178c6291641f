"""Command-line interface of the PyTorch port (the ``decode`` subcommand).

    python -m cpgisland_tpu_torch decode FILE --islands-out i.txt \
        [--model m.txt | --preset durbin8] [--clean [--min-len N]] \
        [--invalid-symbols skip|mask|fail] [--device cuda|cpu]

Same semantics and island-file format as ``python -m cpgisland_tpu decode``;
the decode runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpgisland_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="Viterbi decode + island calling")
    d.add_argument("test_file")
    d.add_argument("--model", help="model text file (default: the --preset model)")
    d.add_argument("--preset", choices=("durbin8",), default="durbin8",
                   help="model preset (durbin8: the reference's 8-state CpG+- table)")
    d.add_argument("--islands-out", required=True)
    d.add_argument(
        "--clean", action="store_true",
        help="FASTA-aware encoding, no dropped remainders, no island clipping "
        "(default is reference-compatible behavior)",
    )
    d.add_argument("--min-len", type=int, default=None, help="clean mode only")
    d.add_argument(
        "--invalid-symbols", choices=("skip", "mask", "fail"), default="skip",
        help="non-base bytes: drop them (the reference), encode them as PAD "
        "(identity steps), or fail; mask/fail need --clean",
    )
    d.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the decode runs (cpu: the kernels' plain versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    from cpgisland_tpu_torch import pipeline
    from cpgisland_tpu_torch.models import presets
    from cpgisland_tpu_torch.models.hmm import load_text

    compat = not args.clean
    if args.min_len is not None and compat:
        parser.error("--min-len requires --clean (the reference has no length filter)")
    if args.invalid_symbols != "skip" and compat:
        parser.error("--invalid-symbols mask|fail requires --clean")
    params = load_text(args.model) if args.model else presets.durbin_cpg8()
    res = pipeline.decode_file(
        args.test_file,
        params,
        islands_out=args.islands_out,
        compat=compat,
        min_len=args.min_len,
        invalid_symbols=args.invalid_symbols,
        device=args.device,
    )
    print(f"decoded {res.n_symbols} symbols in {res.n_chunks} chunks; {len(res.calls)} islands")
    return 0
