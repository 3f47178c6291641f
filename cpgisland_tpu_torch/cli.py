"""Command-line interface of the PyTorch port.

Two forms, as ``python -m cpgisland_tpu``:

1. The reference's positional form (CpGIslandFinder.java:346-357):

       python -m cpgisland_tpu_torch TRAIN TEST ISLANDS_OUT MODEL_OUT CONVERGENCE NUM_ITERS

   trains on TRAIN from the Durbin 8-state model, writes the trained model's
   text dump to MODEL_OUT, decodes TEST and writes island records to
   ISLANDS_OUT, with the reference's compat semantics.

2. Subcommands:

       python -m cpgisland_tpu_torch train FILE --model-out m.txt [--iters N] \\
           [--convergence E] [--init-model m0.txt] [--clean] [--invalid-symbols P]
       python -m cpgisland_tpu_torch decode FILE --islands-out i.txt \\
           [--model m.txt | --preset durbin8] [--clean [--min-len N]] \\
           [--invalid-symbols skip|mask|fail]
       python -m cpgisland_tpu_torch run TRAIN TEST --islands-out i.txt \\
           --model-out m.txt [--iters N] [--convergence E] [--clean]

Everything runs on the card unless ``--device cpu`` is given (the kernels'
plain versions); that flag may stand anywhere in the arguments, the
positional form included.  Same semantics and file formats as the JAX
package's CLI.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

_SUBCOMMANDS = ("train", "decode", "run")
_DEVICES = ("cuda", "cpu")


def _take_device(argv: list) -> tuple:
    """Remove ``--device X`` / ``--device=X`` from anywhere in argv (as the
    JAX CLI removes ``--platform`` before it tells the positional form from
    a subcommand) -> (device, the other arguments)."""
    device, rest = "cuda", []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device, i = a.split("=", 1)[1], i + 1
            continue
        rest.append(a)
        i += 1
    if device not in _DEVICES:
        raise SystemExit(f"cpgisland_tpu_torch: --device must be one of {_DEVICES}, got {device!r}")
    return device, rest


def _add_invalid_symbols_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--invalid-symbols", choices=("skip", "mask", "fail"), default="skip",
        help="non-base bytes: drop them (the reference), encode them as PAD "
        "(identity steps), or fail; mask/fail need --clean",
    )


def _add_clean_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--clean", action="store_true",
        help="FASTA-aware encoding, no dropped remainders, no island clipping "
        "(default is reference-compatible behavior)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpgisland_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="Baum-Welch EM training")
    t.add_argument("training_file")
    t.add_argument("--model-out", required=True)
    t.add_argument("--iters", type=int, default=10)
    t.add_argument("--convergence", type=float, default=0.005)
    t.add_argument("--init-model", help="start from a model text file instead of the Durbin preset")
    _add_clean_flag(t)
    _add_invalid_symbols_flag(t)

    d = sub.add_parser("decode", help="Viterbi decode + island calling")
    d.add_argument("test_file")
    d.add_argument("--model", help="model text file (default: the --preset model)")
    d.add_argument("--preset", choices=("durbin8",), default="durbin8",
                   help="model preset (durbin8: the reference's 8-state CpG+- table)")
    d.add_argument("--islands-out", required=True)
    _add_clean_flag(d)
    d.add_argument("--min-len", type=int, default=None, help="clean mode only")
    _add_invalid_symbols_flag(d)

    r = sub.add_parser("run", help="train then decode (the reference main())")
    r.add_argument("training_file")
    r.add_argument("test_file")
    r.add_argument("--islands-out", required=True)
    r.add_argument("--model-out", required=True)
    r.add_argument("--iters", type=int, default=10)
    r.add_argument("--convergence", type=float, default=0.005)
    _add_clean_flag(r)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    device, argv = _take_device(list(sys.argv[1:] if argv is None else argv))
    from cpgisland_tpu_torch import pipeline
    from cpgisland_tpu_torch.models import presets
    from cpgisland_tpu_torch.models.hmm import load_text

    # The reference's six-positional form.
    if len(argv) == 6 and argv[0] not in _SUBCOMMANDS:
        train_f, test_f, islands_out, model_out, convergence, num_iters = argv
        res = pipeline.run(train_f, test_f, islands_out, model_out,
                           convergence=float(convergence), num_iters=int(num_iters),
                           device=device)
        print(f"{len(res.calls)} islands -> {islands_out}")
        return 0

    parser = build_parser()
    args = parser.parse_args(argv)
    compat = not args.clean
    if getattr(args, "invalid_symbols", "skip") != "skip" and compat:
        parser.error("--invalid-symbols mask|fail requires --clean")

    if args.cmd == "train":
        params = load_text(args.init_model) if args.init_model else presets.durbin_cpg8()
        res = pipeline.train_file(
            args.training_file, params=params, num_iters=args.iters,
            convergence=args.convergence, compat=compat, model_out=args.model_out,
            invalid_symbols=args.invalid_symbols, device=device,
        )
        final = res.logliks[-1] if res.logliks else float("nan")
        print(f"trained: iters={res.iterations} converged={res.converged} "
              f"final_loglik={final:.4f}")
        return 0

    if args.cmd == "decode":
        if args.min_len is not None and compat:
            parser.error("--min-len requires --clean (the reference has no length filter)")
        params = load_text(args.model) if args.model else presets.durbin_cpg8()
        res = pipeline.decode_file(
            args.test_file, params, islands_out=args.islands_out, compat=compat,
            min_len=args.min_len, invalid_symbols=args.invalid_symbols, device=device,
        )
        print(f"decoded {res.n_symbols} symbols in {res.n_chunks} chunks; "
              f"{len(res.calls)} islands")
        return 0

    res = pipeline.run(
        args.training_file, args.test_file, args.islands_out, args.model_out,
        convergence=args.convergence, num_iters=args.iters, compat=compat, device=device,
    )
    print(f"{len(res.calls)} islands -> {args.islands_out}")
    return 0
