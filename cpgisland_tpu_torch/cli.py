"""Command-line interface of the PyTorch port.

Two forms, as ``python -m cpgisland_tpu``:

1. The reference's positional form (CpGIslandFinder.java:346-357):

       python -m cpgisland_tpu_torch TRAIN TEST ISLANDS_OUT MODEL_OUT CONVERGENCE NUM_ITERS \\
           [--backend local|seq|seq2d] [--em-fuse auto|on|off]

   trains on TRAIN from the Durbin 8-state model, writes the trained model's
   text dump to MODEL_OUT, decodes TEST and writes island records to
   ISLANDS_OUT, with the reference's compat semantics.

2. Subcommands:

       python -m cpgisland_tpu_torch train FILE --model-out m.txt [--iters N] \\
           [--convergence E] [--init-model m0.txt | --preset durbin8|two_state] \\
           [--engine auto|xla|pallas|onehot] [--numerics rescaled|log] \\
           [--backend local|spmd|seq|seq2d] [--em-fuse auto|on|off] [--clean] \\
           [--symbol-cache PREFIX] [--invalid-symbols P]
       python -m cpgisland_tpu_torch decode FILE --islands-out i.txt \\
           [--model m.txt | --preset durbin8|two_state] [--clean [--min-len N]] \\
           [--island-states 0] [--engine auto|xla|pallas|onehot] \\
           [--island-engine auto|host|device] [--island-cap N] \\
           [--symbol-cache PREFIX] [--invalid-symbols skip|mask|fail]
       python -m cpgisland_tpu_torch run TRAIN TEST --islands-out i.txt \\
           --model-out m.txt [--iters N] [--convergence E] [--clean] \\
           [--preset durbin8|two_state] [--island-states 0] \\
           [--engine auto|xla|pallas|onehot] [--numerics rescaled|log] \\
           [--backend local|spmd|seq|seq2d] [--em-fuse auto|on|off] \\
           [--symbol-cache PREFIX]
       python -m cpgisland_tpu_torch posterior FILE [--islands-out i.txt] \\
           [--confidence-out c.npy] [--mpm-path-out p.npy] [--min-len N] \\
           [--island-states 0,1,2,3] [--model m.txt | --preset durbin8|two_state] \\
           [--engine auto|xla|pallas|onehot] [--island-engine auto|host|device] \\
           [--island-cap N] [--symbol-cache PREFIX] [--invalid-symbols P]
       python -m cpgisland_tpu_torch compare FILE --out report.txt \\
           [--models durbin8,two_state,null | NAME=MODEL.txt,...] [--baseline NAME] \\
           [--min-len N] [--threshold X] [--engine auto|xla|pallas|onehot] \\
           [--no-stacked] [--symbol-cache PREFIX] [--invalid-symbols P]

Everything runs on the card unless ``--device cpu`` is given (the kernels'
plain versions); that flag may stand anywhere in the arguments, the
positional form included.  Same semantics and file formats as the JAX
package's CLI.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

_SUBCOMMANDS = ("train", "decode", "run", "posterior", "compare")
_DEVICES = ("cuda", "cpu")


def _take_option(argv: list, flag: str, choices: tuple, default: str) -> tuple:
    """Remove ``flag X`` / ``flag=X`` from anywhere in argv -> (value, the
    other arguments)."""
    value, rest = default, []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == flag and i + 1 < len(argv):
            value, i = argv[i + 1], i + 2
            continue
        if a.startswith(flag + "="):
            value, i = a.split("=", 1)[1], i + 1
            continue
        rest.append(a)
        i += 1
    if value not in choices:
        raise SystemExit(f"cpgisland_tpu_torch: {flag} must be one of {choices}, got {value!r}")
    return value, rest


def _take_device(argv: list) -> tuple:
    """Remove ``--device X`` / ``--device=X`` from anywhere in argv (as the
    JAX CLI removes ``--platform`` before it tells the positional form from
    a subcommand) -> (device, the other arguments)."""
    return _take_option(argv, "--device", _DEVICES, "cuda")


_BACKENDS = ("local", "spmd", "seq", "seq2d")
_EM_FUSE = ("auto", "on", "off")
_BACKEND_HELP = (
    "E-step backend: one device / chunk-sharded mesh psum / exact whole-sequence "
    "sequence-parallel / per-record 2-D data x seq mesh (the last two have no "
    "chunk-boundary approximation; seq2d needs --clean).  The meshes take every "
    "card of --device cuda (one entry on the CPU)"
)
_EM_FUSE_HELP = (
    "EM loop execution: auto/on keeps the loop on the card with the convergence "
    "test on device (no blocking read between iterations); off keeps the "
    "reference's per-iteration host cadence"
)


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", choices=_BACKENDS, default="local", help=_BACKEND_HELP)
    p.add_argument("--em-fuse", choices=_EM_FUSE, default="auto", help=_EM_FUSE_HELP)


def _add_invalid_symbols_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--invalid-symbols", choices=("skip", "mask", "fail"), default="skip",
        help="non-base bytes: drop them (the reference), encode them as PAD "
        "(identity steps), or fail; mask/fail need --clean",
    )


def _add_numerics_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--numerics", choices=("log", "rescaled"), default="rescaled", dest="mode",
                   help="E-step numerics: the reference's per-step rescaling, or log space "
                   "(the generic xla engine; auto takes it for log)")


def _add_symbol_cache_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--symbol-cache",
                   help="symbol cache prefix (clean mode): the FASTA's encode is written "
                   "there on first use and read without a parse after it")


def _add_clean_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--clean", action="store_true",
        help="FASTA-aware encoding, no dropped remainders, no island clipping "
        "(default is reference-compatible behavior)",
    )


def _positive_int(text: str) -> int:
    v = int(text)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {text!r}")
    return v


def _add_island_cap_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--island-cap", type=_positive_int, default=None,
                   help="initial device output size in island calls (default 128 Ki); an "
                   "overflow retries the calling pass at the true count")


def _add_island_states_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--island-states",
        help="comma-separated island state ids for models whose states don't "
        "encode bases (e.g. '0' for the two_state preset); composition then "
        "comes from the observations (decode: --clean only)",
    )


def _parse_island_states(parser: argparse.ArgumentParser, text: Optional[str]):
    if not text:
        return None
    try:
        return tuple(int(x) for x in text.split(","))
    except ValueError:
        parser.error(f"--island-states must be comma-separated integers, got {text!r}")


def _add_preset_flag(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--preset", choices=("durbin8", "two_state"), default="durbin8",
                   help=f"{what} preset (durbin8: the reference's 8-state CpG+- table; "
                   "two_state: minimal island/background model, needs --island-states 0 "
                   "to call islands)")


def _add_fb_engine_flag(p: argparse.ArgumentParser, train: bool = False) -> None:
    tail = ("else the generic xla engine, which --numerics log also takes" if train
            else "else the generic xla lane path, any K")
    p.add_argument("--engine", choices=("auto", "xla", "pallas", "onehot"), default="auto",
                   help="forward-backward engine (auto: the reduced one-hot kernels for "
                   f"eligible models, else the dense kernels for K <= 8; {tail})")


def _preset_params(name: str):
    from cpgisland_tpu_torch.models import presets

    return presets.two_state_cpg() if name == "two_state" else presets.durbin_cpg8()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpgisland_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="Baum-Welch EM training")
    t.add_argument("training_file")
    t.add_argument("--model-out", required=True)
    t.add_argument("--iters", type=int, default=10)
    t.add_argument("--convergence", type=float, default=0.005)
    t.add_argument("--init-model", help="start from a model text file instead of the --preset model")
    _add_preset_flag(t, "initial model")
    _add_fb_engine_flag(t, train=True)
    _add_numerics_flag(t)
    _add_train_flags(t)
    _add_clean_flag(t)
    _add_symbol_cache_flag(t)
    _add_invalid_symbols_flag(t)

    d = sub.add_parser("decode", help="Viterbi decode + island calling")
    d.add_argument("test_file")
    d.add_argument("--model", help="model text file (default: the --preset model)")
    _add_preset_flag(d, "model")
    d.add_argument("--islands-out", required=True)
    _add_clean_flag(d)
    d.add_argument("--min-len", type=int, default=None, help="clean mode only")
    _add_island_states_flag(d)
    d.add_argument("--engine", choices=("auto", "xla", "pallas", "onehot"), default="auto",
                   help="decode engine (auto: the reduced one-hot kernels for eligible "
                   "models, else the dense kernels for K <= 8, else the plain xla twin)")
    d.add_argument("--island-engine", choices=("auto", "host", "device"), default="auto",
                   help="island caller placement (clean mode): device calls islands where "
                   "the path lies and returns only the call records (auto: device on the "
                   "card)")
    _add_island_cap_flag(d)
    _add_numerics_flag(d)
    _add_symbol_cache_flag(d)
    _add_invalid_symbols_flag(d)

    r = sub.add_parser("run", help="train then decode (the reference main())")
    r.add_argument("training_file")
    r.add_argument("test_file")
    r.add_argument("--islands-out", required=True)
    r.add_argument("--model-out", required=True)
    r.add_argument("--iters", type=int, default=10)
    r.add_argument("--convergence", type=float, default=0.005)
    _add_preset_flag(r, "initial model")
    _add_island_states_flag(r)
    r.add_argument("--engine", choices=("auto", "xla", "pallas", "onehot"), default="auto",
                   help="decode engine (training takes its own auto engine), as in decode")
    _add_numerics_flag(r)
    _add_train_flags(r)
    _add_clean_flag(r)
    _add_symbol_cache_flag(r)

    po = sub.add_parser(
        "posterior",
        help="soft decoding: per-position island confidence (forward-backward "
        "posteriors; the soft counterpart of `decode`, always clean)",
    )
    po.add_argument("test_file")
    po.add_argument("--model", help="model text file (default: the --preset model)")
    _add_preset_flag(po, "model")
    po.add_argument("--confidence-out", help=".npy of float32 P(in island) per symbol")
    po.add_argument("--mpm-path-out",
                    help=".npy of the int8 max-posterior-marginal state path")
    po.add_argument("--islands-out",
                    help="call CpG islands from the MPM path (decode-format records)")
    po.add_argument("--min-len", type=int, default=None,
                    help="minimum island length for --islands-out")
    po.add_argument("--island-engine", choices=("auto", "host", "device"), default="auto",
                    help="island caller placement: device keeps the MPM path on the card "
                    "and returns only the call records (auto: device on the card when "
                    "--islands-out is given without --mpm-path-out)")
    _add_island_cap_flag(po)
    _add_island_states_flag(po)
    _add_fb_engine_flag(po)
    _add_symbol_cache_flag(po)
    _add_invalid_symbols_flag(po)

    cp = sub.add_parser(
        "compare",
        help="multi-model posterior comparison: N family members over one FASTA stream — "
        "per-model log-odds vs a baseline, per-model islands, and a per-position "
        "winning-model track in the reference island format (clean semantics)",
    )
    cp.add_argument("test_file")
    cp.add_argument(
        "--models", default="durbin8,two_state,null",
        help="comma-separated family members: built-in names (durbin8,two_state,dinuc_cpg,"
        "null,null16) and/or NAME=MODEL.txt entries (loaded model text; island states "
        "inferred for 2M-state layouts).  Default: durbin8,two_state,null",
    )
    cp.add_argument("--out", required=True, help="comparison report path")
    cp.add_argument("--baseline", help="member name for the log-odds denominator (default: "
                    "the one null member when present, else the first member)")
    cp.add_argument("--min-len", type=int, default=None,
                    help="minimum island length for the emitted tracks")
    cp.add_argument("--threshold", type=float, default=None,
                    help="winner-track confidence threshold (default 0.5): a position below "
                    "it on every member falls back to background")
    _add_fb_engine_flag(cp)
    cp.add_argument("--no-stacked", action="store_true",
                    help="run every member on its own (the stacked dispatch puts same-order "
                    "reduced members in ONE launch set; results are bit-identical either way)")
    _add_symbol_cache_flag(cp)
    _add_invalid_symbols_flag(cp)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    device, argv = _take_device(list(sys.argv[1:] if argv is None else argv))
    from cpgisland_tpu_torch import pipeline
    from cpgisland_tpu_torch.models.hmm import load_text

    # The reference's six-positional form; --backend and --em-fuse may
    # stand anywhere in it, as --device does.
    if argv and argv[0] not in _SUBCOMMANDS and not argv[0].startswith("-"):
        backend, rest = _take_option(argv, "--backend", _BACKENDS, "local")
        fuse, rest = _take_option(rest, "--em-fuse", _EM_FUSE, "auto")
        if len(rest) == 6:
            train_f, test_f, islands_out, model_out, convergence, num_iters = rest
            res = pipeline.run(train_f, test_f, islands_out, model_out,
                               convergence=float(convergence), num_iters=int(num_iters),
                               backend=backend, fuse=fuse, device=device)
            print(f"{len(res.calls)} islands -> {islands_out}")
            return 0

    parser = build_parser()
    args = parser.parse_args(argv)
    compat = not getattr(args, "clean", True)  # posterior is always clean
    if getattr(args, "invalid_symbols", "skip") != "skip" and compat:
        parser.error("--invalid-symbols mask|fail requires --clean")
    if getattr(args, "symbol_cache", None) and compat:
        parser.error("--symbol-cache is FASTA-aware and requires --clean")

    if args.cmd == "train":
        params = load_text(args.init_model) if args.init_model else _preset_params(args.preset)
        res = pipeline.train_file(
            args.training_file, params=params, num_iters=args.iters,
            convergence=args.convergence, compat=compat, model_out=args.model_out,
            engine=args.engine, mode=args.mode, invalid_symbols=args.invalid_symbols,
            backend=args.backend, fuse=args.em_fuse, symbol_cache=args.symbol_cache,
            device=device,
        )
        final = res.logliks[-1] if res.logliks else float("nan")
        print(f"trained: iters={res.iterations} converged={res.converged} "
              f"final_loglik={final:.4f}")
        return 0

    if args.cmd == "posterior":
        if args.min_len is not None and not args.islands_out:
            parser.error("--min-len only applies with --islands-out")
        if not (args.confidence_out or args.mpm_path_out or args.islands_out):
            parser.error("nothing to do: pass --confidence-out, --mpm-path-out, "
                         "and/or --islands-out")
        island_states = _parse_island_states(parser, args.island_states)
        params = load_text(args.model) if args.model else _preset_params(args.preset)
        err = pipeline.island_layout_error(params, island_states)
        if err:
            parser.error(f"--{'model' if args.model else 'preset ' + args.preset}: {err}")
        res = pipeline.posterior_file(
            args.test_file, params, confidence_out=args.confidence_out,
            mpm_path_out=args.mpm_path_out, islands_out=args.islands_out,
            min_len=args.min_len, island_states=island_states, engine=args.engine,
            island_engine=args.island_engine, island_cap=args.island_cap,
            symbol_cache=args.symbol_cache, invalid_symbols=args.invalid_symbols, device=device,
        )
        extra = (f"; {len(res.calls)} islands -> {args.islands_out}"
                 if res.calls is not None else "")
        print(f"posterior: {res.n_symbols} symbols in {res.n_records} records; "
              f"mean island confidence {res.mean_island_confidence:.4f}{extra}")
        return 0

    if args.cmd == "compare":
        from cpgisland_tpu_torch import family

        members, seen = [], set()
        for tok in args.models.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" in tok:
                name, path = tok.split("=", 1)
                m = family.member_from_params(name, load_text(path))
            else:
                m = family.builtin_member(tok)
            if m.name in seen:
                parser.error(f"duplicate member name {m.name!r}")
            seen.add(m.name)
            members.append(m)
        if not members:
            parser.error("--models named no members")
        try:
            family.resolve_baseline(members, args.baseline)
        except ValueError as e:
            parser.error(str(e))
        res = pipeline.compare_file(
            args.test_file, members, out=args.out, engine=args.engine, baseline=args.baseline,
            min_len=args.min_len, threshold=args.threshold, symbol_cache=args.symbol_cache,
            invalid_symbols=args.invalid_symbols, stacked=not args.no_stacked, device=device,
        )
        n_winner = sum(len(rc.winner_calls) for rc in res.records)
        print(f"compared {len(res.member_names)} models over {res.n_symbols} symbols in "
              f"{res.n_records} records; baseline {res.baseline}; {n_winner} winner-track "
              f"islands -> {args.out}")
        return 0

    if args.cmd == "decode":
        if args.min_len is not None and compat:
            parser.error("--min-len requires --clean (the reference has no length filter)")
        island_states = _parse_island_states(parser, args.island_states)
        if island_states is not None and compat:
            parser.error("--island-states requires --clean")
        params = load_text(args.model) if args.model else _preset_params(args.preset)
        err = pipeline.island_layout_error(params, island_states)
        if err:
            parser.error(f"--{'model' if args.model else 'preset ' + args.preset}: {err}")
        res = pipeline.decode_file(
            args.test_file, params, islands_out=args.islands_out, compat=compat,
            min_len=args.min_len, engine=args.engine, island_states=island_states,
            island_engine=args.island_engine, island_cap=args.island_cap,
            symbol_cache=args.symbol_cache, invalid_symbols=args.invalid_symbols, device=device,
        )
        print(f"decoded {res.n_symbols} symbols in {res.n_chunks} chunks; "
              f"{len(res.calls)} islands")
        return 0

    island_states = _parse_island_states(parser, args.island_states)
    if island_states is not None and compat:
        parser.error("--island-states requires --clean")
    params = _preset_params(args.preset)
    # decode_file's pairing check, at parse time rather than after training.
    err = pipeline.island_layout_error(params, island_states)
    if err:
        parser.error(f"--preset {args.preset}: {err}")
    res = pipeline.run(
        args.training_file, args.test_file, args.islands_out, args.model_out,
        convergence=args.convergence, num_iters=args.iters, params=params, compat=compat,
        engine=args.engine, island_states=island_states, backend=args.backend,
        mode=args.mode, symbol_cache=args.symbol_cache, fuse=args.em_fuse, device=device,
    )
    print(f"{len(res.calls)} islands -> {args.islands_out}")
    return 0
