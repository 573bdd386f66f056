"""phnrec-compatible command-line interface on PyTorch (reference:
phnrec.cpp; counterpart of phnrec_tpu/cli.py).

Runs any stage pair of wf (raw audio) -> par (HTK features) -> post (HTK
posteriors) -> str (labels), and decodes with the package's decoder: the
phoneme loop (decoder/type=phndec) or the STK network decoder
(decoder/type=stkint; mode=decode writes word or phoneme labels, mode=kws
keyword hits), for one file (-i/-o, or -i/-m) or a list (-l, with -m for
one MLF or a target column for the output files).

Flags:
    -c dir   configuration (model package) directory
    -l file  list of files     -i file  input file    -o file  output file
    -m file  output MLF        -a       live audio input (raw samples on
                                        stdin)
    -s fmt   source format (wf|par|post)   [wf]
    -t fmt   target format (par|post|str)  [str]
    -w fmt   waveform format (lin16|alaw) override
    -f fmt   live output format (str|strlen|lab)  [str]
    -p num   phoneme insertion penalty override
    -v       verbose
    --exact-exp      use the exact exp instead of the reference's fast-exp
                     bit-parity emulation
    --device DEV     torch device to run on  [cuda]
    --alize          vadalize output: ALIZE speech segments (vad.py)
    --profile        print the per-stage wall-clock breakdown at exit,
                     then the recorder's spans (count, total and self
                     seconds) and counters
    --trace=DIR      capture a torch.profiler Chrome trace into DIR
"""

from __future__ import annotations

import getopt
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    profile = "--profile" in argv
    if profile:
        argv.remove("--profile")
    trace_dir = None
    for a in list(argv):
        if a.startswith("--trace="):
            trace_dir = a.split("=", 1)[1]
            argv.remove(a)
    if not (profile or trace_dir):
        return _main(argv)

    from phnrec_tpu_torch.utils import profiling
    profiling.TIMER.enabled = True
    profiling.RECORDER.enable()
    try:
        with profiling.trace(trace_dir):
            rc = _main(argv)
        if profile:
            print(profiling.TIMER.summary(), file=sys.stderr)
            print(profiling.RECORDER.snapshot().summary(), file=sys.stderr)
        return rc
    finally:
        profiling.TIMER.enabled = False
        profiling.RECORDER.disable()


def _main(argv) -> int:
    exact_exp = "--exact-exp" in argv
    if exact_exp:
        argv.remove("--exact-exp")
    alize = "--alize" in argv      # vadalize output mode
    if alize:
        argv.remove("--alize")

    try:
        opts, _ = getopt.getopt(argv, "c:l:i:o:m:as:t:w:f:p:vh",
                                ["device="])
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    opt = dict(opts)
    if not opts or "-h" in opt:
        print(__doc__)
        return 1

    config_dir = opt.get("-c")
    if not config_dir:
        print("ERROR: Configuration directory is not specified (-c)",
              file=sys.stderr)
        return 1
    inpf = opt.get("-s", "wf")
    outpf = opt.get("-t", "str")
    if inpf not in ("wf", "par", "post"):
        print(f"ERROR: Unknown source format - '{inpf}'", file=sys.stderr)
        return 1
    if outpf not in ("par", "post", "str"):
        print(f"ERROR: Unknown target format - '{outpf}'", file=sys.stderr)
        return 1
    verbose = "-v" in opt

    from phnrec_tpu_torch.pipeline import SpeechRec

    log_fn = (lambda m: print(m, end="")) if verbose else None
    sr = SpeechRec(config_dir, fast_exp=not exact_exp, log_fn=log_fn,
                   device=opt.get("--device", "cuda"))
    if "-w" in opt:
        sr.wave_format = opt["-w"]
    if "-p" in opt:
        sr.set_wpenalty(float(opt["-p"]))

    if "-a" in opt:
        from phnrec_tpu_torch.live import run_live
        run_live(sr, out_format=opt.get("-f", "str"))
        return 0

    if alize and outpf == "str":
        # vadalize: decode, then write ALIZE speech segments
        from phnrec_tpu_torch.io import audio, htk
        from phnrec_tpu_torch.vad import write_alize

        def run_one(source, target):
            data = (audio.load_waveform_bytes(source) if inpf == "wf"
                    else htk.read_htk(source)[0])
            res = sr.process_offline(inpf, "str", data)
            if target:
                write_alize(target, res.labels)

        if "-l" in opt:
            with open(opt["-l"]) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    tgt = (parts[1] if len(parts) > 1 else
                           sr.compose_target_name(parts[0], "str", False))
                    run_one(parts[0], tgt)
        elif "-i" in opt:
            run_one(opt["-i"], opt.get("-o"))
        return 0

    if "-l" in opt:
        sr.process_file_list(inpf, outpf, opt["-l"], opt.get("-m"))
        return 0

    if "-i" in opt:
        if "-m" in opt:
            from phnrec_tpu_torch.io.labels import MLFWriter
            target = sr.compose_target_name(opt["-i"], outpf, for_mlf=True)
            with MLFWriter(opt["-m"]) as mlf:
                sr.process_file(inpf, outpf, opt["-i"], target, mlf)
        else:
            sr.process_file(inpf, outpf, opt["-i"], opt.get("-o"))
        return 0

    print("ERROR: no input (-i, -l or -a)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
