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
    -m file  output MLF
    -s fmt   source format (wf|par|post)   [wf]
    -t fmt   target format (par|post|str)  [str]
    -w fmt   waveform format (lin16|alaw) override
    -p num   phoneme insertion penalty override
    -v       verbose
    --exact-exp      use the exact exp instead of the reference's fast-exp
                     bit-parity emulation
    --device DEV     torch device to run on  [cuda]

Not ported yet (each raises NotImplementedError): -a (live audio),
--alize, --profile, --trace.
"""

from __future__ import annotations

import getopt
import sys

_NOT_PORTED = {
    "-a": "live audio input (-a) is not ported yet (ROADMAP.md, Queue 1 "
          "item 14: live.py)",
    "--alize": "--alize output is not ported yet (ROADMAP.md, Queue 1 item "
               "17: score, VAD, profiling)",
    "--profile": "--profile is not ported yet (ROADMAP.md, Queue 1 item 17: "
                 "utils/profiling.py with torch.profiler)",
    "--trace": "--trace is not ported yet (ROADMAP.md, Queue 1 item 17: "
               "utils/profiling.py with torch.profiler)",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        key = a.split("=", 1)[0]
        if key in ("--alize", "--profile", "--trace"):
            raise NotImplementedError(_NOT_PORTED[key])
    exact_exp = "--exact-exp" in argv
    if exact_exp:
        argv.remove("--exact-exp")

    try:
        opts, _ = getopt.getopt(argv, "c:l:i:o:m:as:t:w:p:vh",
                                ["device="])
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    opt = dict(opts)
    if not opts or "-h" in opt:
        print(__doc__)
        return 1
    if "-a" in opt:
        raise NotImplementedError(_NOT_PORTED["-a"])

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

    print("ERROR: no input (-i or -l)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
