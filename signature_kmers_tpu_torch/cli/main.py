"""Command-line entry point of the PyTorch port.

  python -m signature_kmers_tpu_torch.cli.main call-functions \
      -d DATA_DIR -i FASTA [FASTA ...] [-o OUT] [--ignore-hypo] \
      [--device {cuda,cpu}]

Output is byte-identical to the JAX package's ``call-functions``
(id \t function \t function_index \t score, ref:
kmers-call-functions.cc:176-179).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..core.config import Config
from ..io import fasta as fasta_io, formats
from ..models import pipeline
from ..models.function_caller import FunctionCaller


def _add_call(sub):
    p = sub.add_parser("call-functions", help="call functions for query FASTAs")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("-i", "--input-files", nargs="+", required=True)
    p.add_argument("-o", "--output-file")
    p.add_argument("--ignore-hypo", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the kernels; cpu runs their plain "
                        "PyTorch versions")
    p.set_defaults(func=cmd_call)


def cmd_call(args):
    cfg = Config()
    table, function_index = pipeline.load_data_dir(args.data_dir)
    call_cfg = dataclasses.replace(cfg.call,
                                   ignore_hypothetical=args.ignore_hypo)
    caller = FunctionCaller(table, function_index, call_cfg, cfg.device,
                            device=args.device)
    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        for path in args.input_files:
            for res in caller.call_batch(fasta_io.read_fasta_batch(path)):
                out.write(formats.format_call_row(
                    res.seq_id, res.best.function,
                    res.best.function_index, res.best.score))
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="skt-torch",
        description="signature k-mer framework, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_call(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
