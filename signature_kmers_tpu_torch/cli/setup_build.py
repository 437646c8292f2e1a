"""Build-directory preparation: the kmers-setup-build equivalent (host
code; the same files, stdout and stderr as ``skt setup-build``).

The reference's scripts/kmers-setup-build.pl prepares a training data dir
from a SEED installation (ref: kmers-setup-build.pl:10-23 for the option
surface).  This version reproduces the orchestration on generic inputs —
a source directory of per-genome FASTA files and (optionally) per-genome
annotation files — since no SEED API exists here:

- output layout: <dir>/Seqs/, <dir>/Annotations/0/, <dir>/gnames/
  (ref: kmers-setup-build.pl:71);
- --otu-reps: one representative genome per OTU set (ref: :35-51), and
  the ``otus`` membership file that build-signatures --otu-file reads;
- --genome / --skip-genome selection (ref: :53-56, :82-86);
- --skip-pegs file of ids to drop (ref: :58-68, :146-150);
- --skip-fusions drops proteins whose function contains " / " (ref: :162-169);
- fragment/frameshift run renumbering: consecutive proteins sharing a
  function whose comment matches fragment|frameshift get " 1", " 2", ...
  suffixes (ref: :176-252; without location data, file order is the run
  order and strand-reversal is not applied);
- --additional-fasta mixed in under synthetic genomes 7777777.N with
  fig| ids, --id-map output, additional.funcs list (ref: :273-325);
- --virus-dir with fasta/ and anno/ subdirectories (ref: :89-128);
- --function-overrides appended per genome (ref: :331-351);
- --no-strip keeps function comments (ref: default strips them);
- --phage-locations: overlapping-phage-peg exclusion — pegs sharing a
  (contig, stop) coordinate are ribosomal-slippage products (pp1ab/pp1a);
  all but the longest are skipped, and the skipped (fid, function) pairs
  are printed, as the reference's find_overlapping_phage_pegs does
  (ref: :76-77, :361-395; locations come from a TSV here instead of the
  SEED API);
- --protect-subsystem-roles + --subsystem-roles: writes the sorted role
  list to <dir>/subsystem.roles unless already present (ref: :353-359;
  roles come from a file here instead of $fig->subsystem_roles).
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from ..core import seed
from ..io import fasta as fasta_io

_FRAG_RE = re.compile(r"fragment|frameshift")
_GENOME_OF_RE = re.compile(r"fig\|(\d+\.\d+)")


def genome_of(fid: str) -> str:
    m = _GENOME_OF_RE.search(fid)
    return m.group(1) if m else ""


def load_annotations(path: Path) -> dict[str, str]:
    out = {}
    if path and path.is_file():
        for line in path.read_text(encoding="latin-1").splitlines():
            if "\t" in line:
                fid, fn = line.split("\t", 1)
                out[fid] = fn.split("\t")[0]
    return out


def renumber_fragment_runs(items: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Consecutive same-function fragment/frameshift proteins get
    ' 1', ' 2', ... suffixes; others get their comment stripped."""
    n = len(items)
    suffix = {}
    i = 0
    while i < n:
        fid, func = items[i]
        fun, _sep, comment = seed.split_func_comment(func)
        if not _FRAG_RE.search(comment):
            i += 1
            continue
        j = i + 1
        while j < n:
            fun2, _s2, comment2 = seed.split_func_comment(items[j][1])
            if fun2 != fun or not _FRAG_RE.search(comment2):
                break
            j += 1
        if j - i > 1:
            for k, idx in enumerate(range(i, j), start=1):
                suffix[idx] = k
        i = j
    out = []
    for idx, (fid, func) in enumerate(items):
        if idx in suffix:
            out.append((fid, f"{func} {suffix[idx]}"))
        else:
            out.append((fid, seed.strip_func_comment(func)))
    return out


_LOC_RE = re.compile(r"^(.*?)_(\d+)_(\d+)$")


def find_overlapping_phage_pegs(rows):
    """rows: (fid, location 'ctg_start_stop', function) triples.

    Pegs sharing a (contig, stop) are slippage products; every one except
    the longest is returned as (fid, function) to skip
    (ref: kmers-setup-build.pl:361-395).
    """
    by_stop: dict[tuple[str, str], list] = {}
    for fid, loc, fn in rows:
        m = _LOC_RE.match(loc)
        if not m:
            continue
        ctg, start, stop = m.group(1), int(m.group(2)), int(m.group(3))
        by_stop.setdefault((ctg, m.group(3)), []).append(
            (fid, fn, abs(stop - start)))
    ret = []
    for group in by_stop.values():
        if len(group) > 1:
            group.sort(key=lambda t: -t[2])
            ret.extend((fid, fn) for fid, fn, _len in group[1:])
    return ret


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="skt-setup-build",
        description="Prepare a signature-build data directory")
    p.add_argument("data_dir")
    p.add_argument("--source-seqs", help="directory of per-genome FASTA files")
    p.add_argument("--source-anno",
                   help="directory of per-genome annotation (id\\tfunction) files")
    p.add_argument("--genome", action="append", default=[])
    p.add_argument("--skip-genome", action="append", default=[])
    p.add_argument("--otu-reps")
    p.add_argument("--skip-pegs")
    p.add_argument("--skip-fusions", action="store_true")
    p.add_argument("--additional-fasta", action="append", default=[])
    p.add_argument("--id-map")
    p.add_argument("--no-strip", action="store_true")
    p.add_argument("--virus-dir")
    p.add_argument("--function-overrides")
    p.add_argument("--phage-locations",
                   help="TSV fid\\tctg_start_stop\\tfunction: exclude "
                        "overlapping phage pegs (all but longest per stop)")
    p.add_argument("--protect-subsystem-roles", action="store_true")
    p.add_argument("--subsystem-roles",
                   help="role list written to <dir>/subsystem.roles under "
                        "--protect-subsystem-roles")
    p.add_argument("-p", "--parallel", type=int, default=1)
    args = p.parse_args(argv)

    root = Path(args.data_dir)
    if not root.is_dir():
        print(f"The data directory {root} must already exist", file=sys.stderr)
        return 1
    seqs_dir = root / "Seqs"
    anno_dir = root / "Annotations" / "0"
    gnames_dir = root / "gnames"
    for d in (seqs_dir, anno_dir, gnames_dir):
        d.mkdir(parents=True, exist_ok=True)

    skip_pegs = set()
    if args.skip_pegs:
        for line in Path(args.skip_pegs).read_text().splitlines():
            if line:
                skip_pegs.add(line.split("\t")[0])

    # overlapping phage pegs join the skip set; skipped pairs are printed
    # like the reference (ref: kmers-setup-build.pl:75-77)
    if args.phage_locations:
        rows = []
        for line in Path(args.phage_locations).read_text().splitlines():
            parts = line.split("\t")
            if len(parts) >= 2:
                rows.append((parts[0], parts[1],
                             parts[2] if len(parts) > 2 else ""))
        for fid, fn in find_overlapping_phage_pegs(rows):
            print(f"{fid}\t{fn}")
            skip_pegs.add(fid)

    # genome selection
    genomes: list[str] = []
    if args.otu_reps:
        seen = set()
        otu_lines = []
        for line in Path(args.otu_reps).read_text().splitlines():
            parts = line.split("\t")
            if len(parts) >= 2:
                otu_lines.append(f"{parts[0]}\t{parts[1]}")
                if parts[0] not in seen:
                    genomes.append(parts[1])
                    seen.add(parts[0])
        # the `otus` artifact: full OTU membership for downstream
        # build-signatures --otu-file (populates otu.index, which the
        # reference leaves an empty stub — kmers-build-signatures.cc:186)
        (root / "otus").write_text(
            "".join(l + "\n" for l in otu_lines))
    genomes.extend(args.genome)

    src_seqs = Path(args.source_seqs) if args.source_seqs else None
    src_anno = Path(args.source_anno) if args.source_anno else None
    if not genomes and src_seqs:
        genomes = sorted(p.name for p in src_seqs.iterdir() if p.is_file())
    skip = set(args.skip_genome)
    genomes = [g for g in genomes if g not in skip]

    for g in genomes:
        if (seqs_dir / g).exists():
            continue
        src = src_seqs / g if src_seqs else None
        if src is None or not src.is_file():
            print(f"Missing source fasta for {g}", file=sys.stderr)
            continue
        anno = load_annotations(src_anno / g) if src_anno else {}
        out_seq = []
        items = []
        for rec in fasta_io.iter_fasta(src):
            if not rec.id or rec.id in skip_pegs:
                continue
            func = anno.get(rec.id, rec.defline.strip())
            if args.skip_fusions and " / " in seed.strip_func_comment(func):
                continue
            out_seq.append(f">{rec.id}\n{rec.seq}")
            items.append((rec.id, func))
        if not args.no_strip:
            items = renumber_fragment_runs(items)
        (seqs_dir / g).write_text("\n".join(out_seq) + "\n" if out_seq else "")
        (anno_dir / g).write_text(
            "".join(f"{fid}\t{fn}\n" for fid, fn in items))

    # virus genomes (fasta/ + anno/ layout; ref: :89-128)
    if args.virus_dir:
        vdir = Path(args.virus_dir)
        for org in sorted((vdir / "fasta").iterdir()):
            if not re.fullmatch(r"\d+\.\d+", org.name):
                continue
            anno_file = vdir / "anno" / org.name
            if not anno_file.is_file():
                print(f"Missing anno file {anno_file}", file=sys.stderr)
                return 1
            dst = seqs_dir / org.name
            if not dst.exists():
                dst.write_bytes(org.read_bytes())
            (anno_dir / org.name).write_bytes(anno_file.read_bytes())

    # additional fasta mix-in under synthetic genome ids (ref: :273-325)
    gbase, gidx = 7777777, 1
    additional_funcs = set()
    id_map_lines = []
    for fn in args.additional_fasta:
        g = f"{gbase}.{gidx}"
        gidx += 1
        (gnames_dir / g).write_text(f"Extra {Path(fn).name}\n")
        out_seq, out_ann = [], []
        next_id = 1
        for rec in fasta_io.iter_fasta(fn):
            if not rec.id:
                continue
            defline = re.sub(r"\s+\[[^\]]+\]\s*$", "", rec.defline)
            nid = f"fig|{g}.peg.{next_id}"
            next_id += 1
            id_map_lines.append(f"{rec.id}\t{nid}")
            out_seq.append(f">{nid}\n{rec.seq}")
            fun, _sep, _c = seed.split_func_comment(defline.strip())
            additional_funcs.add(fun)
            out_ann.append(f"{nid}\t{fun}")
        (seqs_dir / g).write_text("\n".join(out_seq) + "\n")
        (anno_dir / g).write_text("\n".join(out_ann) + "\n")
    if args.additional_fasta:
        (root / "additional.funcs").write_text(
            "".join(f"{f}\n" for f in sorted(additional_funcs)))
    if args.id_map:
        Path(args.id_map).write_text("\n".join(id_map_lines) + "\n")

    # per-genome function overrides, appended (ref: :331-351)
    if args.function_overrides:
        per_genome: dict[str, list[str]] = {}
        for line in Path(args.function_overrides).read_text().splitlines():
            if "\t" not in line:
                continue
            fid, fn = line.split("\t", 1)
            per_genome.setdefault(genome_of(fid), []).append(f"{fid}\t{fn}")
        for g, lines in per_genome.items():
            afile = anno_dir / g
            if not afile.is_file():
                print(f"Annotation file {afile} is missing", file=sys.stderr)
            with open(afile, "a") as fh:
                fh.write("".join(line + "\n" for line in lines))

    # subsystem-role protection list (ref: kmers-setup-build.pl:353-359):
    # written once, sorted; build consumes it via --good-roles
    if args.protect_subsystem_roles:
        out = root / "subsystem.roles"
        if not (out.is_file() and out.stat().st_size):
            roles = set()
            if args.subsystem_roles:
                roles = {line for line in
                         Path(args.subsystem_roles).read_text().splitlines()
                         if line}
            out.write_text("".join(f"{r}\n" for r in sorted(roles)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
