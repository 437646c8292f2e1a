"""The port's call-path verbs (call-functions with and without
--ignore-hypo and --debug-hits, matrix-distance, --natural-breaks) on edge
queries, against the JAX package's CLI on a data dir the JAX package
built: exit code, stdout and the output file must be identical.

These tests sit apart from tests/test_torch_build.py so that each file
holds few tests: pytest-xdist's --dist loadfile hands out the files with
the most tests first, and small files run beside the suite's longest
file instead of ahead of it."""

import contextlib
import io
import random

import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from tests.fixtures import gen_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(fixture_dir, tmp_path_factory):
    # --host-only: the artifacts of the device build, without compiling
    # the XLA selection
    out = tmp_path_factory.mktemp("edge_kd") / "kd"
    rc, _ = _cli(jax_cli, [
        "build-signatures", "-D", str(fixture_dir / "Annotations"),
        "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(out),
        "--final-kmers", "final.kmers", "--no-recall", "--host-only"])
    assert rc == 0
    return out


def _cli(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def _edge_fasta(path):
    """34 records: an empty sequence, 7 and 8 residues, lower case, '*',
    'X' and 'x' mid-sequence, BZUJO, digits, a trailing '*', 10,000 and
    30,000 residues and a duplicate id, around the corpus's family cores."""
    rng = random.Random(20240817)
    cores = [gen_corpus._rand_prot(rng, 220) for _ in gen_corpus.FUNCTIONS]
    rnd = random.Random(7)

    def noise(n):
        return "".join(rnd.choice(gen_corpus.AA) for _ in range(n))

    recs = [("empty", ""), ("len7", cores[0][:7]), ("len8", cores[0][:8])]
    for i, core in enumerate(cores):
        recs += [(f"core{i}", core), (f"lower{i}", core.lower()),
                 (f"mixed{i}", core[:110].lower() + core[110:])]
    recs += [("star", cores[1][:100] + "*" + cores[1][100:]),
             ("xupper", cores[2][:100] + "X" + cores[2][100:]),
             ("xlower", cores[3][:100] + "x" + cores[3][100:]),
             ("bzujo", cores[4][:60] + "BZUJO" + cores[4][60:]),
             ("digits", cores[5][:80] + "123" + cores[5][80:]),
             ("trailing_star", cores[0] + "*"),
             ("long10k", (noise(400) + cores[1]) * 16 + noise(400)),
             ("long30k", (noise(700) + "".join(cores)) * 13 + noise(1020)),
             ("core0", cores[6][:200]), ("noise", noise(300))]
    assert len(recs) == 34
    path.write_text("".join(f">{name} edge record\n{seq}\n"
                            for name, seq in recs))


EDGE_VERBS = {"call": [], "ignore-hypo": ["--ignore-hypo"],
              "debug-hits": ["--debug-hits"]}


@pytest.mark.parametrize("verb", [*EDGE_VERBS, "matrix-distance",
                                  "natural-breaks"])
def test_edge_queries_byte_identical(data_dir, tmp_path, verb):
    fasta = tmp_path / "edge.fa"
    _edge_fasta(fasta)
    outs = []
    for cli, extra in ((jax_cli, []), (torch_cli, ["--device", "cpu"])):
        out = tmp_path / f"out{len(outs)}.tsv"
        if verb in EDGE_VERBS:
            argv = ["call-functions", "-d", str(data_dir), "-i", str(fasta), "-o",
                    str(out), *EDGE_VERBS[verb]]
        else:
            argv = ["matrix-distance", "-d", str(data_dir), "-i", str(fasta), "-o",
                    str(out)]
            if verb == "natural-breaks":
                argv += ["--natural-breaks", "3"]
        rc, stdout = _cli(cli, argv + extra)
        outs.append((rc, stdout, out.read_bytes()))
    assert outs[1] == outs[0]
    rc, stdout, body = outs[0]
    assert rc == 0 and body
    if verb == "debug-hits":
        assert stdout.count("\n") > 10_000
    if verb == "call":
        assert body.count(b"\n") == 34
