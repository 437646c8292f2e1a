"""The port's CLI verbs other than plain call-functions (--debug-hits,
--debug-scoring, annotate-seqs and the matrix-distance verbs) against the
JAX package's CLI on the same data dir and inputs: exit code, stdout,
stderr and every file written must be identical.

These tests sit apart from tests/test_torch_caller.py so that each file
holds few tests: pytest-xdist's --dist loadfile hands out the files with
the most tests first, and small files run beside the suite's longest
file instead of ahead of it."""

import contextlib
import io

import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu_torch.cli.main import main as torch_cli


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
    out = tmp_path_factory.mktemp("torch_kd") / "kd"
    jax_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
             "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(out),
             "--final-kmers", "final.kmers", "--no-recall", "--host-only"])
    return out


def _query_fasta(fixture_dir):
    return sorted((fixture_dir / "Seqs").iterdir())


def _run_cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue(), err.getvalue()


def _verb_inputs(fixture_dir, root):
    """A folder of the query files plus an empty one, a folder output that
    exists already, and a merge base of two genus dirs whose families
    (named by function index) hold parts of the query files."""
    seqs = _query_fasta(fixture_dir)
    folder = root / "folder_in"
    folder.mkdir()
    for f in seqs[:3]:
        (folder / f.name).write_bytes(f.read_bytes())
    (folder / "empty.fa").write_text("")
    base = root / "base"
    for gi, g in enumerate(("g1", "g2")):
        fam_dir = base / g / "fasta_by_function"
        fam_dir.mkdir(parents=True)
        (base / g / "local.family.defs").write_text("present\n")
        for fam, f in enumerate(seqs[:3]):
            recs = [r for r in f.read_text().split(">") if r.strip()]
            part = recs[gi::2] if fam != 2 or gi == 0 else []
            (fam_dir / str(fam)).write_text("".join(">" + r for r in part))
    (base / "not_a_genus").mkdir()
    return seqs, folder, base


VERBS = ("debug-hits", "debug-scoring", "annotate-seqs", "matrix-distance",
         "natural-breaks", "matrix-distance-folder", "matrix-distance-merge")


def _verb_argv(verb, data_dir, fixture_dir, inputs, out):
    seqs, folder, base = inputs
    kd = str(data_dir)
    return {
        "debug-hits": ["call-functions", "-d", kd, "-i", *map(str, seqs),
                       "-o", f"{out}/calls.tsv", "--debug-hits"],
        "debug-scoring": ["call-functions", "-d", kd, "-i", str(seqs[0]),
                          "-o", f"{out}/calls.tsv", "--debug-scoring"],
        "annotate-seqs": ["annotate-seqs", kd, "genus-unused",
                          str(fixture_dir / "Queries"), f"{out}/calls",
                          f"{out}/uncalled"],
        "matrix-distance": ["matrix-distance", "-d", kd, "-i",
                            str(seqs[0])],
        "natural-breaks": ["matrix-distance", "-d", kd, "-i", str(seqs[1]),
                           "--natural-breaks", "3", "-o", f"{out}/d.tsv"],
        "matrix-distance-folder": ["matrix-distance-folder", kd,
                                   str(folder), f"{out}/folder"],
        "matrix-distance-merge": ["matrix-distance-merge", kd, str(base),
                                  f"{out}/merge"],
    }[verb]


def _outputs(verb, cli, data_dir, fixture_dir, inputs, out, extra=()):
    out.mkdir()
    if verb == "matrix-distance-folder":
        # a finished output is left as it is on a restart
        (out / "folder").mkdir()
        (out / "folder" / inputs[1].iterdir().__next__().name).write_text(
            "SENTINEL\n")
    rc, stdout, stderr = _run_cli(
        cli, _verb_argv(verb, data_dir, fixture_dir, inputs, out)
        + list(extra))
    files = {p.relative_to(out).as_posix(): p.read_bytes()
             for p in sorted(out.rglob("*")) if p.is_file()}
    return rc, stdout, stderr, files


@pytest.fixture(scope="module")
def jax_verbs(data_dir, fixture_dir, tmp_path_factory):
    """Each verb once through the JAX CLI: (rc, stdout, stderr, files)."""
    root = tmp_path_factory.mktemp("verbs")
    inputs = _verb_inputs(fixture_dir, root)
    runs = {verb: _outputs(verb, jax_cli, data_dir, fixture_dir, inputs,
                           root / f"jax-{verb}") for verb in VERBS}
    return root, inputs, runs


@pytest.mark.parametrize("verb", VERBS)
def test_cli_verbs_byte_identical(jax_verbs, data_dir, fixture_dir, verb):
    root, inputs, runs = jax_verbs
    want = runs[verb]
    got = _outputs(verb, torch_cli, data_dir, fixture_dir, inputs,
                   root / f"torch-{verb}", ["--device", "cpu"])
    assert got == want
    rc, stdout, stderr, files = got
    assert rc == 0
    if verb == "debug-hits":
        assert stdout.count("\n") > 1000 and stdout.endswith("\t\n")
    elif verb == "debug-scoring":
        assert "Initial calls:" in stderr and "Offset=" in stderr
    elif verb == "matrix-distance":
        assert stdout.count("\n") > 0
    elif verb == "natural-breaks":
        assert stderr.startswith("natural breaks: ")
    elif verb == "matrix-distance-folder":
        assert len(files) == 3 and b"SENTINEL\n" in files.values()
    elif verb == "matrix-distance-merge":
        assert sorted(files) == ["merge/0", "merge/1", "merge/2"]
    else:
        assert files["calls"] and files["uncalled"]
