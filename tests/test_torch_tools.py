"""The port's table-tool, setup-build and NuDB writer against the JAX
package's, with exact equality: stdout, stderr, exit code and every file
written (an npz array by array, as its zip carries timestamps).

Each command runs once per package in module-scoped fixtures, on the same
paths (the JAX run's files are read and removed before the port's run), so
that printed paths agree too; the assertions are parametrized over them.
os.urandom is one seeded stream, restarted for each command, so both NuDB
writers draw the same salt and uid."""

import contextlib
import io
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.interop import cmph as jax_cmph, nudb as jax_nudb
from signature_kmers_tpu.table import open_table as jax_open_table
from signature_kmers_tpu.table.bucket_table import BucketKmerTable
from signature_kmers_tpu.table.kmer_table import KmerTable
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.interop import nudb as torch_nudb
from tests.host_routes import require_native

CLIS = (("jax", jax_cli), ("port", torch_cli))
LAYOUTS = ("wide", "cuckoo", "legacy")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fixed_urandom(seed: int = 1234):
    """os.urandom as one seeded byte stream from its start."""
    rng = np.random.default_rng(seed)
    urandom = os.urandom
    os.urandom = rng.bytes
    try:
        yield
    finally:
        os.urandom = urandom


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            fixed_urandom():
        try:
            rc = cli(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _tree(root: Path) -> dict:
    """{relative path: bytes, or {array name: array} for an npz}."""
    files = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(root))
            if p.suffix == ".npz":
                with np.load(p) as z:
                    files[rel] = {k: z[k] for k in z.files}
            else:
                files[rel] = p.read_bytes()
    return files


def _assert_same_tree(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), name
            for k in w:
                assert g[k].dtype == w[k].dtype, (name, k)
                assert np.array_equal(g[k], w[k]), (name, k)
        else:
            assert g == w, name


def _entries(kd):
    return jax_open_table(kd / "kmer_data").occupied()


def _values(hi, v0, v1, v2):
    vals = np.zeros(hi.shape[0], dtype=jax_cmph.STORED_KMER_DTYPE)
    for field, col in zip(vals.dtype.names,
                          KmerTable.unpack_values(v0, v1, v2)):
        vals[field] = col
    return vals


@pytest.fixture(scope="module")
def stores(fixture_dir, tmp_path_factory):
    """Data dirs built by the JAX package: the wide layout (a host-only
    build), the cuckoo and legacy linear layouts of its entries, a NuDB
    store, a CMPH pair with final.kmers beside it, and a legacy and a
    cuckoo table with one key word flipped."""
    root = tmp_path_factory.mktemp("tools_stores")
    kd = root / "wide"
    rc, _, _ = _run(jax_cli, [
        "build-signatures", "-D", str(fixture_dir / "Annotations"),
        "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(kd),
        "--final-kmers", "final.kmers", "--host-only", "--no-recall"])
    assert rc == 0
    hi, lo, v0, v1, v2 = _entries(kd)
    dirs = {"wide": kd}

    def new_dir(name, *extra):
        d = root / name
        d.mkdir()
        for f in ("function.index", *extra):
            shutil.copy(kd / f, d)
        dirs[name] = d
        return d

    BucketKmerTable.build(hi, lo, v0, v1, v2).save(
        new_dir("cuckoo") / "kmer_data")
    KmerTable.build(hi, lo, v0, v1, v2).save(new_dir("legacy") / "kmer_data")
    jax_nudb.write_nudb(new_dir("nudb") / "kmer_data",
                        jax_cmph.keys_from_packed(hi, lo),
                        _values(hi, v0, v1, v2).view(np.uint8).reshape(
                            hi.shape[0], -1), salt=11, uid=12)
    jax_cmph.write_cmph_store(str(new_dir("cmph", "final.kmers")
                                  / "kmer_data"), hi, lo,
                              *KmerTable.unpack_values(v0, v1, v2))
    # one key word flipped: the key read back from its slot is no longer
    # where a probe for it looks.  (A flipped value word cannot fail
    # verify: the probe and occupied() read the same value word.)
    legacy = KmerTable.load(dirs["legacy"] / "kmer_data")
    slot = int(np.flatnonzero(legacy.key_hi != 0xFFFFFFFF)[0])
    legacy.key_lo[slot] ^= 1
    legacy.save(new_dir("legacy-flipped") / "kmer_data")
    cuckoo = BucketKmerTable.load(dirs["cuckoo"] / "kmer_data")
    slot = np.argwhere(cuckoo.packed[:, :cuckoo.slots] != 0xFFFFFFFF)[0]
    cuckoo.packed[slot[0], cuckoo.slots + slot[1]] ^= 1
    cuckoo.save(new_dir("cuckoo-flipped") / "kmer_data")
    return dirs


def _tool_cases():
    cases = {}
    for layout in LAYOUTS:
        cases[f"info-{layout}"] = (layout, lambda d, w: ["info", str(d)])
        cases[f"dump-{layout}"] = (layout, lambda d, w: ["dump", str(d)])
        cases[f"dump-full-{layout}"] = (
            layout, lambda d, w: ["dump", str(d), "--full", "-o",
                                  str(w / "dump.txt")])
        cases[f"verify-{layout}"] = (layout, lambda d, w: ["verify", str(d)])
        cases[f"relayout-{layout}"] = (
            layout, lambda d, w: ["relayout", str(w / "kd")])
        cases[f"export-cmph-{layout}"] = (
            layout, lambda d, w: ["export-cmph", str(d), str(w / "x" / "kd")])
        cases[f"export-nudb-{layout}"] = (
            layout, lambda d, w: ["export-nudb", str(d), str(w / "x" / "kd")])
    for store in ("legacy-flipped", "cuckoo-flipped"):
        cases[f"verify-{store}"] = (store, lambda d, w: ["verify", str(d)])
    cases["build-wide"] = ("wide", lambda d, w: [
        "build", str(d / "final.kmers"), str(w / "built")])
    for store in ("nudb", "cmph"):
        cases[f"import-{store}"] = (store, lambda d, w: [
            "import", str(d), str(w / "imported")])
    cases["info-missing"] = ("nudb", lambda d, w: ["info", str(d)])
    return cases


TOOL_CASES = _tool_cases()


@pytest.fixture(scope="module")
def tool_runs(stores, tmp_path_factory):
    """{case: {"jax"|"port": (rc, stdout, stderr, files written)}}."""
    work = tmp_path_factory.mktemp("tools_work") / "w"
    # relayout places cuckoo keys in each package: on the native route in
    # both
    require_native()
    runs = {}
    for case, (store, argv) in TOOL_CASES.items():
        runs[case] = {}
        for side, cli in CLIS:
            work.mkdir()
            # relayout rewrites its dir in place: each side gets a copy
            shutil.copytree(stores[store], work / "kd")
            try:
                rc, out, err = _run(cli, ["table-tool",
                                          *argv(stores[store], work)])
            except FileNotFoundError as e:
                rc, out, err = "raised", "", str(e)
            runs[case][side] = (rc, out, err, _tree(work))
            shutil.rmtree(work)
    return runs


@pytest.mark.parametrize("case", TOOL_CASES)
def test_table_tool_matches_jax(tool_runs, case):
    want, got = tool_runs[case]["jax"], tool_runs[case]["port"]
    assert got[:3] == want[:3]
    _assert_same_tree(got[3], want[3])
    rc, out, _, files = want
    if case == "info-missing":
        assert rc == "raised"
    elif "flipped" in case:
        assert rc == 1 and "round trip: FAIL" in out
    else:
        assert rc == 0
    if case.startswith("verify-") and "flipped" not in case:
        assert out == ("stored-key round trip: OK\n"
                       "false hits on random probes: 0\n")
    if case.startswith("dump-") and "full" not in case:
        assert out.count("\n") > 1000
    written = {k: v for k, v in files.items()
               if not k.startswith("kd/") or case.startswith("relayout")}
    if case.startswith(("export-", "relayout", "build", "import",
                        "dump-full")):
        assert written and all(len(v) for k, v in written.items()
                               if not k.endswith("otu.index"))


@pytest.mark.parametrize("store", [*LAYOUTS, "legacy-flipped"])
def test_verify_in_slices_matches_jax(stores, tool_runs, store, monkeypatch):
    """verify's probe of every stored key a slice at a time on a thread
    pool (a real table's size; here slices of 97 keys) prints what the
    JAX package's one probe prints."""
    from signature_kmers_tpu_torch.cli import table_tool

    monkeypatch.setattr(table_tool, "_PROBE_SLICE", 97)
    calls = []
    lookup_all = table_tool._lookup_all
    monkeypatch.setattr(table_tool, "_lookup_all", lambda t, hi, lo: (
        calls.append(hi.shape[0]), lookup_all(t, hi, lo))[1])
    rc, out, err = _run(torch_cli, ["table-tool", "verify",
                                    str(stores[store])])
    assert (rc, out, err) == tool_runs[f"verify-{store}"]["jax"][:3]
    assert calls and calls[0] > 10 * 97


# -- the NuDB writer ----------------------------------------------------------

def _spill_keys(n: int, block_size: int, salt: int):
    """n random keys, 25 of them in bucket 0 and 14 in bucket 1 of the
    store write_nudb sizes for n keys at block_size: spill chains of four
    and two records at the bucket capacity (block_size - 8) // 18."""
    rng = np.random.default_rng(5)
    cap = jax_nudb.bucket_capacity(block_size)
    buckets = -(-n // int(0.5 * cap))
    cand = rng.integers(0, 256, (200_000, 8), dtype=np.uint8)
    h = jax_nudb.xxh64_bytes8(cand, salt) & np.uint64(jax_nudb.MASK48)
    b = jax_nudb.bucket_index(h, buckets, jax_nudb._ceil_pow2(buckets))
    keys = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    keys[:25] = cand[b == 0][:25]
    keys[100:114] = cand[b == 1][:14]
    return keys


@pytest.fixture(scope="module")
def nudb_pairs(stores, tmp_path_factory):
    """{case: (keys, values, block_size, JAX base, port base)}."""
    root = tmp_path_factory.mktemp("nudb_pairs")
    hi, lo, v0, v1, v2 = _entries(stores["wide"])
    fixture_keys = jax_cmph.keys_from_packed(hi, lo)
    spill = _spill_keys(300, 128, 77)
    cases = {
        "fixture": (fixture_keys, _values(hi, v0, v1, v2).view(
            np.uint8).reshape(hi.shape[0], -1), 4096),
        "spill": (spill, np.random.default_rng(6).integers(
            0, 256, (300, 10), dtype=np.uint8), 128),
        "empty": (np.zeros((0, 8), np.uint8), np.zeros((0, 10), np.uint8),
                  4096),
    }
    out = {}
    for case, (keys, vals, bs) in cases.items():
        bases = []
        for side, mod in (("jax", jax_nudb), ("port", torch_nudb)):
            base = root / f"{case}-{side}"
            mod.write_nudb(base, keys, vals, block_size=bs, salt=77, uid=78)
            bases.append(base)
        out[case] = (keys, vals, bs, *bases)
    return out


@pytest.mark.parametrize("case", ["fixture", "spill", "empty"])
def test_write_nudb_byte_identical(nudb_pairs, case):
    keys, _, bs, jbase, tbase = nudb_pairs[case]
    for ext in ("dat", "key"):
        want = Path(f"{jbase}.{ext}").read_bytes()
        assert Path(f"{tbase}.{ext}").read_bytes() == want, ext
    buckets = max(1, -(-keys.shape[0] // (jax_nudb.bucket_capacity(bs)
                                          // 2)))
    assert len(want) == (buckets + 1) * bs
    dat = Path(f"{tbase}.dat").read_bytes()
    end = 92 + 24 * keys.shape[0]
    if case == "spill":
        # spill records follow the data records; some point on to another
        # (a chain of two or more)
        chained, off = 0, end
        while off < len(dat):
            size = int.from_bytes(dat[off + 6:off + 8], "big")
            chained += int.from_bytes(dat[off + 10:off + 16], "big") != 0
            off += 8 + size
        assert off == len(dat) and chained >= 3
    else:
        assert len(dat) == end


@pytest.mark.parametrize("case", ["fixture", "spill"])
def test_fetch_nudb_matches_jax(nudb_pairs, case):
    keys, vals, _, jbase, tbase = nudb_pairs[case]
    aliens = np.random.default_rng(7).integers(0, 256, (1000, 8),
                                               dtype=np.uint8)
    query = np.concatenate([keys, aliens])
    want = jax_nudb.fetch_nudb(jbase, query)
    got = torch_nudb.fetch_nudb(tbase, query)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    n = keys.shape[0]
    assert got[0][:n].all() and np.array_equal(got[1][:n], vals)


def _rec(key: bytes, value: bytes) -> bytes:
    return len(value).to_bytes(6, "big") + key + value


def _spill(n: int) -> bytes:
    return (0).to_bytes(6, "big") + n.to_bytes(2, "big") + b"\x07" * n


NUDB_LOGS = {
    "mixed-sizes": _rec(b"A" * 8, b"x" * 10) + _rec(b"B" * 8, b"y" * 12)
    + _rec(b"C" * 8, b"z" * 10),
    "only-spill": _spill(20),
    "spill-first": _spill(5) + _rec(b"A" * 8, b"x" * 10)
    + _rec(b"B" * 8, b"y" * 10),
    "cut-record": _rec(b"A" * 8, b"x" * 10) + _rec(b"B" * 8, b"y" * 10)[:15],
    "cut-spill": _rec(b"A" * 8, b"x" * 10) + (0).to_bytes(6, "big") + b"\1",
    "cut-size": _rec(b"A" * 8, b"x" * 10) + b"\0\0",
    "header-only": b"",
    # value sizes that change at every record, and long runs broken by
    # spill records
    "alternating": b"".join(_rec(i.to_bytes(8, "big"), b"v" * (10 + 2 * (i % 2)))
                            for i in range(3000)),
    "runs-and-spills": b"".join(
        b"".join(_rec(i.to_bytes(8, "big"), b"w" * 10) for i in range(
            500 * j, 500 * j + 37 * j)) + _spill(9) for j in range(12)),
}


@pytest.mark.parametrize("case", ["spill", *NUDB_LOGS])
def test_read_nudb_dat_matches_jax(nudb_pairs, case, tmp_path):
    """Runs of equal-size records read as numpy views, and the records
    between them one by one: the JAX reader's keys and values (or its
    error) on spill chains, mixed value sizes and a log cut short."""
    keys, vals, _, jbase, tbase = nudb_pairs["spill"]
    path = Path(f"{tbase}.dat")
    if case != "spill":
        path = tmp_path / "kmer_data.dat"
        path.write_bytes(Path(f"{jbase}.dat").read_bytes()[:92]
                         + NUDB_LOGS[case])
    out = []
    for mod in (jax_nudb, torch_nudb):
        try:
            out.append(mod.read_nudb_dat(path))
        except ValueError as e:
            out.append(str(e))
    want, got = out
    if isinstance(want, str):
        assert got == want
        return
    assert got[0].shape == want[0].shape
    assert np.array_equal(got[0], want[0])
    if isinstance(want[1], list):
        assert got[1] == want[1]
    else:
        assert got[1].shape == want[1].shape
        assert np.array_equal(got[1], want[1])
    if case == "spill":
        assert np.array_equal(got[0], keys) and np.array_equal(got[1], vals)


@pytest.mark.parametrize("case", ["alternating", "runs-and-spills"])
def test_read_nudb_dat_scans_linearly(case, tmp_path, monkeypatch):
    """The records the reader's views cover stay within a fixed multiple
    of the log's records, however often a run ends (a view of every
    record left at each run's start would cover ~n/2 per record)."""
    path = tmp_path / "kmer_data.dat"
    path.write_bytes(torch_nudb._DAT_HEADER.pack(
        torch_nudb.DAT_TYPE, torch_nudb.VERSION, 1, 1, 8, b"")
        + NUDB_LOGS[case])
    scanned = []
    be_sizes = torch_nudb._be_sizes
    monkeypatch.setattr(torch_nudb, "_be_sizes", lambda rows: (
        scanned.append(rows.shape[0]), be_sizes(rows))[1])
    keys, _ = torch_nudb.read_nudb_dat(path)
    assert keys.shape[0] > 2000
    assert sum(scanned) <= 32 * keys.shape[0]


# -- setup-build ---------------------------------------------------------------

def _setup_inputs(src: Path):
    """The inputs of the JAX package's setup-build tests (tests/test_tools.py)
    plus a fragment run, a virus dir and a genome without its FASTA."""
    seqs, anno = src / "seqs", src / "anno"
    seqs.mkdir(parents=True)
    anno.mkdir()
    (seqs / "100.1").write_text(
        ">fig|100.1.peg.1\nMKLVVAGH\n>fig|100.1.peg.2\nACDEFGHI\n"
        ">fig|100.1.peg.3\nWWYYWWYY\n>fig|100.1.peg.4\nMKLVAAAA\n"
        ">fig|100.1.peg.5\nMKLVCCCC\n>fig|100.1.peg.6 Lone protein # "
        "frameshift\nMKLVDDDD\n")
    (anno / "100.1").write_text(
        "fig|100.1.peg.1\tAlpha synthase\n"
        "fig|100.1.peg.2\tBeta ligase / Gamma ligase\n"
        "fig|100.1.peg.3\tSkipme\n"
        "fig|100.1.peg.4\tBig protein # fragment\n"
        "fig|100.1.peg.5\tBig protein # fragment\n")
    for g in ("1.1", "2.2", "3.3"):
        (seqs / g).write_text(f">fig|{g}.peg.1 Some func # note\nMKLV\n"
                              f">fig|{g}.peg.2\nMKLVWWWWYYYY\n"
                              f">fig|{g}.peg.3\nMKLVNNNN\n")
    (src / "skip").write_text("fig|100.1.peg.3\n")
    (src / "extra.fa").write_text(
        ">ext1 Extra protein func [Some organism]\nMKWWYYAC\n"
        ">ext2 Second extra # comment\nMKWWAC\n")
    (src / "extra2.fa").write_text(">e3 Third one\nMKAC\n")
    (src / "reps").write_text("7\t1.1\n7\t2.2\n9\t3.3\n9\t9.9\n")
    (src / "ov").write_text("fig|1.1.peg.1\tNew func\n"
                            "fig|8.8.peg.1\tOrphan func\nno tab line\n")
    (src / "locs.tsv").write_text("fig|1.1.peg.2\tctgA_10_400\tpp1ab\n"
                                  "fig|1.1.peg.3\tctgA_100_400\tpp1a\n"
                                  "fig|1.1.peg.1\tbadloc\n")
    (src / "roles.txt").write_text("Zeta role\nAlpha role\n\n")
    virus = src / "virus"
    (virus / "fasta").mkdir(parents=True)
    (virus / "anno").mkdir()
    (virus / "fasta" / "555.1").write_text(">fig|555.1.peg.1\nMKVIR\n")
    (virus / "fasta" / "notagenome").write_text(">x\nMK\n")
    (virus / "anno" / "555.1").write_text("fig|555.1.peg.1\tCapsid\n")
    bad_virus = src / "bad_virus"
    (bad_virus / "fasta").mkdir(parents=True)
    (bad_virus / "anno").mkdir()
    (bad_virus / "fasta" / "556.1").write_text(">fig|556.1.peg.1\nMK\n")


def _setup_cases(src: Path):
    s = ["--source-seqs", str(src / "seqs")]
    a = ["--source-anno", str(src / "anno")]
    return {
        "fragments": [*s, *a, "--genome", "100.1"],
        "no-strip": [*s, *a, "--genome", "100.1", "--no-strip"],
        "layout": [*s, *a, "--genome", "100.1", "--skip-pegs",
                   str(src / "skip"), "--skip-fusions", "--additional-fasta",
                   str(src / "extra.fa"), "--additional-fasta",
                   str(src / "extra2.fa"), "--id-map", str(src / "idmap")],
        "otu-reps": [*s, "--otu-reps", str(src / "reps")],
        "genomes": [*s, "--genome", "3.3", "--genome", "4.4",
                    "--skip-genome", "100.1"],
        "all-genomes": [*s, "--skip-genome", "2.2"],
        "virus-dir": [*s, "--genome", "1.1", "--virus-dir",
                      str(src / "virus")],
        "virus-missing-anno": ["--virus-dir", str(src / "bad_virus")],
        "function-overrides": [*s, "--genome", "1.1",
                               "--function-overrides", str(src / "ov")],
        "phage-roles": [*s, "--genome", "1.1", "--phage-locations",
                        str(src / "locs.tsv"), "--protect-subsystem-roles",
                        "--subsystem-roles", str(src / "roles.txt")],
        "roles-kept": [*s, "--genome", "1.1", "--protect-subsystem-roles",
                       "--subsystem-roles", str(src / "roles.txt")],
        "missing-dir": None,
    }


@pytest.fixture(scope="module")
def setup_runs(tmp_path_factory):
    """{case: {"jax"|"port": (rc, stdout, stderr, the tree written)}}."""
    root = tmp_path_factory.mktemp("setup_build")
    src = root / "src"
    _setup_inputs(src)
    out = root / "out"
    runs = {}
    for case, args in _setup_cases(src).items():
        runs[case] = {}
        for side, cli in CLIS:
            if case != "missing-dir":
                out.mkdir()
            if case == "roles-kept":
                (out / "subsystem.roles").write_text("Keep me\n")
            rc, stdout, stderr = _run(cli, ["setup-build", str(out),
                                            *(args or [])])
            files = _tree(out) if out.is_dir() else None
            idmap = src / "idmap"
            if idmap.is_file():
                files["<id-map>"] = idmap.read_bytes()
                idmap.unlink()
            runs[case][side] = (rc, stdout, stderr, files)
            shutil.rmtree(out, ignore_errors=True)
    return runs


SETUP_CASES = list(_setup_cases(Path("src")))


@pytest.mark.parametrize("case", SETUP_CASES)
def test_setup_build_matches_jax(setup_runs, case):
    want, got = setup_runs[case]["jax"], setup_runs[case]["port"]
    assert got == want
    rc, stdout, stderr, files = want
    if case in ("missing-dir", "virus-missing-anno"):
        assert rc == 1 and stderr
        return
    assert rc == 0 and files
    if case == "layout":
        assert files["additional.funcs"] == (b"Extra protein func\n"
                                             b"Second extra\nThird one\n")
        assert b"ext1\tfig|7777777.1.peg.1" in files["<id-map>"]
    if case == "fragments":
        assert (b"Big protein # fragment 2\n"
                in files["Annotations/0/100.1"])
    if case == "otu-reps":
        assert files["otus"] == b"7\t1.1\n7\t2.2\n9\t3.3\n9\t9.9\n"
        assert "Missing source fasta for 9.9" not in stderr
    if case == "phage-roles":
        assert stdout == "fig|1.1.peg.3\tpp1a\n"
        assert files["subsystem.roles"] == b"Alpha role\nZeta role\n"
    if case == "roles-kept":
        assert files["subsystem.roles"] == b"Keep me\n"
    if case == "genomes":
        assert stderr == "Missing source fasta for 4.4\n"


# -- final.kmers and OTU files ------------------------------------------------

FINAL_KMERS = {
    "empty": b"",
    "lower-and-star": b"acdefghy\t3\t4\t\n*XxZzAaB\t0\t65535\t\n",
    "leading-zeros": b"AAAAAAAA\t007\t00002\t\n",
    "crlf": b"AAAAAAAA\t1\t2\t\r\nCCCCCCCC\t3\t4\t\r\n",
    "no-final-newline": b"AAAAAAAA\t1\t2\t",
    "extra-columns": b"AAAAAAAA\t1\t2\t3\t4\t5\n",
    "blank-line": b"AAAAAAAA\t1\t2\t\n\nCCCCCCCC\t3\t4\t\n",
    "signed": b"AAAAAAAA\t+1\t2\t\n",
    "short-kmer": b"AAAAAAA\t1\t2\t\n",
    "too-wide": b"AAAAAAAA\t123456\t2\t\n",
    "missing-field": b"AAAAAAAA\t1\n",
}


def _read_both(path):
    from signature_kmers_tpu.io import formats as jax_formats
    from signature_kmers_tpu_torch.io import formats as torch_formats

    out = []
    for mod in (jax_formats, torch_formats):
        try:
            out.append(mod.read_final_kmers(path))
        except Exception as e:  # noqa: BLE001 (compared by type and text)
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("case", ["writer", *FINAL_KMERS])
def test_read_final_kmers_matches_jax(case, tmp_path):
    """The native parser (the writer's own layout) and the line reader it
    falls back to give the JAX package's arrays, or its error."""
    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.io import formats as torch_formats
    from signature_kmers_tpu_torch.runtime import host

    path = tmp_path / "final.kmers"
    if case == "writer":
        rng = np.random.default_rng(9)
        n = 5000
        torch_formats.write_final_kmers(
            path, rng.integers(0, 1 << 24, n).astype(np.uint32),
            rng.integers(0, 1 << 24, n).astype(np.uint32),
            rng.integers(0, 1 << 16, n).astype(np.uint16),
            rng.integers(0, 1 << 16, n).astype(np.uint16))
    else:
        path.write_bytes(FINAL_KMERS[case])
    want, got = _read_both(path)
    if isinstance(want[0], str):
        assert got == want
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if host.available():
        assert (host.parse_final_kmers(np.fromfile(path, np.uint8),
                                       alphabet.BYTE_TO_CODE) is not None) \
            == (case in ("writer", "empty", "lower-and-star",
                         "leading-zeros"))
    if case == "writer":
        assert want[0].shape[0] == 5000


def test_otu_files_match_jax(tmp_path):
    from signature_kmers_tpu.io import formats as jax_formats
    from signature_kmers_tpu_torch.io import formats as torch_formats

    otus = tmp_path / "otus"
    otus.write_text("7\t1.1\n7\t2.2\n\t5.5\nshort\n9\t3.3\n7\t4.4\n")
    sets = torch_formats.read_otu_sets(otus)
    assert sets == jax_formats.read_otu_sets(otus) == [
        ("7", ["1.1", "2.2", "4.4"]), ("9", ["3.3"])]
    assert torch_formats.read_otu_sets(tmp_path / "none") == []
    for mod, name in ((jax_formats, "jax"), (torch_formats, "port")):
        mod.write_otu_index(tmp_path / name, sets)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
