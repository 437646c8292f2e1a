"""The port's multi-process runtime against the JAX package, on the CPU.

Every rank is a real OS process on gloo (OMP_NUM_THREADS=1, so one torch
thread each), started as the JAX package's ranks are (SKT_COORDINATOR,
SKT_NUM_PROCESSES, SKT_PROCESS_ID) through the port's rank entry point
(python -m signature_kmers_tpu_torch.testing: the port's CLI, or the mesh
programs on a mesh that spans the ranks).  The expected outputs come from
one module fixture that runs each JAX computation once, single-process:
skt call-functions, annotate-seqs, matrix-distance-folder and -merge on
the fixture's data dir, the JAX service's routes, and one FunctionCaller
call and one process_kmers on tests/drivers/mp_driver.py's workload.
Tolerance: exact equality of every file, response, row and kept array.

The cases follow tests/test_multiprocess.py's: the call and the build on
a process-spanning mesh at worlds 2 and 4, the CLI's I/O sharding,
serve --mesh over two ranks, a killed rank in three places, and the
cutoff and the distance on a spanning mesh.  The files are passed to the
ranks in an order whose round-robin shards concatenate to the files'
order, so the merged outputs equal the one-process outputs byte for byte.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from signature_kmers_tpu_torch import testing as port_testing

ROOT = Path(__file__).resolve().parents[1]
# the folder's slow file: random proteins that hit no signature, on rank 1
# of a two-rank run, so that a kill lands while it works
SLOW_SEQS = 3000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n: int, args_of, tmp_path, env_extra=None) -> list:
    """n ranks of the rank entry point, args_of(rank) each."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, SKT_COORDINATOR=f"127.0.0.1:{port}",
                   SKT_NUM_PROCESSES=str(n), SKT_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                   **(env_extra or {}))
        env.pop("SKT_DIST_BACKEND", None)
        log = open(tmp_path / f"rank{r}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "signature_kmers_tpu_torch.testing",
             *args_of(r)], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=tmp_path), log))
    return procs


def _finish(procs, timeout: float = 180) -> list:
    """Wait for every rank (killing what is left at timeout) -> [(rc,
    output)]."""
    deadline = time.time() + timeout
    out = []
    try:
        for p, log in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.seek(0)
            out.append((p.returncode, log.read()))
            log.close()
    return out


def _run(n: int, args_of, tmp_path, timeout: float = 180) -> list:
    res = _finish(_start(n, args_of, tmp_path), timeout)
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{text[-3000:]}"
    return res


def _cli(*argv):
    return ["cli", *map(str, argv), "--device", "cpu"]


def _interleave(files, n: int) -> list:
    """The file order whose shards [r::n] concatenate to files."""
    per = -(-len(files) // n)
    return [files[r * per + i] for i in range(per) for r in range(n)
            if r * per + i < len(files)]


# ---- the JAX package's outputs, once ----------------------------------------

@pytest.fixture(scope="module")
def mp(fixture_dir, tmp_path_factory):
    from signature_kmers_tpu.cli.main import main as jax_cli
    from signature_kmers_tpu.core.config import Config
    from signature_kmers_tpu.io import formats as jax_formats
    from signature_kmers_tpu.io.fasta import SequenceBatch as JaxBatch
    from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
    from signature_kmers_tpu.models.function_caller import \
        FunctionCaller as JaxCaller
    from signature_kmers_tpu.models.matrix_distance import \
        MatrixDistance as JaxDistance
    from signature_kmers_tpu.models.pipeline import load_data_dir
    from signature_kmers_tpu.models.signature_builder import \
        SignatureBuilder as JaxBuilder
    from signature_kmers_tpu.parallel.mesh import make_mesh as jax_mesh
    from signature_kmers_tpu.service.server import AnnotationService
    from signature_kmers_tpu.stats.natural_breaks import \
        sharded_score_cutoff as jax_cutoff
    from signature_kmers_tpu.table.wide_table import \
        WideKmerTable as JaxWide

    root = tmp_path_factory.mktemp("torch_mp")
    kd = root / "kd"
    assert jax_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
                    "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir",
                    str(kd), "--no-recall", "--host-only"]) == 0
    recs = [r for r in (fixture_dir / "Queries" / "queries.fa")
            .read_text().split(">") if r.strip()]
    qdir = root / "queries"
    qdir.mkdir()
    files = []
    for i in range(4):
        f = qdir / f"q{i}.fa"
        f.write_text("".join(">" + r for r in recs[i::4]))
        files.append(f)
    out = dict(root=root, kd=kd, files=files, qdir=qdir)

    exp = root / "expected.tsv"
    assert jax_cli(["call-functions", "-d", str(kd), "-i", *map(str, files),
                    "-o", str(exp)]) == 0
    out["call"] = exp.read_bytes()
    assert jax_cli(["annotate-seqs", str(kd), "genus", str(qdir),
                    str(root / "calls"), str(root / "uncalled")]) == 0
    out["annotate"] = ((root / "calls").read_bytes(),
                       (root / "uncalled").read_bytes())

    # the folder: the query files and, sorted second (rank 1's first file
    # at a world of 2), the slow file
    folder = root / "folder"
    folder.mkdir()
    for f in files:
        (folder / f.name).write_bytes(f.read_bytes())
    rng = np.random.default_rng(5)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    (folder / "q0b.fa").write_text("".join(
        f">r{i}\n{s.tobytes().decode()}\n"
        for i, s in enumerate(aa[rng.integers(0, 20, (SLOW_SEQS, 300))])))
    assert jax_cli(["matrix-distance-folder", str(kd), str(folder),
                    str(root / "folder_out")]) == 0
    out["folder_dir"] = folder
    out["folder"] = {p.name: p.read_bytes()
                     for p in (root / "folder_out").iterdir()}

    # the merge: two genus dirs, a family per query file
    base = root / "base"
    fams = []
    for gi, g in enumerate(("g1", "g2")):
        gd = base / g
        (gd / "fasta_by_function").mkdir(parents=True)
        (gd / "local.family.defs").write_text("present\n")
        for fi, f in enumerate(files):
            part = [r for r in f.read_text().split(">") if r.strip()]
            (gd / "fasta_by_function" / f"fam{fi}").write_text(
                "".join(">" + r for r in (part[gi::2] or part[:1])))
            fams.append(f"fam{fi}")
    fams = sorted(set(fams))
    assert jax_cli(["matrix-distance-merge", str(kd), str(base),
                    str(root / "merge_out"), *fams]) == 0
    out["merge"] = (base, fams, {p.name: p.read_bytes() for p in
                                 (root / "merge_out").iterdir()})

    # the service's routes; /matrix takes twin sequences, which share
    # their k-mers (20 of them: the device route, not the host one)
    body = b"".join(f.read_bytes() for f in files)
    twins = []
    for r in recs:
        head, _, seq = r.partition("\n")
        rid = head.split()[0]
        twins += [f">{rid}.a\n{seq}", f">{rid}.b\n{seq}"]
    matrix_body = "".join(twins).encode()
    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
             "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
             "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    prot = recs[0].partition("\n")[2].replace("\n", "")
    dna = "".join(codon[c] for c in prot if c in codon)
    fastq_body = f"@read0\n{dna}\n+\n{'I' * len(dna)}\n".encode()
    svc = AnnotationService(kd)
    out["serve"] = dict(body=body, matrix_body=matrix_body,
                        fastq_body=fastq_body,
                        query=svc.query_text(body),
                        lookup=svc.lookup_text(body),
                        matrix=svc.matrix_text(matrix_body),
                        fq=svc.fq_lookup_text(fastq_body))
    assert out["serve"]["matrix"].strip() and out["serve"]["fq"].strip()
    (root / "twins.fa").write_bytes(matrix_body)
    table, fi = load_data_dir(kd)
    out["distance"] = [list(r) for r in JaxDistance(table, fi).compute(
        [jax_read(root / "twins.fa")]).rows(with_score=True)]
    del svc

    # the mp driver's workload: one call, one selection, one cutoff
    ptable, pfi, pbatch, chunk = port_testing.mp_workload()
    jt = JaxWide.build(*ptable.occupied())
    cfg = Config()
    jb = JaxBatch(pbatch.codes, pbatch.offsets, pbatch.ids, pbatch.deflines)
    out["mp_rows"] = "".join(
        jax_formats.format_call_row(r.seq_id, r.best.function,
                                    r.best.function_index, r.best.score)
        for r in JaxCaller(jt, pfi, cfg.call, cfg.device).call_batch(jb))
    sb = JaxBuilder()
    sb._seq_chunks.append(chunk)
    out["mp_kept"] = port_testing.kept_digest(sb.process_kmers(), sb.stats)
    c = dict(n=20_000, seed=3)
    r2 = np.random.default_rng(c["seed"])
    scores = np.concatenate([r2.normal(0.2, 0.05, c["n"] // 2),
                             r2.normal(0.7, 0.1, c["n"] - c["n"] // 2)])
    out["cutoff"] = (c, jax_cutoff(jax_mesh(8), scores.astype(np.float32)))
    return out


def _regroup(text: bytes, files, order) -> bytes:
    """One-process output lines regrouped by input file, in ``order`` (the
    files' order in a merged output)."""
    file_of = {r.split()[0].encode(): i for i, f in enumerate(files)
               for r in f.read_text().split(">") if r.strip()}
    lines = text.splitlines(keepends=True)
    return b"".join(sorted(lines, key=lambda ln: order.index(
        file_of[ln.split(b"\t")[0].rstrip(b"\n")])))


# ---- 1-2: the call and the build on a process-spanning mesh ----------------

@pytest.mark.parametrize("world,cells", [(2, 2), (4, 1)])
def test_call_and_build_span_processes(mp, tmp_path, world, cells):
    """World 2 with two CPU cells a rank (tp within a rank, dp across),
    and world 4 with one each (dp and tp both across ranks): every rank's
    call rows and kept set equal JAX's single-device results, and every
    rank's digest is the same."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(device="cpu", cells=cells, tp=2,
                                    workload="mp", call_batch=32,
                                    out=str(tmp_path / "res"))))
    _run(world, lambda r: ["mesh", str(spec)], tmp_path)
    res = [json.loads((tmp_path / f"res.{r}").read_text())
           for r in range(world)]
    for r, x in enumerate(res):
        assert x["spans"] and x["shape"] == {"dp": cells * world // 2,
                                             "tp": 2}
        assert x["shard_inputs"] == list(range(10))[r::world]
        assert x["rows"] == mp["mp_rows"]
        assert x["kept"] == mp["mp_kept"]
    assert len({json.dumps([x["rows"], x["kept"]]) for x in res}) == 1
    assert mp["mp_kept"]["n"] > 0


# ---- 3-7: the CLI's I/O sharding --------------------------------------------

def test_cli_call_io_sharding(mp, tmp_path):
    merged = tmp_path / "merged.tsv"
    _run(2, lambda r: _cli("call-functions", "-d", mp["kd"], "-i",
                           *_interleave(mp["files"], 2), "-o", merged),
         tmp_path)
    assert merged.read_bytes() == mp["call"]
    assert not list(tmp_path.glob("merged.tsv.shard*"))


def test_cli_call_mesh_local(mp, tmp_path):
    """--mesh under two processes: each rank's mesh is its own devices
    (make_mesh(local=True))."""
    merged = tmp_path / "merged.tsv"
    _run(2, lambda r: _cli("call-functions", "-d", mp["kd"], "-i",
                           *_interleave(mp["files"], 2), "-o", merged,
                           "--mesh", "--tp", "1"), tmp_path)
    assert merged.read_bytes() == mp["call"]


def test_cli_annotate(mp, tmp_path):
    """annotate-seqs: the sequence files sharded, both outputs merged."""
    calls, unc = tmp_path / "calls", tmp_path / "uncalled"
    _run(2, lambda r: _cli("annotate-seqs", mp["kd"], "genus", mp["qdir"],
                           calls, unc), tmp_path)
    want_calls, want_unc = mp["annotate"]
    # the merge concatenates rank 0's files (q0, q2), then rank 1's
    order = [0, 2, 1, 3]
    assert calls.read_bytes() == _regroup(want_calls, mp["files"], order)
    assert unc.read_bytes() == _regroup(want_unc, mp["files"], order)
    assert want_calls and want_unc
    assert not list(tmp_path.glob("*.shard*"))


def test_cli_folder_4way(mp, tmp_path):
    out = tmp_path / "out"
    _run(4, lambda r: _cli("matrix-distance-folder", mp["kd"],
                           mp["folder_dir"], out), tmp_path)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == mp["folder"]


def test_cli_merge_4way(mp, tmp_path):
    base, fams, want = mp["merge"]
    out = tmp_path / "out"
    _run(4, lambda r: _cli("matrix-distance-merge", mp["kd"], base, out,
                           *fams), tmp_path)
    assert {p.name: p.read_bytes() for p in out.iterdir()} == want


# ---- 8: serve --mesh --tp 2 over two ranks ---------------------------------

def _req(port, path, body=None, timeout=120):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   data=body, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    return r.status, r.read().decode()


def _serve(mp, tmp_path, port):
    procs = _start(2, lambda r: _cli("serve", "-d", mp["kd"], "--port", port,
                                     "--mesh", "--tp", "2"), tmp_path)
    deadline = time.time() + 120
    while time.time() < deadline:
        if any(p.poll() is not None for p, _ in procs):
            break
        try:
            if "signature_kmers_tpu_torch" in _req(port, "/version", None,
                                                   5)[1]:
                return procs
        except OSError:
            time.sleep(0.3)
    res = _finish(procs, 5)
    raise AssertionError(f"the service did not come up: {res}")


def test_serve_mesh_two_ranks(mp, tmp_path):
    """Rank 0's HTTP front end on the (1, 2) mesh over both ranks: /query,
    /lookup, /matrix and /fq_lookup answer the JAX service's bytes, /add
    rebuilds on both ranks (the /query after it runs on the new sharded
    table everywhere), and /quit ends both ranks with rc 0."""
    s = mp["serve"]
    port = _free_port()
    procs = _serve(mp, tmp_path, port)
    try:
        assert _req(port, "/query", s["body"]) == (200, s["query"])
        assert _req(port, "/lookup", s["body"]) == (200, s["lookup"])
        assert _req(port, "/matrix", s["matrix_body"]) == (200, s["matrix"])
        assert _req(port, "/fq_lookup", s["fastq_body"]) == (200, s["fq"])
        assert _req(port, "/add", b"ACDEFGHI\t5\t3\t250\t250\t0\n") == \
            (200, "added 1\n")
        assert _req(port, "/query", s["body"]) == (200, s["query"])
        sizes = dict(line.split("\t") for line in
                     _req(port, "/dump_sizes")[1].splitlines())
        assert sizes["query_depth"] == "4" and sizes["kmers"] != "0"
        assert _req(port, "/quit") == (200, "OK\n")
    finally:
        res = _finish(procs, 60)
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{text[-3000:]}"


# ---- 9-11: a killed rank ----------------------------------------------------

def test_kill_rank_call_mesh_fails_fast(mp, tmp_path):
    """Rank 1 is killed mid call-functions --mesh (its input is a FIFO
    that nobody writes, so it waits there); rank 0, done with its files,
    waits at the barrier and must exit non-zero within 60 s, naming the
    failure."""
    fifo = tmp_path / "never.fa"
    os.mkfifo(fifo)
    out = tmp_path / "out.tsv"
    procs = _start(2, lambda r: _cli("call-functions", "-d", mp["kd"], "-i",
                                     mp["files"][0], fifo, "-o", out,
                                     "--mesh", "--tp", "1"), tmp_path)
    shard0 = tmp_path / "out.tsv.shard00000"
    deadline = time.time() + 120
    while not shard0.exists() and time.time() < deadline:
        time.sleep(0.05)
    assert shard0.exists(), _finish(procs, 5)
    time.sleep(0.5)
    procs[1][0].kill()
    t0 = time.time()
    res = _finish(procs, 60)
    assert time.time() - t0 < 60
    assert res[1][0] == -signal.SIGKILL
    rc, text = res[0]
    assert rc not in (None, 0), text[-3000:]
    assert "a peer process exited" in text and "Connection closed" in text


def test_kill_rank_folder_then_rerun(mp, tmp_path):
    """Rank 1 is killed while it works on its slow file; rank 0 exits
    non-zero at the closing barrier, and a one-process rerun over the same
    output dir skips the files that exist and ends with JAX's files."""
    out = tmp_path / "out"
    procs = _start(2, lambda r: _cli("matrix-distance-folder", mp["kd"],
                                     mp["folder_dir"], out), tmp_path)
    deadline = time.time() + 120
    while time.time() < deadline and not (out.is_dir() and any(
            out.iterdir())):
        time.sleep(0.02)
    procs[1][0].kill()
    res = _finish(procs, 60)
    assert res[1][0] == -signal.SIGKILL
    assert res[0][0] not in (None, 0), res[0][1][-3000:]
    assert "q0b.fa" not in {p.name for p in out.iterdir()}
    from signature_kmers_tpu_torch.cli.main import main as torch_cli

    assert torch_cli(["matrix-distance-folder", str(mp["kd"]),
                      str(mp["folder_dir"]), str(out), "--device",
                      "cpu"]) == 0
    assert {p.name: p.read_bytes() for p in out.iterdir()} == mp["folder"]


def test_kill_follower_serve_fails_fast(mp, tmp_path):
    """The follower is killed while rank 0 serves: the next /query gets a
    500 (or no answer) and rank 0 exits non-zero; nothing hangs."""
    port = _free_port()
    procs = _serve(mp, tmp_path, port)
    procs[1][0].kill()
    procs[1][0].wait(timeout=30)
    t0 = time.time()
    try:
        status, _text = _req(port, "/query", mp["serve"]["body"], 60)
        assert status == 500
    except OSError:
        pass  # rank 0 already stopped
    res = _finish(procs, 60)
    assert time.time() - t0 < 60
    assert res[0][0] not in (None, 0), res[0][1][-3000:]
    assert "lost a rank" in res[0][1]


# ---- 12: the cutoff and the distance on a spanning mesh ---------------------

def test_cutoff_and_distance_span_processes(mp, tmp_path):
    """sharded_score_cutoff (the histograms summed over the ranks) and
    MatrixDistance.compute(mesh=) (the pair counts summed over the ranks)
    on a dp-4 mesh of two ranks with two cells each: the same float and
    rows on every rank, equal to JAX's."""
    c, want_cut = mp["cutoff"]
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(
        device="cpu", cells=2, tp=1, cutoff=c, out=str(tmp_path / "res"),
        distance=str(mp["root"] / "twins.fa"),
        data_dir_distance=str(mp["kd"]))))
    _run(2, lambda r: ["mesh", str(spec)], tmp_path)
    for r in range(2):
        x = json.loads((tmp_path / f"res.{r}").read_text())
        assert x["spans"] and x["shape"] == {"dp": 4, "tp": 1}
        assert x["cutoff"] == want_cut
        assert x["distance"] == mp["distance"]
    assert mp["distance"]
