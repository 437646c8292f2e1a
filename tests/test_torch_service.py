"""The port's annotation service (AnnotationService(device="cpu"),
serve_async, the serve verb) against the JAX package's service: every
route's response — status line, headers and body — must be the same
bytes, apart from /version's framework line and /dump_sizes' two timing
counters.  Also the coalescing batcher, the depth-4 overlap, warm, and the
port caller's thread safety (4 threads calling one FunctionCaller)."""

import asyncio
import shutil
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.core import dna as jax_dna
from signature_kmers_tpu.service import server as jax_server
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.io.fasta import read_fasta_batch
from signature_kmers_tpu_torch.models import pipeline
from signature_kmers_tpu_torch.models.function_caller import FunctionCaller
from signature_kmers_tpu_torch.service import server as torch_server
from tests.fixtures.gen_corpus import FUNCTIONS, _rand_prot

import random

N_CLIENTS = 8
TIMING_LINES = ("query_call_ms\t", "query_call_max_ms\t")


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
    out = tmp_path_factory.mktemp("svc_kd") / "kd"
    # --host-only: the same artifacts, without compiling the XLA selection
    jax_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
             "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(out),
             "--final-kmers", "final.kmers", "--no-recall", "--host-only"])
    (out / "gnames").mkdir()
    (out / "gnames" / "1000.7").write_text("Genus species 1000.7\n")
    return out


def _fasta(records) -> bytes:
    return "".join(f">{i}\n{s}\n" for i, s in records).encode()


def _back_translate(pep: str) -> str:
    codon = {}
    for i, aa in enumerate(jax_dna._CODE_TABLE):
        codon.setdefault(
            aa, "TCAG"[i // 16] + "TCAG"[(i // 4) % 4] + "TCAG"[i % 4])
    return "".join(codon[a] for a in pep)


def _bodies(fixture_dir):
    """The request bodies: fixture queries, training proteins, reads in
    all six frames, final.kmers lines of new keys and one override."""
    queries = (fixture_dir / "Queries" / "queries.fa").read_bytes()
    seqs = sorted((fixture_dir / "Seqs").iterdir())
    related = seqs[0].read_bytes() + seqs[1].read_bytes()
    rng = random.Random(20240817)
    cores = [_rand_prot(rng, 220) for _ in FUNCTIONS]
    reads, r = [], random.Random(5)
    for i, core in enumerate(cores):
        frame = (1, 2, 3, -1, -2, -3)[i % 6]
        # the strand that carries the protein at offset |frame| - 1
        dna = ("ACG"[:abs(frame) - 1] + _back_translate(core[10:200])
               + "T" * r.randrange(3))
        if frame < 0:
            dna = jax_dna.reverse_complement(dna)
        if i == 2:
            dna = dna[:60] + "N" + dna[61:]  # an ambiguous codon
        reads.append((f"r{i}", dna))
    reads.append(("short", "ACGTACGTAC"))
    reads.append(("decoy", _back_translate(_rand_prot(r, 120))))
    fastq = "".join(f"@{i} read\n{s}\n+\n{'I' * len(s)}\n"
                    for i, s in reads).encode()
    # 40 k-mers of a new 60-aa protein under function 2, one override
    newp = _rand_prot(random.Random(99), 60)
    kmer_lines = "".join(f"{newp[p:p + 8]}\t{60 - p}\t2\t60\t60\t0\n"
                         for p in range(40))
    kmer_lines += "bad line\n" + f"{cores[0][20:28]}\t7\t3\t\t\t\n"
    mapping = (f"{cores[1][30:38]}\t5\t11\t\n{cores[1][50:58]}\t6\t12\t\n"
               f"{cores[2][30:38]}\t7\t13\t\n").encode()
    mapping2 = f"{cores[1][30:38]}\t9\t14\t\nWWWWYYYY\t1\t2\t\n".encode()
    mseqs = _fasta([("m0", cores[1][20:120]), ("m1", cores[1][25:90]),
                    ("m2", cores[2]), ("m3", "ACDEFGHIKL")])
    return dict(queries=queries, related=related, fastq=fastq,
                kmers=kmer_lines.encode(), mapping=mapping,
                mapping2=mapping2, mseqs=mseqs,
                newp=_fasta([("new", newp), ("q0", cores[0])]),
                clients=[_fasta([(f"c{c}.{j}", cores[(c + j) % len(cores)])
                                 for j in range(1 + c % 3)])
                         for c in range(N_CLIENTS)])


def _script(b):
    """(name, method, path, body) in the order both services answer."""
    reqs = [("version", "GET", "/version", b""),
            ("query", "POST", "/query", b["queries"] + b["related"]),
            ("lookup", "POST", "/lookup", b["queries"]),
            ("matrix", "POST", "/matrix", b["related"]),
            ("fq_lookup", "POST", "/fq_lookup", b["fastq"]),
            ("dump_sizes", "GET", "/dump_sizes", b""),
            ("genus_lookup", "GET", "/genus_lookup/1000.7", b""),
            ("genus_missing", "GET", "/genus_lookup/none", b""),
            ("mapping_add", "POST", "/mapping/fam1/add", b["mapping"]),
            ("mapping_add_again", "POST", "/mapping/fam1/add",
             b["mapping2"]),
            ("mapping_lookup", "POST", "/mapping/fam1/lookup", b["mseqs"]),
            ("mapping_matrix", "POST", "/mapping/fam1/matrix", b["mseqs"]),
            ("mapping_missing", "POST", "/mapping/none/lookup", b["mseqs"]),
            ("mapping_bad_op", "POST", "/mapping/fam1/nope", b""),
            ("dump_mapping", "GET", "/dump_mapping", b""),
            ("unknown", "GET", "/nope", b"")]
    reqs += [(f"client{c}", "POST", "/query", body)
             for c, body in enumerate(b["clients"])]
    reqs += [("add", "POST", "/add", b["kmers"]),
             ("query_after_add", "POST", "/query", b["newp"]),
             ("lookup_after_add", "POST", "/lookup", b["newp"]),
             ("dump_sizes_after_add", "GET", "/dump_sizes", b""),
             ("checkpoint", "GET", "/checkpoint", b""),
             ("quit", "GET", "/quit", b"")]
    return reqs


class _Sink:
    """The writer side of one connection: keeps what _handle writes."""

    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def _answer(server_mod, svc, reqs) -> dict:
    """Each request through the module's own connection handler (the
    HTTP framing included) -> {name: response bytes}."""

    async def run():
        stop = asyncio.Event()
        out = {}
        for name, method, path, body in reqs:
            reader = asyncio.StreamReader()
            head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
            if body:
                head += f"Content-Length: {len(body)}\r\n"
            reader.feed_data(head.encode() + b"\r\n" + body)
            reader.feed_eof()
            sink = _Sink()
            await server_mod._handle(svc, stop, reader, sink)
            out[name] = bytes(sink.data)
        return out

    return asyncio.run(run())


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _cuckoo_dir(data_dir, dst):
    from signature_kmers_tpu.table import open_table
    from signature_kmers_tpu.table.bucket_table import BucketKmerTable

    dst.mkdir()
    t = open_table(data_dir / "kmer_data")
    BucketKmerTable.build(*t.occupied()).save(dst / "kmer_data")
    shutil.copy(data_dir / "function.index", dst)
    return str(dst)


def _cmph_dir(data_dir, dst):
    from signature_kmers_tpu.interop import cmph
    from signature_kmers_tpu.table import open_table
    from signature_kmers_tpu.table.kmer_table import KmerTable

    dst.mkdir()
    hi, lo, v0, v1, v2 = open_table(data_dir / "kmer_data").occupied()
    cmph.write_cmph_store(str(dst / "kmer_data"), hi, lo,
                          *KmerTable.unpack_values(v0, v1, v2))
    shutil.copy(data_dir / "function.index", dst)
    return str(dst)


@pytest.fixture(scope="module")
def answers(data_dir, fixture_dir, tmp_path_factory):
    """{(store, name): (JAX response, port response)} and the reopened
    checkpointed dirs."""
    root = tmp_path_factory.mktemp("svc")
    b = _bodies(fixture_dir)
    got = {}
    dirs = {}
    for who, mod, kw in (("jax", jax_server, {}),
                         ("port", torch_server, {"device": "cpu"})):
        wide = _copy(data_dir, root / f"wide_{who}")
        dirs[who] = wide
        stores = {"wide": (wide, _script(b)),
                  "cuckoo": (_cuckoo_dir(data_dir, root / f"cuckoo_{who}"),
                             _script(b)[:6]),
                  "cmph": (_cmph_dir(data_dir, root / f"cmph_{who}"),
                           _script(b)[:6]
                           + [("add", "POST", "/add", b["kmers"]),
                              ("checkpoint", "GET", "/checkpoint", b"")])}
        for store, (d, reqs) in stores.items():
            svc = mod.AnnotationService(d, **kw)
            for name, resp in _answer(mod, svc, reqs).items():
                got.setdefault((store, name), {})[who] = resp
        # the checkpointed wide dir, reopened
        svc = mod.AnnotationService(wide, **kw)
        for name, resp in _answer(mod, svc, [
                ("version", "GET", "/version", b""),
                ("query", "POST", "/query", b["newp"] + b["queries"])
        ]).items():
            got.setdefault(("reopened", name), {})[who] = resp
    return {k: (v["jax"], v["port"]) for k, v in got.items()}, dirs, b


def _split(resp: bytes):
    head, _, body = resp.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    headers = [h for h in lines[1:] if not h.startswith(b"Content-Length")]
    length = [int(h.split(b":")[1]) for h in lines[1:]
              if h.startswith(b"Content-Length")]
    assert length == [len(body)]
    return lines[0], headers, body


WIDE = ["version", "query", "lookup", "matrix", "fq_lookup", "dump_sizes",
        "genus_lookup", "genus_missing", "mapping_add", "mapping_add_again",
        "mapping_lookup", "mapping_matrix", "mapping_missing",
        "mapping_bad_op", "dump_mapping", "unknown"] + [
        f"client{c}" for c in range(N_CLIENTS)] + [
        "add", "query_after_add", "lookup_after_add",
        "dump_sizes_after_add", "checkpoint", "quit"]
ALL = ([("wide", n) for n in WIDE]
       + [("cuckoo", n) for n in WIDE[:6]]
       + [("cmph", n) for n in WIDE[:6] + ["add", "checkpoint"]]
       + [("reopened", n) for n in ("version", "query")])


@pytest.mark.parametrize("store,name", ALL, ids=[f"{s}-{n}" for s, n in ALL])
def test_response_bytes_match_jax(answers, store, name):
    want, got = answers[0][(store, name)]
    if name == "version" or (name.startswith("dump_sizes")
                             and want.startswith(b"HTTP/1.1 200")):
        # one line differs by design: compare the rest, the framing whole
        (ws, wh, wb), (gs, gh, gb) = _split(want), _split(got)
        assert (gs, gh) == (ws, wh)
        if name == "version":
            wb = wb.replace(b"signature_kmers_tpu 0.1.0\n",
                            b"signature_kmers_tpu_torch 0.1.0\n")
            if store == "cmph":
                # the JAX CmphKmerTable.size is a method, so the JAX line
                # prints a bound method; the port prints its value
                lines = wb.split(b"\n")
                assert lines[2].startswith(b"table_slots <bound method ")
                lines[2] = lines[1].replace(b"kmers", b"table_slots")
                wb = b"\n".join(lines)
            assert gb == wb
        else:
            def keep(body):
                return [ln for ln in body.split(b"\n")
                        if not ln.decode().startswith(TIMING_LINES)]

            assert keep(gb) == keep(wb)
            assert len(keep(gb)) == 9
    else:
        assert got == want


def test_responses_carry_calls(answers):
    """The compared responses are not vacuous: calls, hits, pairs, frames
    and the added k-mers' call are in them."""
    ans = answers[0]
    for store in ("wide", "cuckoo", "cmph"):
        body = _split(ans[(store, "query")][1])[2]
        assert FUNCTIONS[0].encode() in body
        assert len(_split(ans[(store, "lookup")][1])[2].splitlines()) > 100
    assert len(_split(ans[("wide", "matrix")][1])[2].splitlines()) > 10
    fq = _split(ans[("wide", "fq_lookup")][1])[2].decode().splitlines()
    frames = {ln.split("\t")[1] for ln in fq}
    assert frames == {"+1", "+2", "+3", "-1", "-2", "-3"}
    assert _split(ans[("wide", "add")][1])[2] == b"added 41\n"
    new = _split(ans[("wide", "query_after_add")][1])[2].decode()
    assert new.splitlines()[0].split("\t")[2:] == ["2", "40"]
    assert _split(ans[("wide", "mapping_matrix")][1])[2].count(b"\n") >= 1
    # the keyless CMPH store has no bucket count and no key list: both
    # services answer /dump_sizes and /add with a 500
    for name in ("dump_sizes", "add"):
        assert ans[("cmph", name)][1].startswith(
            b"HTTP/1.1 500 Internal Server Error\r\n")
    assert ans[("wide", "unknown")][1].startswith(b"HTTP/1.1 404")


def test_checkpoint_reopens_to_the_same_table(answers):
    from signature_kmers_tpu.models.pipeline import load_data_dir as jax_load

    dirs = answers[1]
    jt, _ = jax_load(dirs["jax"])
    tt, _ = pipeline.load_data_dir(dirs["port"])
    assert tt.n_items == jt.n_items
    for a, b in zip(tt.occupied(), jt.occupied()):
        np.testing.assert_array_equal(a, b)


def test_query_answers_during_checkpoint(answers, data_dir, tmp_path):
    """/checkpoint saves off the event loop's thread: a /query sent while
    a slow save runs answers before the checkpoint does, and both
    responses are the JAX service's bytes."""
    svc = torch_server.AnnotationService(
        _copy(data_dir, tmp_path / "kd"), device="cpu")
    started, release = threading.Event(), threading.Event()
    save = svc.table.save

    def slow_save(*a, **kw):
        started.set()
        release.wait(10)
        return save(*a, **kw)

    svc.table.save = slow_save
    done = []

    async def one(name, method, path, body=b""):
        reader = asyncio.StreamReader()
        head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
        if body:
            head += f"Content-Length: {len(body)}\r\n"
        reader.feed_data(head.encode() + b"\r\n" + body)
        reader.feed_eof()
        sink = _Sink()
        await torch_server._handle(svc, asyncio.Event(), reader, sink)
        done.append(name)
        return bytes(sink.data)

    async def run():
        ckpt = asyncio.ensure_future(one("checkpoint", "GET", "/checkpoint"))
        while not started.is_set():
            await asyncio.sleep(0.01)
        b = answers[2]
        query = await one("query", "POST", "/query",
                          b["queries"] + b["related"])
        release.set()
        return query, await ckpt

    query, ckpt = asyncio.run(run())
    assert done == ["query", "checkpoint"]
    assert query == answers[0][("wide", "query")][0]
    assert ckpt == answers[0][("wide", "checkpoint")][0]
    assert ckpt.endswith(b"checkpointed\n")


def _start(data_dir, tmp_path, **kw):
    """The port's serve_async in a thread on port 0 -> (base URL, thread,
    the service it built)."""
    built = []
    pf = tmp_path / "listen.port"
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=lambda: loop.run_until_complete(
        torch_server.serve_async(
            str(data_dir), port=0, device="cpu", listen_port_file=str(pf),
            on_ready=lambda svc, port: built.append((svc, port)), **kw)),
        daemon=True)
    t.start()
    for _ in range(600):
        if built:
            break
        time.sleep(0.05)
    else:
        raise RuntimeError("the server never listened")
    svc, port = built[0]
    assert int(pf.read_text()) == port
    return f"http://127.0.0.1:{port}", t, svc


def _raw_post(base, path, body) -> bytes:
    """One request over a socket; the whole response as sent."""
    import socket

    host, port = base.split("//")[1].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
                  f"{len(body)}\r\n\r\n".encode() + body)
        chunks = []
        while True:
            c = s.recv(65536)
            if not c:
                return b"".join(chunks)
            chunks.append(c)


def test_http_clients_coalesce_with_jax_bytes(answers, data_dir, tmp_path,
                                             monkeypatch):
    """8 concurrent clients over HTTP: every response is the JAX service's
    bytes for the same body, and the batcher merged requests."""
    monkeypatch.delenv("SKT_SERVE_DEPTH", raising=False)
    base, thread, svc = _start(data_dir, tmp_path)
    assert svc.batcher.depth == 4
    caller = svc.engines.caller
    orig = caller.call_batch
    entered = [0]
    lock = threading.Lock()
    n_seqs = sum(1 + c % 3 for c in range(N_CLIENTS))

    def gated(batch, *a, **k):
        # every call waits until all clients' sequences are in a call or
        # queued, so requests arriving meanwhile must coalesce
        with lock:
            entered[0] += len(batch)
        for _ in range(1200):
            pending = sum(len(b) for b, *_ in svc.batcher.pending)
            if entered[0] + pending >= n_seqs:
                break
            time.sleep(0.01)
        return orig(batch, *a, **k)

    caller.call_batch = gated
    bodies = answers[2]["clients"]
    out = [None] * N_CLIENTS
    barrier = threading.Barrier(N_CLIENTS)

    def client(c):
        barrier.wait()
        out[c] = _raw_post(base, "/query", bodies[c])

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for c in range(N_CLIENTS):
        assert out[c] == answers[0][("wide", f"client{c}")][0]
    assert 1 <= svc.batcher.batches_run < N_CLIENTS
    assert svc.batcher.seqs_run == n_seqs
    urllib.request.urlopen(base + "/quit", timeout=30).read()
    thread.join(30)
    assert not thread.is_alive()


def test_listen_port_file_and_kmer_version(data_dir, tmp_path):
    base, thread, _ = _start(data_dir, tmp_path, kmer_version="V2024test")
    v = urllib.request.urlopen(base + "/version", timeout=30).read()
    assert v.startswith(b"kmer\tV2024test\nsignature_kmers_tpu_torch 0.1.0\n")
    assert urllib.request.urlopen(base + "/quit", timeout=30).read() == b"OK\n"
    thread.join(30)
    assert not thread.is_alive()


def _cores():
    r = random.Random(20240817)
    return [(fn, _rand_prot(r, 220)) for fn in FUNCTIONS]


def test_concurrent_queries_coalesce(data_dir):
    svc = torch_server.AnnotationService(str(data_dir), device="cpu")
    cores = _cores()

    async def run():
        reqs = [f">q{i}\n{seq}\n".encode()
                for i, (_fn, seq) in enumerate(cores)]
        return await asyncio.gather(*[svc.batcher.query(b) for b in reqs])

    outs = asyncio.run(run())
    assert len(outs) == len(cores)
    for i, ((fn, _seq), out) in enumerate(zip(cores, outs)):
        lines = out.splitlines()
        assert len(lines) == 1
        f = lines[0].split("\t")
        assert f[0] == f"q{i}" and f[1] == fn
    # all requests were queued before the drain task first ran, so they
    # shared one batch
    assert svc.batcher.batches_run == 1


def test_overlapped_dispatch(data_dir, monkeypatch):
    """Requests arriving while one batch is in call_batch are taken by a
    SECOND worker concurrently (depth > 1)."""
    monkeypatch.delenv("SKT_SERVE_DEPTH", raising=False)
    svc = torch_server.AnnotationService(str(data_dir), device="cpu")
    assert svc.batcher.depth == 4
    caller = svc.engines.caller
    orig = caller.call_batch
    state = {"cur": 0, "max": 0}
    lock = threading.Lock()
    entered = [threading.Event(), threading.Event()]
    gate = threading.Event()
    n_entries = [0]

    def slow(batch, *a, **k):
        with lock:
            state["cur"] += 1
            state["max"] = max(state["max"], state["cur"])
            i = n_entries[0]
            n_entries[0] += 1
        if i < len(entered):
            entered[i].set()
        assert gate.wait(30)
        try:
            return orig(batch, *a, **k)
        finally:
            with lock:
                state["cur"] -= 1

    caller.call_batch = slow
    r = random.Random(20250821)
    seqs = [_rand_prot(r, 220) for _ in range(3)]

    async def run():
        loop = asyncio.get_event_loop()
        t1 = asyncio.ensure_future(
            svc.batcher.query(f">a\n{seqs[0]}\n".encode()))
        await loop.run_in_executor(None, entered[0].wait, 30)
        t2 = asyncio.ensure_future(
            svc.batcher.query(f">b\n{seqs[1]}\n".encode()))
        t3 = asyncio.ensure_future(
            svc.batcher.query(f">c\n{seqs[2]}\n".encode()))
        # batch 2 (t2+t3 coalesced) starts while batch 1 is still held
        await loop.run_in_executor(None, entered[1].wait, 30)
        gate.set()
        return await asyncio.gather(t1, t2, t3)

    outs = asyncio.run(run())
    assert [o.split("\t")[0] for o in outs] == ["a", "b", "c"]
    assert svc.batcher.batches_run == 2
    assert state["max"] == 2
    assert svc.batcher.call_ms > 0


def test_depth_from_env(data_dir, monkeypatch):
    monkeypatch.setenv("SKT_SERVE_DEPTH", "1")
    svc = torch_server.AnnotationService(str(data_dir), device="cpu")
    assert svc.batcher.depth == 1
    monkeypatch.setenv("SKT_SERVE_DEPTH", "0")
    assert torch_server._QueryBatcher(svc).depth == 1
    monkeypatch.delenv("SKT_SERVE_DEPTH")
    assert torch_server._QueryBatcher(svc).depth == 4


def test_round_timings(data_dir):
    """The batcher's spans: every request's parse and wait is counted,
    and each round's merge and formatting."""
    svc = torch_server.AnnotationService(str(data_dir), device="cpu")
    cores = _cores()

    async def run():
        return await asyncio.gather(*[
            svc.batcher.query(f">q{i}\n{seq}\n".encode())
            for i, (_fn, seq) in enumerate(cores)])

    asyncio.run(run())
    b = svc.batcher
    assert b.requests_run == len(cores) and b.batches_run == 1
    assert b.parse_ms > 0 and b.merge_ms > 0 and b.format_ms > 0
    assert b.wait_ms >= 0 and b.call_ms > 0


def test_warm_runs_shapes_and_serves(data_dir):
    svc = torch_server.AnnotationService(str(data_dir), device="cpu")
    # length 256 IS its own 128-bucket max -> one length, rows 64+128
    assert svc.warm(length=256, max_rows=128) == 2
    # a non-bucket length warms its own probe width and the bucket max
    assert svc.warm(length=300, max_rows=64) == 2
    # lengths beyond the template tile must not read out of bounds
    assert svc.warm(length=1536, max_rows=64) == 1
    fn, seq = _cores()[0]
    out = svc.query_text(f">q\n{seq}\n".encode())
    assert out.split("\t")[1] == fn


def test_serve_no_listen_writes_distribution(data_dir, tmp_path, capsys):
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli(["serve", "-d", str(data_dir), "--no-listen",
                    "--kmer-family-distribution", str(jax_out)]) == 0
    capsys.readouterr()
    assert torch_cli(["serve", "-d", str(data_dir), "--no-listen",
                      "--kmer-family-distribution", str(port_out),
                      "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert f"write distribution to {port_out}\n" in err
    assert "kmers; not listening\n" in err
    assert port_out.read_bytes() == jax_out.read_bytes()
    rows = port_out.read_text().splitlines()
    assert rows and "hypothetical protein" in port_out.read_text()


def test_serve_defaults_to_cuda_and_raises_without_it(data_dir):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs the kernels")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli(["serve", "-d", str(data_dir), "--no-listen"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_server.AnnotationService(str(data_dir))


def test_caller_is_thread_safe(data_dir, fixture_dir):
    """4 threads call one FunctionCaller at once: each gets one thread's
    results, the counters count every row, and the table goes up once."""
    table, fi = pipeline.load_data_dir(data_dir)
    uploads = [0]
    to_device = table.to_device

    def counted(*a, **k):
        uploads[0] += 1
        time.sleep(0.05)  # widen the window a second thread could enter
        return to_device(*a, **k)

    table.to_device = counted
    caller = FunctionCaller(table, fi, device="cpu")
    batches = [read_fasta_batch(p)
               for p in sorted((fixture_dir / "Seqs").iterdir())[:4]]
    want = [FunctionCaller(*pipeline.load_data_dir(data_dir),
                           device="cpu").call_batch(b) for b in batches]
    barrier = threading.Barrier(4)
    got = [None] * 4
    errors = []

    def run(i):
        try:
            barrier.wait()
            got[i] = caller.call_batch(batches[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    for g, w in zip(got, want):
        assert [(r.seq_id, r.best) for r in g] == \
            [(r.seq_id, r.best) for r in w]
    assert caller.rows_processed == sum(len(b) for b in batches)
    assert uploads[0] == 1


def test_distance_state_is_thread_safe(data_dir):
    """Threads computing matrix distance at once: the distance rows are
    built once, and the pair counting's TF32 switch stays off inside
    every thread's product and comes back as it was."""
    from signature_kmers_tpu_torch.models import matrix_distance

    table, fi = pipeline.load_data_dir(data_dir)
    builds = [0]
    rows = table.distance_rows_to_device

    def counted(*a, **k):
        builds[0] += 1
        time.sleep(0.05)
        return rows(*a, **k)

    table.distance_rows_to_device = counted
    md = matrix_distance.MatrixDistance(table, fi, device="cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    barrier = threading.Barrier(8)

    def run():
        barrier.wait()
        md.device_tables()
        with matrix_distance._full_float32():
            time.sleep(0.01)  # another thread would restore it here
            seen.append(torch.backends.cuda.matmul.allow_tf32)

    threads = [threading.Thread(target=run) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert seen == [False] * 8
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert builds[0] == 1
