"""Parse-ahead streaming scan (io/stream_seq.py + scan_kmers_batches):
batched streaming must be bit-identical to the one-shot scan_kmers path —
same rows, same order, same consumer call results — across batch shapes,
chunk-spanning reads, overflow tiers, and gzipped input.
"""

import gzip

import numpy as np
import pytest

from modimizer.core.seqhash import Seqhash
from modimizer.io import seqio
from modimizer.io.stream_seq import iter_fasta_batches, iter_seq_batches
from modimizer.ops.seqhash import ModimizerScanner

BASES = np.frombuffer(b"ACGT", np.uint8)


def _stream(rng, n_reads=150, lo=40, hi=900):
    lens = rng.integers(lo, hi, size=n_reads)
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return codes, offsets, seqs


@pytest.mark.parametrize("feed_group", [1, 3])
@pytest.mark.parametrize("batching", ["one", "per_read", "ragged"])
def test_scan_kmers_batches_matches_scan_kmers(batching, feed_group):
    rng = np.random.default_rng(51)
    sh = Seqhash.create(16, 16, 17)
    codes, offsets, seqs = _stream(rng)
    seqs[7][:] = 0  # homopolymer: exercises the wide-retry tier
    codes = np.concatenate(seqs)  # rebuild: concatenate copies

    sc = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    want = sc.scan_kmers(codes, offsets)

    if batching == "one":
        batches = [(codes, offsets)]
    elif batching == "per_read":
        batches = [(s, np.array([0, len(s)], np.int64)) for s in seqs]
    else:  # ragged groups of 1..20 reads
        batches = []
        i = 0
        while i < len(seqs):
            j = min(len(seqs), i + int(rng.integers(1, 20)))
            grp = seqs[i:j]
            cb = np.concatenate(grp)
            ob = np.concatenate(
                [[0], np.cumsum([len(g) for g in grp])]).astype(np.int64)
            batches.append((cb, ob))
            i = j
    sc2 = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    sc2.feed_group = feed_group      # group-chained dispatch (S chunks per
    got = sc2.scan_kmers_batches(batches)   # program) must be bit-identical
    assert np.array_equal(want, got)

    # consumer mode sees the same slices in the same stream order
    chunks_a, chunks_b = [], []
    sc3 = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    na = sc3.scan_kmers(codes, offsets, consumer=chunks_a.append)
    sc4 = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    sc4.feed_group = feed_group
    nb = sc4.scan_kmers_batches(batches, consumer=chunks_b.append)
    assert na == nb == len(want)
    assert np.array_equal(np.concatenate(chunks_a),
                          np.concatenate(chunks_b))


def test_scan_kmers_batches_empty():
    sh = Seqhash.create(16, 16, 17)
    sc = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    assert len(sc.scan_kmers_batches([])) == 0
    sc2 = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    assert sc2.scan_kmers_batches(
        [(np.zeros(0, np.uint8), np.zeros(1, np.int64))], consumer=len) == 0


@pytest.mark.parametrize("gz", [False, True])
def test_iter_fasta_batches_equals_whole_parse(tmp_path, gz):
    rng = np.random.default_rng(52)
    codes, offsets, seqs = _stream(rng, n_reads=120)
    path = tmp_path / ("r.fa.gz" if gz else "r.fa")
    raw = b"".join(b">s%d some desc\n" % i + s.tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")) + b"\n"
        for i, s in enumerate(seqs))
    path.write_bytes(gzip.compress(raw) if gz else raw)

    conv = seqio.dna2index_n0()
    # tiny segments force many boundary splits
    got_c, got_o = [], [np.zeros(1, np.int64)]
    n = 0
    for cb, ob in iter_fasta_batches(str(path), conv, seg_bytes=1 << 12):
        got_c.append(cb)
        got_o.append(ob[1:] + n)
        n += len(cb)
    batch, _ = seqio.read_seq_file(str(path), conv, is_qual=False,
                                   want_ids=False)
    assert np.array_equal(np.concatenate(got_c).view(np.int8), batch.codes)
    assert np.array_equal(np.concatenate(got_o),
                          np.asarray(batch.offsets, np.int64))


def test_gz_whole_decode_equals_streaming(tmp_path, monkeypatch):
    """The libdeflate whole-buffer producer path and the zlib streaming
    fallback (MODIMIZER_GZ_WHOLE_MAX=0) must yield identical batches."""
    rng = np.random.default_rng(53)
    _c, _o, seqs = _stream(rng, n_reads=200)
    raw = b"".join(b">s%d\n" % i + s.tobytes().translate(
        bytes.maketrans(bytes(range(4)), b"ACGT")) + b"\n"
        for i, s in enumerate(seqs))
    path = tmp_path / "r.fa.gz"
    path.write_bytes(gzip.compress(raw))
    conv = seqio.dna2index_n0()

    def collect():
        return [(cb.copy(), ob.copy()) for cb, ob in
                iter_fasta_batches(str(path), conv, seg_bytes=1 << 13)]

    whole = collect()
    monkeypatch.setenv("MODIMIZER_GZ_WHOLE_MAX", "0")
    streamed = collect()
    assert len(whole) == len(streamed)
    for (wc, wo), (sc, so) in zip(whole, streamed):
        assert np.array_equal(wc, sc) and np.array_equal(wo, so)


def test_iter_fasta_batches_rejects_non_fasta(tmp_path):
    p = tmp_path / "x.fq"
    p.write_bytes(b"@r1\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="not FASTA"):
        next(iter_fasta_batches(str(p), seqio.dna2index_n0()))


@pytest.mark.parametrize("gz", [False, True])
def test_iter_seq_batches_fastq_equals_whole_parse(tmp_path, gz):
    """FASTQ streaming: 4-line record splits, quality lines that start
    with '@' and '+' must not confuse the segmenter."""
    rng = np.random.default_rng(54)
    _, _, seqs = _stream(rng, n_reads=130)
    path = tmp_path / ("r.fq.gz" if gz else "r.fq")
    qual_alphabet = np.frombuffer(b"@+!IJ~", np.uint8)
    raw = b"".join(
        b"@q%d d\n" % i
        + s.tobytes().translate(bytes.maketrans(bytes(range(4)), b"ACGT"))
        + b"\n+\n" + qual_alphabet[rng.integers(0, 6, len(s))].tobytes()
        + b"\n" for i, s in enumerate(seqs))
    path.write_bytes(gzip.compress(raw) if gz else raw)

    conv = seqio.dna2index_n0()
    got_c, got_o = [], [np.zeros(1, np.int64)]
    n = 0
    for cb, ob in iter_seq_batches(str(path), conv, seg_bytes=1 << 12):
        got_c.append(cb)
        got_o.append(ob[1:] + n)
        n += len(cb)
    batch, _ = seqio.read_seq_file(str(path), conv, is_qual=False,
                                   want_ids=False)
    assert np.array_equal(np.concatenate(got_c).view(np.int8), batch.codes)
    assert np.array_equal(np.concatenate(got_o),
                          np.asarray(batch.offsets, np.int64))


def test_iter_seq_batches_rejects_binary(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"b" + b"\0" * 63)
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        next(iter_seq_batches(str(p), seqio.dna2index_n0()))


def test_stream_scan_end_to_end_fasta(tmp_path):
    """File -> parse-ahead batches -> streaming scan == whole-file parse ->
    one-shot scan (the bench.py / modutils -a streaming path)."""
    rng = np.random.default_rng(53)
    _, _, seqs = _stream(rng, n_reads=200, lo=60, hi=1200)
    path = tmp_path / "reads.fa"
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">r%d\n" % i + s.tobytes().translate(
                bytes.maketrans(bytes(range(4)), b"ACGT")) + b"\n")
    conv = seqio.dna2index_n0()
    sh = Seqhash.create(16, 16, 17)

    batch, _ = seqio.read_seq_file(str(path), conv, is_qual=False,
                                   want_ids=False)
    sc = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    want = sc.scan_kmers(batch.codes, batch.offsets)

    sc2 = ModimizerScanner(sh, chunk=1 << 13, host_threshold=0)
    got = sc2.scan_kmers_batches(
        iter_fasta_batches(str(path), conv, seg_bytes=1 << 14))
    assert np.array_equal(want, got)


def test_scan_kmers_batches_giant_read():
    """A read longer than several chunks (carry buffer growth, chunk
    windows that start and end mid-read) must match the one-shot scan."""
    rng = np.random.default_rng(55)
    sh = Seqhash.create(16, 16, 17)
    lens = [300, 5 * (1 << 12) + 777, 200, 3 * (1 << 12), 90]
    seqs = [rng.integers(0, 4, size=l).astype(np.uint8) for l in lens]
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    sc = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    want = sc.scan_kmers(codes, offsets)
    sc2 = ModimizerScanner(sh, chunk=1 << 12, host_threshold=0)
    got = sc2.scan_kmers_batches(
        [(s, np.array([0, len(s)], np.int64)) for s in seqs])
    assert np.array_equal(want, got)
