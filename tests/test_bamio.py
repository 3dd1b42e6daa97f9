"""BAM/SAM ingest (io/bamio.py) vs the reference's htslib semantics
(seqio.c:722-835): nibble decode, reverse-flag reverse-complement, qual
handling, BGZF framing.  No htslib exists in this environment, so the
oracle is the documented byte-level semantics plus hand-built streams."""

import numpy as np
import pytest

from modimizer.io import bamio, seqio

RC = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}


def rc(seq: bytes) -> bytes:
    return bytes(RC[b] for b in reversed(seq))


@pytest.fixture
def bam_file(tmp_path):
    rng = np.random.default_rng(11)
    names, seqs, quals, flags = [], [], [], []
    for i in range(50):
        L = int(rng.integers(10, 200))
        seqs.append(bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L)))
        names.append(f"read{i}")
        quals.append(rng.integers(0, 40, L).astype(np.uint8))
    p = tmp_path / "t.bam"
    bamio.write_bam(str(p), names, seqs, quals)
    return p, names, seqs, quals


def test_bam_roundtrip(bam_file):
    p, names, seqs, quals = bam_file
    batch, ftype = seqio.read_seq_file(str(p), None, is_qual=True,
                                       want_ids=True)
    assert ftype == seqio.BAM
    assert batch.n == len(seqs)
    for i, s in enumerate(seqs):
        assert bytes(batch.seq(i).astype(np.uint8)) == s
        assert np.array_equal(batch.qual(i).astype(np.uint8), quals[i])
        assert batch.ids[i] == names[i]


def test_bam_reverse_flag(tmp_path):
    """FLAG & 0x10 records come back reverse-complemented to read
    orientation with quals reversed (seqio.c:786-797; qual reversal fixed
    vs the reference's stuck-pointer loop, see io/bamio.py)."""
    import struct, zlib
    seq = b"ACCGTTTGA"
    qual = np.arange(9, dtype=np.uint8)
    p = tmp_path / "rev.bam"
    bamio.write_bam(str(p), ["fwd", "rev"], [seq, seq], [qual, qual])
    # patch record 2's flag to 0x10: rewrite with explicit flags
    raw = b"".join(_bam_records(["fwd", "rev"], [seq, seq], [qual, qual],
                                [0, 0x10]))
    _write_bgzf(str(p), raw)
    batch, _t = seqio.read_seq_file(str(p), None, is_qual=True, want_ids=True)
    assert bytes(batch.seq(0).astype(np.uint8)) == seq
    assert bytes(batch.seq(1).astype(np.uint8)) == rc(seq)
    assert np.array_equal(batch.qual(0).astype(np.uint8), qual)
    assert np.array_equal(batch.qual(1).astype(np.uint8), qual[::-1])


def test_bam_missing_qual(tmp_path):
    seq = b"ACGTACGT"
    p = tmp_path / "nq.bam"
    bamio.write_bam(str(p), ["r"], [seq])  # qual absent -> 0xFF fill
    batch, _t = seqio.read_seq_file(str(p), None, is_qual=True, want_ids=True)
    assert np.array_equal(batch.qual(0), np.zeros(8, np.int8))


def test_bam_convert_table(bam_file):
    """dna2index conversion applied after decode, like every mod* tool."""
    p, _names, seqs, _quals = bam_file
    batch, _t = seqio.read_seq_file(str(p), seqio.dna2index_n0(),
                                    is_qual=False, want_ids=False)
    lut = np.full(256, -1, np.int64)
    lut[ord("A")], lut[ord("C")], lut[ord("G")], lut[ord("T")] = 0, 1, 2, 3
    for i, s in enumerate(seqs):
        assert np.array_equal(batch.seq(i).astype(np.int64),
                              lut[np.frombuffer(s, np.uint8)])


def test_sam_parse(tmp_path):
    seq = b"GGATTCA"
    lines = [
        b"r1\t0\t*\t0\t0\t*\t*\t0\t0\tGGATTCA\t!!!!!!!",
        b"r2\t16\t*\t0\t0\t*\t*\t0\t0\tGGATTCA\tIIIIIII",
        b"r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
    ]
    p = tmp_path / "t.sam"
    p.write_bytes(b"\n".join(lines) + b"\n")
    batch, ftype = seqio.read_seq_file(str(p), None, is_qual=True,
                                       want_ids=True)
    assert ftype == seqio.BAM
    assert bytes(batch.seq(0).astype(np.uint8)) == seq
    assert bytes(batch.seq(1).astype(np.uint8)) == rc(seq)
    assert batch.n == 3 and batch.ids == ["r1", "r2", "r3"]
    assert np.array_equal(batch.qual(1).astype(np.uint8),
                          np.full(7, ord("I") - 33, np.uint8))


def test_cram_detected(tmp_path):
    p = tmp_path / "t.cram"
    p.write_bytes(b"CRAM\x03\x00" + b"\x00" * 64)
    with pytest.raises(ValueError, match="CRAM"):
        seqio.read_seq_file(str(p), None)


def test_bam_through_modutils(tmp_path, bam_file):
    """BAM feeds the modset pipeline identically to the same data as FASTA."""
    p, names, seqs, _q = bam_file
    fa = tmp_path / "same.fa"
    with open(fa, "wb") as f:
        for n, s in zip(names, seqs):
            f.write(b">" + n.encode() + b"\n" + s + b"\n")
    from modimizer.core.seqhash import Seqhash
    from modimizer.core.modset import Modset
    from modimizer.ops.seqhash import ModimizerScanner

    def build(path):
        batch, _t = seqio.read_seq_file(str(path), seqio.dna2index_n0(),
                                        is_qual=False, want_ids=False)
        sh = Seqhash.create(16, 16, 17)
        sc = ModimizerScanner(sh)
        km, _g, _f = sc.scan_stream(batch.codes, batch.offsets)
        ms = Modset(sh, 20)
        ms.add_batch(km)
        return ms

    ms_bam, ms_fa = build(p), build(fa)
    assert ms_bam.max == ms_fa.max
    assert np.array_equal(ms_bam.value[:ms_bam.max + 1],
                          ms_fa.value[:ms_fa.max + 1])
    assert np.array_equal(ms_bam.index, ms_fa.index)


# ---- helpers for hand-built records ----

def _bam_records(names, seqs, quals, flags):
    import struct
    recs = [b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)]
    for name, seq, q, flag in zip(names, seqs, quals, flags):
        nib = bamio._TEXT2NIB[np.frombuffer(seq, np.uint8)]
        if len(nib) & 1:
            nib = np.concatenate([nib, np.zeros(1, np.uint8)])
        packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        nameb = name.encode() + b"\x00"
        body = (struct.pack("<iiBBHHHiiii", -1, -1, len(nameb), 0, 4680,
                            0, flag, len(seq), -1, -1, 0)
                + nameb + packed + np.asarray(q, np.uint8).tobytes())
        recs.append(struct.pack("<i", len(body)) + body)
    return recs


def _write_bgzf(path, raw):
    import struct, zlib

    def block(chunk):
        comp = zlib.compress(chunk, 6)[2:-4]
        return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                + struct.pack("<H", len(comp) + 25) + comp
                + struct.pack("<II", zlib.crc32(chunk), len(chunk)))

    with open(path, "wb") as f:
        f.write(block(raw))
        f.write(block(b""))
