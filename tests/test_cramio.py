"""CRAM 3.0 reader/writer (io/cramio.py): codec round trips, BAM/CRAM twin
equality through the seqio layer, and modset-pipeline equality vs FASTA.

No htslib/samtools exists in this image, so the writer is the generator —
it emits spec-section-accurate containers exercising raw/gzip/bzip2/lzma/
rANS(0,1) blocks, EXTERNAL/HUFFMAN/BYTE_ARRAY_STOP encodings, unmapped (BA)
records and mapped records against an embedded reference."""

import numpy as np
import pytest

from modimizer.io import bamio, cramio, seqio

BASES = np.frombuffer(b"ACGT", np.uint8)


def _reads(rng, n, lo=50, hi=400):
    names, seqs, quals = [], [], []
    for i in range(n):
        ln = int(rng.integers(lo, hi))
        seqs.append(BASES[rng.integers(0, 4, ln)].tobytes())
        quals.append(rng.integers(0, 45, ln).astype(np.uint8).tobytes())
        names.append(f"read{i}")
    return names, seqs, quals


def test_rans_roundtrip_fuzz():
    """encode -> native decode == python-oracle decode == original."""
    rng = np.random.default_rng(1)
    for t in range(60):
        order = int(rng.integers(0, 2))
        n = int(rng.integers(0, 3000))
        na = int(rng.integers(1, 257))
        d = rng.integers(0, na, n).astype(np.uint8).tobytes()
        enc = cramio.rans_encode(d, order)
        assert cramio.rans_decode(enc, n) == d
        assert cramio._rans_decode_py(enc, n) == d


def test_rans_native_corrupt_input():
    """Truncated / corrupted streams never crash or overrun the native
    decoder — they either raise ValueError or decode to (wrong) bytes of
    the declared size, exactly like the Python oracle."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 8, 500).astype(np.uint8).tobytes()
    for order in (0, 1):
        enc = bytearray(cramio.rans_encode(d, order))
        cases = [bytes(enc[:10]), bytes(enc[:len(enc) // 2]),
                 bytes(enc[:-1])]
        bad = bytearray(enc)
        bad[11] ^= 0xFF   # corrupt the frequency table
        cases.append(bytes(bad))
        for c in cases:
            try:
                got = cramio.rans_decode(c, 500)
                assert len(got) == 500
            except (ValueError, IndexError):
                pass


def test_itf8_ltf8_edges():
    for v in (0, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000,
              0x0FFFFFFF, 0x10000000, 0x7FFFFFFF, 0xFFFFFFFF):
        b = cramio.itf8_put(v)
        got, p = cramio.itf8_get(b, 0)
        assert got == v and p == len(b)
    for v in (0, 0x80, 0x4000, 0x10000000, 0x800000000, 2**48, 2**63,
              2**64 - 1):
        b = cramio.ltf8_put(v)
        got, p = cramio.ltf8_get(b, 0)
        assert got == v and p == len(b)


def test_cram_bam_twins_unmapped(tmp_path):
    """A CRAM and a BAM of the same unmapped reads parse identically."""
    rng = np.random.default_rng(7)
    names, seqs, quals = _reads(rng, 120)
    cram = tmp_path / "r.cram"
    bam = tmp_path / "r.bam"
    cramio.write_cram(str(cram), names, seqs, quals)
    bamio.write_bam(str(bam), names, seqs,
                    [np.frombuffer(q, np.uint8) for q in quals])
    conv = seqio.dna2index_n0()
    bc, _ = seqio.read_seq_file(str(cram), conv, is_qual=True, want_ids=True)
    bb, _ = seqio.read_seq_file(str(bam), conv, is_qual=True, want_ids=True)
    assert np.array_equal(bc.codes, bb.codes)
    assert np.array_equal(bc.offsets, bb.offsets)
    assert np.array_equal(bc.quals, bb.quals)
    assert bc.ids == bb.ids == names


@pytest.mark.parametrize("file_id", [b"\0" * 20, b"reads.cram".ljust(20, b"\0"),
                                     bytes(range(1, 21))])
def test_cram_file_id_is_free_form(tmp_path, file_id):
    """The 20-byte file id (CRAM 3.0 sec 9) is a label: the records read
    the same whatever it holds."""
    rng = np.random.default_rng(12)
    names, seqs, quals = _reads(rng, 30)
    cram = tmp_path / "r.cram"
    cramio.write_cram(str(cram), names, seqs, quals)
    data = cram.read_bytes()
    assert data[:6] == b"CRAM\x03\x00"
    other = tmp_path / "o.cram"
    other.write_bytes(data[:6] + file_id + data[26:])
    a, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    b, _ = seqio.read_seq_file(str(other), None, is_qual=True, want_ids=True)
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.quals, b.quals)
    assert a.ids == b.ids == names


def test_cram_multi_container(tmp_path):
    rng = np.random.default_rng(8)
    names, seqs, quals = _reads(rng, 55)
    cram = tmp_path / "m.cram"
    cramio.write_cram(str(cram), names, seqs, quals, per_container=16)
    b, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    assert b.n == 55
    got = [bytes(b.seq(i)) for i in range(b.n)]
    assert got == list(seqs)
    assert b.ids == names


def test_cram_mapped_embedded_ref(tmp_path):
    """Mapped records reconstruct through the embedded reference +
    substitution features."""
    rng = np.random.default_rng(9)
    ref = BASES[rng.integers(0, 4, 5000)].tobytes()
    names, seqs, quals, pos = [], [], [], []
    for i in range(60):
        p = int(rng.integers(0, 4500))
        ln = int(rng.integers(60, 400))
        s = bytearray(ref[p:p + ln])
        # sprinkle substitutions
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, len(s)))
            s[j] = BASES[(np.frombuffer(BASES.tobytes(), np.uint8).tolist()
                          .index(s[j]) + int(rng.integers(1, 4))) % 4]
        names.append(f"m{i}")
        seqs.append(bytes(s))
        quals.append(rng.integers(0, 45, len(s)).astype(np.uint8).tobytes())
        pos.append(p)
    cram = tmp_path / "map.cram"
    cramio.write_cram(str(cram), names, seqs, quals, embed_ref=ref,
                      positions=pos)
    b, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    got = [bytes(b.seq(i)) for i in range(b.n)]
    assert got == seqs
    for i in range(b.n):
        assert bytes(b.qual(i).astype(np.uint8)) == quals[i]


def test_cram_modset_pipeline_matches_fasta(tmp_path):
    """BASELINE parity: the modset built from a CRAM equals the one built
    from the FASTA of the same reads (modutils -a semantics)."""
    import subprocess
    import sys
    import os
    rng = np.random.default_rng(10)
    names, seqs, _ = _reads(rng, 100, 100, 600)
    fa = tmp_path / "r.fa"
    with open(fa, "wb") as f:
        for nm, s in zip(names, seqs):
            f.write(b">" + nm.encode() + b"\n" + s + b"\n")
    cram = tmp_path / "r.cram"
    cramio.write_cram(str(cram), names, seqs)
    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for src, mod in ((fa, "fa.mod"), (cram, "cr.mod")):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "bin", "modutils"),
             "-c", "20", "16", "16", "17", "-a", str(src),
             "-w", str(tmp_path / mod)],
            check=True, capture_output=True, env=env)
    assert (tmp_path / "fa.mod").read_bytes() == \
        (tmp_path / "cr.mod").read_bytes()


def test_cram_no_ref_mode(tmp_path):
    """samtools no_ref=1 layout: mapped records whose bases ride whole-read
    'b'/BB features decode WITHOUT any reference (the missing-reference
    error fires only on an actual reference dereference)."""
    rng = np.random.default_rng(12)
    names, seqs, quals = _reads(rng, 80)
    cram = tmp_path / "nr.cram"
    cramio.write_cram(str(cram), names, seqs, quals, no_ref=True)
    b, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    assert [bytes(b.seq(i)) for i in range(b.n)] == list(seqs)
    assert b.ids == names
    for i in range(b.n):
        assert bytes(b.qual(i).astype(np.uint8)) == quals[i]


def test_cram_seq_unknown_flag(tmp_path):
    """CF&0x8 (SEQ '*') records decode as N's in BOTH the unmapped and the
    mapped branches — never fabricated reference bases."""
    rng = np.random.default_rng(13)
    names, seqs, quals = _reads(rng, 10, 50, 80)
    unk = [i % 3 == 0 for i in range(10)]
    ref = BASES[rng.integers(0, 4, 2000)].tobytes()
    for kwargs, tag in (({}, "u"),
                        ({"embed_ref": ref, "positions": [0] * 10}, "m")):
        cram = tmp_path / f"unk_{tag}.cram"
        cramio.write_cram(str(cram), names, seqs, quals,
                          seq_unknown=unk, **kwargs)
        b, _ = seqio.read_seq_file(str(cram), None, is_qual=True,
                                   want_ids=True)
        assert b.n == 10
        for i in range(b.n):
            want = (b"N" * len(seqs[i])) if unk[i] else seqs[i]
            assert bytes(b.seq(i)) == want, (tag, i)


def test_cram_external_ref_error(tmp_path):
    """A mapped slice with no embedded reference dies with a clear
    message, not a misparse."""
    rng = np.random.default_rng(11)
    ref = BASES[rng.integers(0, 4, 1000)].tobytes()
    names = ["x"]
    seqs = [ref[100:300]]
    cram = tmp_path / "e.cram"
    cramio.write_cram(str(cram), names, seqs, embed_ref=ref, positions=[100])
    raw = bytearray(cram.read_bytes())
    # surgically strip the embedded-ref: easier — re-write with a writer
    # hack is fragile; instead decode normally then assert the error path
    # by constructing a SliceDecoder with no ref block
    data = cram.read_bytes()
    p = 26
    h, p = cramio.read_container_header(data, p)   # header container
    p += h["length"]
    h, p = cramio.read_container_header(data, p)
    blocks = []
    end = p + h["length"]
    while p < end:
        b, p = cramio.read_block(data, p)
        blocks.append(b)
    pres, dsm, tagenc = cramio.parse_compression_header(blocks[0].data)
    sh = cramio.parse_slice_header(blocks[1].data)
    sh["embedded_ref_id"] = -1
    sblocks = [b for b in blocks[2:] if b.cid != 100 or b.ctype != 4]
    dec = cramio.SliceDecoder(pres, dsm, tagenc, sblocks, sh)
    with pytest.raises(ValueError, match="external\\s+reference"):
        dec.decode_records("e.cram")


def _mapped_reads(rng, ref, n=40):
    """Reads copied from ref with sprinkled substitutions (X/BS features)."""
    names, seqs, quals, pos = [], [], [], []
    for i in range(n):
        p = int(rng.integers(0, len(ref) - 500))
        ln = int(rng.integers(60, 400))
        s = bytearray(ref[p:p + ln])
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, len(s)))
            s[j] = BASES[(BASES.tolist().index(s[j])
                          + int(rng.integers(1, 4))) % 4]
        names.append(f"m{i}")
        seqs.append(bytes(s))
        quals.append(rng.integers(0, 45, len(s)).astype(np.uint8).tobytes())
        pos.append(p)
    return names, seqs, quals, pos


def test_cram_external_ref_ur(tmp_path, monkeypatch):
    """The default samtools CRAM layout (reference NOT embedded) resolves
    through the @SQ UR tag: a relative path against the CRAM's directory,
    a multi-record soft-masked FASTA selected by SN, slice-MD5-verified."""
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)
    rng = np.random.default_rng(21)
    ref = BASES[rng.integers(0, 4, 6000)].tobytes()
    names, seqs, quals, pos = _mapped_reads(rng, ref)
    # decoy first + soft-masked (lowercase) wrapped lines: the loader must
    # select by SN and uppercase to the REF_CACHE normal form
    fa = tmp_path / "genome.fa"
    with open(fa, "wb") as f:
        f.write(b">decoy desc\n" + b"GGGG\n")
        f.write(b">ref some description\n")
        for i in range(0, len(ref), 60):
            line = bytearray(ref[i:i + 60])
            if (i // 60) % 3 == 0:
                line = line.lower()
            f.write(bytes(line) + b"\n")
    cram = tmp_path / "ext.cram"
    cramio.write_cram(str(cram), names, seqs, quals, embed_ref=ref,
                      positions=pos, ref_external=True, ref_ur="genome.fa")
    b, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    assert [bytes(b.seq(i)) for i in range(b.n)] == seqs
    for i in range(b.n):
        assert bytes(b.qual(i).astype(np.uint8)) == quals[i]


def test_cram_external_ref_refpath(tmp_path, monkeypatch):
    """M5 resolution through REF_PATH templates: a missing first entry,
    then htslib's nested %2s/%2s/%s cache layout holding the raw
    (REF_CACHE-format) sequence."""
    import hashlib
    rng = np.random.default_rng(22)
    ref = BASES[rng.integers(0, 4, 4000)].tobytes()
    names, seqs, quals, pos = _mapped_reads(rng, ref, n=20)
    m5 = hashlib.md5(ref).hexdigest()
    cache = tmp_path / "cache"
    sub = cache / m5[:2] / m5[2:4]
    sub.mkdir(parents=True)
    (sub / m5[4:]).write_bytes(ref)
    monkeypatch.setenv(
        "REF_PATH",
        f"{tmp_path}/nowhere/%s:{cache}/%2s/%2s/%s")
    monkeypatch.delenv("REF_CACHE", raising=False)
    cram = tmp_path / "m5.cram"
    cramio.write_cram(str(cram), names, seqs, quals, embed_ref=ref,
                      positions=pos, ref_external=True)   # no UR: M5 only
    b, _ = seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)
    assert [bytes(b.seq(i)) for i in range(b.n)] == seqs


def test_cram_external_ref_m5_mismatch(tmp_path, monkeypatch):
    """A resolved file whose content fails the @SQ M5 digest dies with the
    M5-check error, never decodes against the wrong reference."""
    import hashlib
    rng = np.random.default_rng(23)
    ref = BASES[rng.integers(0, 4, 2000)].tobytes()
    names, seqs, quals, pos = _mapped_reads(rng, ref, n=5)
    m5 = hashlib.md5(ref).hexdigest()
    (tmp_path / m5).write_bytes(ref[::-1])   # wrong content at the M5 path
    monkeypatch.setenv("REF_PATH", f"{tmp_path}/%s")
    monkeypatch.delenv("REF_CACHE", raising=False)
    cram = tmp_path / "bad.cram"
    cramio.write_cram(str(cram), names, seqs, quals, embed_ref=ref,
                      positions=pos, ref_external=True)
    with pytest.raises(ValueError, match="M5 check"):
        seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)


def test_cram_external_ref_unresolvable(tmp_path, monkeypatch):
    """No UR, no REF_PATH/REF_CACHE: a clear resolution error naming the
    @SQ entry, not a misparse."""
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)
    rng = np.random.default_rng(24)
    ref = BASES[rng.integers(0, 4, 1500)].tobytes()
    names, seqs, quals, pos = _mapped_reads(rng, ref, n=3)
    cram = tmp_path / "nores.cram"
    cramio.write_cram(str(cram), names, seqs, quals, embed_ref=ref,
                      positions=pos, ref_external=True)
    with pytest.raises(ValueError, match="cannot resolve"):
        seqio.read_seq_file(str(cram), None, is_qual=True, want_ids=True)


def test_m5_template_expansion():
    """htslib's %Ns/%s expansion (cram_io.c expand_cache_path)."""
    f = cramio._m5_expand
    assert f("/c/%s", "abcdef") == "/c/abcdef"
    assert f("/c/%2s/%2s/%s", "abcdef") == "/c/ab/cd/ef"
    assert f("/c", "abcdef") == "/c/abcdef"          # no token: append /%s
    assert f("/c/", "abcdef") == "/c/abcdef"
    assert f("/c/%1s/x_%s", "abcd") == "/c/a/x_bcd"


def test_parse_sq_lines():
    sq = cramio.parse_sq_lines(
        "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:10\tM5:aa\tUR:file:///r.fa\n"
        "@SQ\tSN:chr2\tLN:20\n@PG\tID:x\n")
    assert sq == [{"SN": "chr1", "LN": "10", "M5": "aa",
                   "UR": "file:///r.fa"},
                  {"SN": "chr2", "LN": "20"}]
