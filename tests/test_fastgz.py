"""Fast gzip decode (libdeflate) vs the zlib fallback: bit-identity.

The write side must stay zlib (gzopen byte parity, utils.c:108-127); the
read side may use libdeflate.  These tests pin that every decode path
(single member, multi-member/BGZF-style, text, ISIZE-undersized) returns
the same bytes through libdeflate and through the zlib fallback.
"""

import gzip
import io
import os

import pytest

from modimizer.io import fzio
from modimizer.io.fzio import GzWriter, gz_decompress_all, read_maybe_gz


@pytest.fixture
def libdeflate_present():
    if not fzio._libdeflate():
        pytest.skip("libdeflate not available on this host")


def _both(data):
    """Decode through libdeflate and the zlib fallback; assert equal."""
    fast = bytes(gz_decompress_all(bytearray(data)))
    slow = bytes(fzio._gz_decompress_zlib(bytearray(data)))
    assert fast == slow
    return fast


def test_single_member_roundtrip(libdeflate_present):
    payload = os.urandom(300000) + bytes(100000)
    buf = io.BytesIO()
    w = GzWriter(buf)
    w.write(payload)
    w.close()
    assert _both(buf.getvalue()) == payload


def test_multi_member(libdeflate_present):
    parts = [b"a" * 70000, os.urandom(5000), b">seq\nACGT\n" * 3000]
    data = b"".join(gzip.compress(p, 6) for p in parts)
    assert _both(data) == b"".join(parts)


def test_empty_member(libdeflate_present):
    data = gzip.compress(b"") + gzip.compress(b"tail")
    assert _both(data) == b"tail"


def test_undersized_initial_cap_grows(libdeflate_present):
    # initial capacity comes from the LAST member's ISIZE trailer; a big
    # first member forces the INSUFFICIENT_SPACE grow-and-retry loop
    big, tiny = os.urandom(500000), b"z"
    data = gzip.compress(big, 6) + gzip.compress(tiny, 6)
    assert _both(data) == big + tiny


def test_corrupt_data_raises_zlib_error(libdeflate_present):
    # bad streams fall back to zlib so callers see its error semantics
    import zlib
    data = bytearray(gzip.compress(b"payload" * 1000, 6))
    data[20] ^= 0xFF
    with pytest.raises(zlib.error):
        gz_decompress_all(data)


def test_read_maybe_gz_paths(tmp_path, libdeflate_present):
    payload = b"MSHSTv2\x00" + os.urandom(100000)
    gz = tmp_path / "x.mod"
    with GzWriter(str(gz)) as w:
        w.write(payload)
    plain = tmp_path / "y.mod"
    plain.write_bytes(payload)
    assert bytes(read_maybe_gz(str(gz))) == payload
    assert bytes(read_maybe_gz(str(plain))) == payload


def test_env_knob_forces_zlib(monkeypatch):
    monkeypatch.setenv("MODIMIZER_NO_LIBDEFLATE", "1")
    monkeypatch.setattr(fzio, "_LIBDEFLATE", None)
    data = gzip.compress(b"x" * 1000, 6)
    assert bytes(gz_decompress_all(bytearray(data))) == b"x" * 1000
    assert fzio._LIBDEFLATE is False


def test_trailing_garbage_tolerated(libdeflate_present):
    # zlib's gzread ignores trailing bytes that do not begin a gzip
    # member; both decode paths must too (reference reads via gzread)
    payload = b"payload" * 5000
    data = gzip.compress(payload, 6) + b"\x00" * 37 + b"junk"
    assert _both(data) == payload


def test_corrupt_later_member_raises(libdeflate_present):
    # a later member that STARTS like gzip but is corrupt must raise, not
    # silently truncate the payload
    import zlib
    a, b = gzip.compress(b"A" * 50000, 6), bytearray(gzip.compress(
        b"B" * 50000, 6))
    b[25] ^= 0xFF
    for fn in (gz_decompress_all, fzio._gz_decompress_zlib):
        with pytest.raises(zlib.error):
            fn(bytearray(a + bytes(b)))


def test_truncated_final_member_paths_agree(libdeflate_present):
    # truncated final member: both paths return the same (partial) bytes
    a = gzip.compress(b"A" * 50000, 6)
    b = gzip.compress(b"B" * 50000, 6)
    data = a + b[:len(b) // 2]
    assert _both(data).startswith(b"A" * 50000)


def test_garbage_isize_does_not_overallocate(libdeflate_present):
    # the ISIZE heuristic reads the last 4 bytes, garbage here; the cap
    # clamp (deflate max expansion) keeps the allocation sane
    payload = b"x" * 35000
    data = gzip.compress(payload, 6) + b"\x00" * 37 + b"junk"
    out = gz_decompress_all(bytearray(data))
    assert bytes(out) == payload
