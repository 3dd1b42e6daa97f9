"""CRAM reader/writer round-trip fuzzer.

The reference ingests CRAM through htslib (seqio.c:722-835); no htslib or
samtools exists in this image, so instead of a differential oracle this
fuzzes the spec-accurate writer against the reader across randomized
layouts: unmapped (BA) / embedded-ref / no_ref / external-ref (UR and
REF_PATH M5 resolution), quals on/off, seq-unknown flags, container sizes,
read-length extremes, soft-masked multi-record FASTA references — asserting
sequence/qual/name equality through the seqio layer every time.

Usage: python scripts/fuzz_cram.py [n_trials] [seed]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from modimizer.io import cramio, seqio

BASES = np.frombuffer(b"ACGT", np.uint8)


def run_trial(t, rng, wd):
    mode = rng.choice(["unmapped", "embedded", "no_ref", "ext_ur",
                       "ext_refpath"])
    n = int(rng.integers(0, 60))
    lo = int(rng.integers(1, 30))
    hi = lo + int(rng.integers(1, 600))
    ref = BASES[rng.integers(0, 4, int(rng.integers(hi + 10, 8000)))] \
        .tobytes()
    names, seqs, quals, pos = [], [], [], []
    for i in range(n):
        ln = int(rng.integers(lo, hi))
        if mode in ("embedded", "ext_ur", "ext_refpath"):
            p = int(rng.integers(0, len(ref) - ln))
            s = bytearray(ref[p:p + ln])
            for _ in range(int(rng.integers(0, 5))):
                j = int(rng.integers(0, ln))
                s[j] = BASES[(BASES.tolist().index(s[j])
                              + int(rng.integers(1, 4))) % 4]
            pos.append(p)
            seqs.append(bytes(s))
        else:
            seqs.append(BASES[rng.integers(0, 4, ln)].tobytes())
        names.append(f"t{t}r{i}")
        quals.append(rng.integers(0, 45, ln).astype(np.uint8).tobytes())
    with_quals = bool(rng.integers(0, 2))
    unk = [bool(rng.integers(0, 5) == 0) for _ in range(n)] \
        if rng.integers(0, 2) else None
    kw = {"per_container": int(rng.choice([1, 3, 17, 10000]))}
    env_clear = []
    if mode == "embedded":
        kw.update(embed_ref=ref, positions=pos)
    elif mode == "no_ref":
        kw.update(no_ref=True)
    elif mode == "ext_ur":
        fa = os.path.join(wd, f"g{t}.fa")
        with open(fa, "wb") as f:
            if rng.integers(0, 2):
                f.write(b">decoy\nGG\n")
            f.write(b">ref\n")
            for i in range(0, len(ref), 61):
                line = ref[i:i + 61]
                f.write(line.lower() if rng.integers(0, 3) == 0 else line)
                f.write(b"\n")
        kw.update(embed_ref=ref, positions=pos, ref_external=True,
                  ref_ur=fa if rng.integers(0, 2) else f"g{t}.fa")
    elif mode == "ext_refpath":
        import hashlib
        m5 = hashlib.md5(ref).hexdigest()
        cache = os.path.join(wd, f"c{t}", m5[:2])
        os.makedirs(cache, exist_ok=True)
        with open(os.path.join(cache, m5[2:]), "wb") as f:
            f.write(ref)
        os.environ["REF_PATH"] = os.path.join(wd, f"c{t}", "%2s/%s")
        env_clear.append("REF_PATH")
        kw.update(embed_ref=ref, positions=pos, ref_external=True)
    path = os.path.join(wd, f"f{t}.cram")
    try:
        cramio.write_cram(path, names, seqs,
                          quals if with_quals else None,
                          seq_unknown=unk, **kw)
        b, _ = seqio.read_seq_file(path, None, is_qual=True, want_ids=True)
        assert b.n == n, (b.n, n)
        for i in range(n):
            want = b"N" * len(seqs[i]) if (unk and unk[i]) else seqs[i]
            assert bytes(b.seq(i)) == want, f"seq {i}"
            got_q = bytes(b.qual(i).astype(np.uint8))
            want_q = quals[i] if with_quals else b"\x00" * len(seqs[i])
            assert got_q == want_q, f"qual {i}"
        assert b.ids == names
    finally:
        for k in env_clear:
            os.environ.pop(k, None)
    return mode


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)
    wd = tempfile.mkdtemp(prefix="cram_fuzz_")
    tally = {}
    for t in range(n_trials):
        mode = run_trial(t, rng, wd)
        tally[mode] = tally.get(mode, 0) + 1
        print(f"trial {t}: {mode} OK", flush=True)
    print(f"PASS {n_trials}/{n_trials} {tally}")


if __name__ == "__main__":
    main()
