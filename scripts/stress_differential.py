"""One-off large-scale differential stress: every tool, bigger data than the
unit tests, byte-exact comparison (timing lines filtered)."""
import os, sys, subprocess, gzip
import numpy as np
sys.path.insert(0, "/root/repo")
from tests.golden import harness

D = "/tmp/modimizer_stress"
# always start clean: leftovers from an interrupted run in these reused
# dirs read as file-diff "failures" (same trap the fuzzers fixed)
import shutil
shutil.rmtree(D, ignore_errors=True)
os.makedirs(D, exist_ok=True)
B = np.frombuffer(b"ACGT", np.uint8)
rng = np.random.default_rng(777)

def wfa(path, seqs, quals=False):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            txt = B[s].tobytes().decode()
            if quals:
                q = "".join(chr(33 + int(x)) for x in rng.integers(0, 42, len(s)))
                f.write(f"@r{i} desc{i}\n{txt}\n+\n{q}\n")
            else:
                f.write(f">r{i} desc{i}\n{txt}\n")

genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
reads = []
for i in range(3000):
    st = int(rng.integers(0, len(genome) - 6000))
    L = int(rng.integers(1000, 6000))
    r = genome[st:st + L].copy()
    ne = rng.binomial(L, 0.003)
    if ne:
        p = rng.integers(0, L, ne); r[p] = (r[p] + rng.integers(1, 4, ne)) % 4
    if rng.integers(0, 2):
        r = (r[::-1] ^ 3).astype(np.uint8)
    reads.append(r)
wfa(f"{D}/reads.fa", reads)
wfa(f"{D}/reads.fq", reads[:1500], quals=True)
wfa(f"{D}/reads_small.fa", reads[:400])
with open(f"{D}/ref.fa", "w") as f:
    f.write(">g\n" + B[genome].tobytes().decode() + "\n")

def flt(txt):
    if isinstance(txt, bytes):  # seqhoco emits gzipped FASTA on stdout
        return b"\n".join(l for l in txt.splitlines()
                          if not l.startswith(b"user\t")
                          and b"resources used" not in l)
    return "\n".join(l for l in txt.splitlines()
                     if not l.startswith("user\t") and "resources used" not in l)

def pair(tool, args, files=(), cwds=None):
    bin_c = str(harness.build_tool(tool))
    dc, dp = f"{D}/c_{tool}", f"{D}/p_{tool}"
    os.makedirs(dc, exist_ok=True); os.makedirs(dp, exist_ok=True)
    rc = subprocess.run([bin_c] + args, capture_output=True, cwd=dc)
    rp = subprocess.run([sys.executable, f"/root/repo/bin/{tool}"] + args,
                        capture_output=True, cwd=dp,
                        env={**os.environ, "MODIMIZER_SCAN": "host"})
    tag = f"{tool} {' '.join(args[:4])}"
    if tool == "seqconvert" and rc.returncode == -11 and rp.returncode == 0:
        # documented reference bug: seqIOclose use-after-free SIGSEGV
        # (seqconvert.c:78-81, heap-layout-dependent); its output files
        # are complete before the crash, so compare those only
        print("  (reference seqconvert crashed with SIGSEGV as documented)")
    else:
        assert rc.returncode == rp.returncode, (
            tag, rc.returncode, rp.returncode, rp.stderr[-300:].decode('latin1', 'replace') if isinstance(rp.stderr, bytes) else rp.stderr[-300:])
        assert flt(rc.stdout) == flt(rp.stdout), (tag, "stdout diff")
        assert flt(rc.stderr) == flt(rp.stderr), (
            tag, "stderr diff", rc.stderr[:200], rp.stderr[:200])
    for fn in files:
        if fn.endswith(".readset"):
            # the reference serializes LIVE HEAP POINTERS inside every
            # Read struct (arrayWrite raw dump, modasm.c:110-149) — its
            # .readset bytes are ASLR-nondeterministic run to run, so a
            # byte compare is meaningless; compare every parsed field
            # (and the shared .mod twin byte-exactly via the caller)
            import numpy as np
            from modimizer.core.readset import Readset
            stem = os.path.join(dc, fn[:-len(".readset")])
            stem_p = os.path.join(dp, fn[:-len(".readset")])
            ra, rb = Readset.read(stem), Readset.read(stem_p)
            for f in ("len", "n_hit", "n_miss", "bad", "other_flags",
                      "contained", "n_copy", "hit_off", "hits", "dx"):
                assert np.array_equal(getattr(ra, f), getattr(rb, f)), (
                    tag, fn, "readset field diff", f)
            continue
        a = open(os.path.join(dc, fn), "rb").read()
        b = open(os.path.join(dp, fn), "rb").read()
        assert a == b, (tag, fn, "file diff", len(a), len(b))
    print("OK", tag)

# modutils big build + text + histogram + select + merge chain
pair("modutils", ["-c", "24", "16", "16", "17", "-a", f"{D}/reads.fa",
                  "-w", "S.mod", "-wt", "S.txt", "-p", "1", "300",
                  "-s", "4", "18", "40", "-w", "S2.mod", "-H", "-x", "10"],  # noqa
     files=("S.mod", "S.txt", "S2.mod"))
# merge (zcat'd second input per reference fopen limitation)
for side in ("c_modutils", "p_modutils"):
    d = f"{D}/{side}"
    open(f"{d}/S2_plain.mod", "wb").write(gzip.open(f"{d}/S2.mod", "rb").read())
pair("modutils", ["-r", "S.mod", "-m", "S2_plain.mod", "-w", "M.mod"],
     files=("M.mod",))
# modmap build + query with verbose (.ref holds live heap pointers in the
# array/dict struct dumps — reference output is ASLR-nondeterministic there,
# so compare decompressed with pointer fields normalized + cross-load check)
pair("modmap", ["-K", "24", "-W", "13", "-S", "7", "-B", "24",
                "-f", f"{D}/ref.fa", "-w", "R", "-q", f"{D}/reads.fa"],
     files=("R.mod",))
import struct
def zero_ptrs(buf):
    off = 0
    magic = struct.pack("<i", 8918274)
    buf = bytearray(buf)
    while True:
        i = buf.find(magic, off)
        if i < 0:
            break
        buf[i + 8:i + 16] = b"\x00" * 8
        off = i + 4
    return buf
ca = zero_ptrs(gzip.open(f"{D}/c_modmap/R.ref", "rb").read())
pa = zero_ptrs(gzip.open(f"{D}/p_modmap/R.ref", "rb").read())
assert len(ca) == len(pa)
ndiff = sum(1 for x, y in zip(ca, pa) if x != y)
assert ndiff <= 64, f"R.ref {ndiff} differing bytes beyond pointer fields"
# cross-load: reference queries OUR index byte-identically
bin_c = str(harness.build_tool("modmap"))
q1 = subprocess.run([bin_c, "-r", "R", "-q", f"{D}/reads.fa"],
                    capture_output=True, text=True, cwd=f"{D}/c_modmap")
q2 = subprocess.run([bin_c, "-r", "R", "-q", f"{D}/reads.fa"],
                    capture_output=True, text=True, cwd=f"{D}/p_modmap")
assert flt(q1.stdout) == flt(q2.stdout), "cross-load query diff"
print("OK modmap .ref normalized + cross-load")
pair("modmap", ["-K", "16", "-W", "11", "-S", "3", "-B", "24",
                "-f", f"{D}/ref.fa", "-v", "-q", f"{D}/reads_small.fa"])
# modasm full pipeline
mu = str(harness.build_tool("modutils"))
subprocess.run([mu, "-c", "22", "16", "16", "17", "-a", f"{D}/reads.fa",
                "-s", "4", "18", "40", "-w", f"{D}/A.mod"], check=True,
               capture_output=True)
# no -u here: the reference's cluster() is quadratic in the inv walk and
# burns ~an hour of CPU on this 3000-read set (both sides replicate that
# serial algorithm exactly); -u parity is pinned at unit scale by
# test_modasm_parity and bench_all config 5, and stress_differential_2
# documents the same exclusion
pair("modasm", ["-m", f"{D}/A.mod", "-f", f"{D}/reads.fa", "-S", "-b", "-S",
                "-c", "-C", "-P", "-o1", "7", "-o2", "33", "-o3", "2",
                "9", "-a1", "4", "-w", "out"],
     files=("out.mod", "out.readset"))
# readset roundtrip (-r) and ref-flagging + tests
pair("modasm", ["-m", f"{D}/A.mod", "-f", f"{D}/reads.fa",
                "-R", f"{D}/ref.fa", "-b", "-c", "-T", "3", "60",
                "-rb", "1", "-S"])
# composition / seqconvert / seqhoco on fastq
pair("composition", ["-b", "-q", "-l", f"{D}/reads.fq"])
pair("seqconvert", ["-fa", "-o", "c.fa", f"{D}/reads.fq"], files=("c.fa",))
pair("seqconvert", ["-b", "-Q", "25", "-o", "c.bin", f"{D}/reads.fq"],
     files=("c.bin",))
pair("seqhoco", [f"{D}/reads.fa"])
print("ALL STRESS OK")
