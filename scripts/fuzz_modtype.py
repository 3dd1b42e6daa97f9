"""modtype input fuzz: random ins/smp ONE files (ASCII and binary, with the
optional A/G/K/k/L/R/F line types, comments, multiple chromosome groups) and
error paths, compared against the reference binary.

Usage: python scripts/fuzz_modtype.py [n_cases] [seed0]
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.golden import harness

REPO = str(Path(__file__).resolve().parents[1])


def norm(t):
    return "\n".join(l for l in t.splitlines()
                     if not l.startswith("user\t")
                     and "resources used" not in l)


def gen_ref(rng, path, n_seq):
    names = []
    with open(path, "w") as f:
        for i in range(n_seq):
            name = f"chr{i}"
            names.append(name)
            L = int(rng.integers(500, 4000))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            f.write(f">{name}\n{seq}\n")
    return names


def gen_ins_text(rng, names, bad_name=False):
    lines = ["1 3 ins 1 1"]
    n_samples = int(rng.integers(1, 5))
    for g in range(int(rng.integers(1, 4))):
        nm = "nope" if bad_name and g == 0 else \
            names[int(rng.integers(0, len(names)))]
        lines.append("c %d %d %s" % (int(rng.integers(0, 9)), len(nm), nm))
        for _ in range(int(rng.integers(1, 5))):
            a = int(rng.integers(0, 400))
            lines.append("I %d %d" % (a, a + int(rng.integers(1, 200))))
            if rng.random() < 0.4:
                lines.append("A %s" % rng.choice(["0", "1"]))
            if rng.random() < 0.4:
                lines.append("G %d %s" % (n_samples, "".join(
                    rng.choice(list("012"), n_samples))))
            if rng.random() < 0.3:
                d = "".join("acgt"[c] for c in rng.integers(
                    0, 4, int(rng.integers(1, 30))))
                lines.append("K %s %d %s" % (rng.choice(["L", "R"]),
                                             len(d), d))
            if rng.random() < 0.3:
                d = "".join("acgt"[c] for c in rng.integers(
                    0, 4, int(rng.integers(1, 30))))
                lines.append("k %s %d %s" % (rng.choice(["L", "R"]),
                                             len(d), d))
            for t in "LRF":
                if rng.random() < 0.25:
                    v = rng.integers(0, 50, n_samples)
                    lines.append("%s %d %s" % (
                        t, n_samples, " ".join(map(str, v))))
    return "\n".join(lines) + "\n"


def gen_smp_text(rng):
    lines = ["1 3 smp 1 1"]
    for i in range(int(rng.integers(1, 6))):
        nm = "sample%d_%d" % (i, int(rng.integers(0, 999)))
        lines.append("N %d %s" % (len(nm), nm))
        if rng.random() < 0.8:
            fn = "reads%d.fq.gz" % i
            lines.append("F %d %s" % (len(fn), fn))
        if rng.random() < 0.8:
            lines.append("C %.6f" % float(rng.uniform(1, 99)))
    return "\n".join(lines) + "\n"


def to_binary(text, filetype, out_path):
    """Re-encode an ASCII ONE file as binary with our writer (the reference
    reads both transparently)."""
    import io as _io
    from modimizer.io.onecode import OneFile, OneSchema
    schema_text = (
        "P 3 var\nS 3 ins\nG c 2 3 INT 6 STRING\nO I 2 3 INT 3 INT\n"
        "D A 1 4 CHAR\nD G 1 6 STRING\nD K 2 4 CHAR 3 DNA\n"
        "D k 2 4 CHAR 3 DNA\nD L 1 8 INT_LIST\nD R 1 8 INT_LIST\n"
        "D F 1 8 INT_LIST\n" if filetype == "ins" else
        "P 3 smp\nO N 1 6 STRING\nD F 1 6 STRING\nD C 1 4 REAL\n")
    schema = OneSchema.from_text(schema_text)
    rf = OneFile.open_read(_io.BytesIO(text.encode()), schema, filetype)
    vf = OneFile.open_write_new(str(out_path), schema, filetype,
                                is_binary=True)
    vf.write_header()
    while rf.read_line() is not None:
        t = rf.lineType
        vi = rf.info[t]
        fields, data = [], None
        from modimizer.io.onecode import (CHAR, DNA, INT, INT_LIST, REAL,
                                              STRING)
        for i, ft in enumerate(vi.field_types):
            if ft == INT:
                fields.append(rf.one_int(i))
            elif ft == REAL:
                fields.append(rf.one_real(i))
            elif ft == CHAR:
                c = rf.one_char(i)
                fields.append(c if isinstance(c, str) else chr(c))
            elif ft in (STRING, DNA):
                data = rf.one_string_bytes()
                if isinstance(data, str):
                    data = data.encode()
            elif ft == INT_LIST:
                data = list(rf.one_int_list())
        vf.write_line(t, fields, data)
    vf.close()


def run_case(seed, mt, td):
    rng = np.random.default_rng(seed)
    d = Path(td)
    names = gen_ref(rng, d / "ref.fa", int(rng.integers(1, 4)))
    bad = rng.random() < 0.15
    ins = gen_ins_text(rng, names, bad_name=bad)
    smp = gen_smp_text(rng)
    (d / "sites.1ins").write_text(ins)
    (d / "samples.1smp").write_text(smp)
    use_bin = rng.random() < 0.5
    if use_bin and not bad:
        to_binary(ins, "ins", d / "sites_b.1ins")
        to_binary(smp, "smp", d / "samples_b.1smp")
        args = [str(d / "ref.fa"), str(d / "sites_b.1ins"),
                str(d / "samples_b.1smp")]
    else:
        args = [str(d / "ref.fa"), str(d / "sites.1ins"),
                str(d / "samples.1smp")]
    rc = subprocess.run([str(mt)] + args, capture_output=True)
    env = {**os.environ, "MODIMIZER_SCAN": "host"}
    rp = subprocess.run([sys.executable, os.path.join(REPO, "bin",
                                                      "modtype")] + args,
                        capture_output=True, env=env)
    if rc.returncode != rp.returncode:
        return f"seed {seed}: rc {rc.returncode} vs {rp.returncode}"
    co, po = (rc.stdout.decode("latin1"), rp.stdout.decode("latin1"))
    cerr, perr = (rc.stderr.decode("latin1"), rp.stderr.decode("latin1"))
    if norm(co) != norm(po):
        a, b = norm(co).splitlines(), norm(po).splitlines()
        for x, y in zip(a, b):
            if x != y:
                return f"seed {seed}: stdout {x[:60]!r} vs {y[:60]!r}"
        return f"seed {seed}: stdout length {len(a)} vs {len(b)}"
    if rc.returncode != 0:
        ec = cerr.splitlines()[-1] if cerr.splitlines() else ""
        ep = perr.splitlines()[-1] if perr.splitlines() else ""
        if ec != ep:
            return f"seed {seed}: stderr {ec[:60]!r} vs {ep[:60]!r}"
    return None


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 7000
    mt = harness.build_tool("modtype")
    fails = 0
    for i in range(n):
        with tempfile.TemporaryDirectory() as td:
            msg = run_case(seed0 + i, mt, td)
        if msg:
            print("FAIL:", msg)
            fails += 1
            if fails > 4:
                break
    print("modtype fuzz:", "ALL OK" if not fails
          else f"{fails}/{n} failures", f"({n} cases)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
