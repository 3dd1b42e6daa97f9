"""Foreign-schema ONE-code fuzz: random user schemas + data, byte-compared
against the reference ONElib (tests/golden/one_driver.c) in both ASCII and
binary (Huffman-trained) forms, plus reader cross-checks.

Usage: python scripts/fuzz_onecode_schema.py [n_cases] [seed0]
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from modimizer.io.onecode import (CHAR, DNA, INT, INT_LIST, REAL,
                                      REAL_LIST, STRING, STRING_LIST,
                                      TYPE_NAME, OneFile, OneSchema)

# Object/data types must be UPPERCASE: the reference's binary footer only
# writes counts for A-Z plus the group type (oneWriteFooter,
# ONElib.c:2217-2221), so lowercase non-group types never get their '#'
# line and the reference segfaults reading back its own file (the '&'
# object-index buffer is allocated from the object type's '#' count,
# ONElib.c:1273-1277).  Group types are lowercase by convention; lowercase
# o,q,s,u,w additionally collide with the universal ;&*/. pack codes
# (ONElib.c:159-165).  Our reader/writer handle all of these; the fuzz
# stays inside the envelope the reference itself can round-trip.
LETTERS = [chr(c) for c in range(ord("A"), ord("Z") + 1)]
GROUP_LETTERS = list("abcdefghijklmnprtvxyz")

SCALARS = [INT, REAL, CHAR]
LISTS = [STRING, DNA, INT_LIST, REAL_LIST, STRING_LIST]

STR_ALPHA = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             "0123456789_+-.:!@#$%^&*()")


def gen_schema(rng):
    letters = list(LETTERS)
    rng.shuffle(letters)
    glets = list(GROUP_LETTERS)
    rng.shuffle(glets)
    lines = ["P 3 fzz"]
    types = {}
    has_group = rng.random() < 0.5
    kinds = []
    if has_group:
        kinds.append("G")
    kinds.append("O")
    kinds += ["D"] * int(rng.integers(1, 4))
    for kind in kinds:
        t = glets.pop() if kind == "G" else letters.pop()
        if kind == "G":
            # group lines are count lines: the reference's binary reader
            # decodes group fields through the compressed-INT path (a REAL
            # group field reads back as its integer bit pattern) and
            # mangles list payloads on group lines, so fuzz the
            # conventional shape only (1-2 INT fields)
            fts = [INT] * int(rng.integers(1, 3))
        else:
            nf = int(rng.integers(1, 4))
            fts = [SCALARS[rng.integers(0, len(SCALARS))]
                   for _ in range(nf)]
            if rng.random() < 0.75:
                fts[int(rng.integers(0, nf))] =                     LISTS[rng.integers(0, len(LISTS))]
        types[t] = (kind, fts)
        spec = " ".join("%d %s" % (len(TYPE_NAME[ft]), TYPE_NAME[ft])
                        for ft in fts)
        lines.append("%s %s %d %s" % (kind, t, len(fts), spec))
    return "\n".join(lines) + "\n", types


def gen_value(rng, ft):
    if ft == INT:
        return int(rng.integers(-(1 << 40), 1 << 40))
    if ft == REAL:
        # values that round-trip %la exactly (any double does)
        return float(np.float64(rng.normal()) * 2.0 ** int(rng.integers(-8, 8)))
    if ft == CHAR:
        return STR_ALPHA[rng.integers(0, len(STR_ALPHA))]
    if ft in (STRING,):
        n = int(rng.integers(1, 60))
        return "".join(STR_ALPHA[i]
                       for i in rng.integers(0, len(STR_ALPHA), n))
    if ft == DNA:
        n = int(rng.integers(1, 200))
        return "".join("acgt"[i] for i in rng.integers(0, 4, n))
    if ft == INT_LIST:
        # n >= 2: the reference dies on singleton INT_LISTs in binary mode
        # before codec training (ltfWrite first elt, --listLen, then
        # fwrite(size 0) != 1 -> die; ONElib.c:2053-2080).  Our writer
        # handles them (tests/test_onecode_parity.py singleton test).
        n = int(rng.integers(2, 30))
        return [int(v) for v in rng.integers(-(1 << 30), 1 << 30, n)]
    if ft == REAL_LIST:
        n = int(rng.integers(1, 20))
        return [float(v) for v in rng.normal(size=n)]
    if ft == STRING_LIST:
        n = int(rng.integers(1, 8))
        return ["".join(STR_ALPHA[i]
                        for i in rng.integers(0, len(STR_ALPHA),
                                              int(rng.integers(1, 12))))
                for _ in range(n)]
    raise AssertionError


def chex(v) -> str:
    """float.hex formatted like glibc %la (trailing mantissa zeros trimmed)."""
    h = float.hex(float(v))
    if "p" in h and "." in h:
        m, e = h.split("p")
        m = m.rstrip("0").rstrip(".")
        h = m + "p" + e
    return h


def spec_field(ft, v):
    if ft == INT:
        return str(v)
    if ft == REAL:
        return float.hex(float(v))
    if ft == CHAR:
        return v
    if ft in (STRING, DNA):
        return v
    if ft == INT_LIST:
        return ",".join(map(str, v))
    if ft == REAL_LIST:
        return ",".join(float.hex(float(x)) for x in v)
    if ft == STRING_LIST:
        return ",".join(v)
    raise AssertionError


def gen_stream(rng, types, n_lines):
    """Random data stream: object lines interleaved with D lines, groups
    first when present."""
    order = []
    group = [t for t, (k, _f) in types.items() if k == "G"]
    obj = [t for t, (k, _f) in types.items() if k == "O"][0]
    others = [t for t, (k, _f) in types.items() if k == "D"]
    i = 0
    n_lines = max(n_lines, 2)  # >= 2 objects: the reference dies closing a
    # binary file with one object (singleton '&' footer INT_LIST)
    while i < n_lines:
        if group and (i == 0 or rng.random() < 0.1):
            order.append(group[0])
        order.append(obj)
        for t in others:
            if rng.random() < 0.6:
                order.append(t)
        i = len(order)
    rows = []
    for t in order[:n_lines]:
        _k, fts = types[t]
        rows.append((t, [gen_value(rng, ft) for ft in fts]))
    return rows


def write_ours(schema_text, types, rows, path, is_binary):
    schema = OneSchema.from_text(schema_text)
    vf = OneFile.open_write_new(str(path), schema, "fzz",
                                is_binary=is_binary)
    vf.add_provenance("one_driver", "1.0", "fuzz", "2026-01-01_00:00:00")
    vf.write_header()
    for t, vals in rows:
        _k, fts = types[t]
        fields, data = [], None
        for ft, v in zip(fts, vals):
            if ft in (STRING, DNA):
                data = v.encode()
            elif ft == INT_LIST:
                data = list(v)
            elif ft == REAL_LIST:
                data = list(v)
            elif ft == STRING_LIST:
                data = list(v)
            else:
                fields.append(v)
        vf.write_line(t, fields, data)
    vf.close()


def dump_ours(schema_text, path):
    """Canonical text dump of a ONE file via our reader (mirrors the
    driver's read mode)."""
    schema = OneSchema.from_text(schema_text)
    vf = OneFile.open_read(str(path), schema, "fzz")
    assert vf is not None
    out = []
    while vf.read_line() is not None:
        t = vf.lineType
        fts = vf.info[t].field_types
        parts = [t]
        fi = 0
        for i, ft in enumerate(fts):
            if ft == INT:
                parts.append(str(vf.one_int(i)))
            elif ft == REAL:
                parts.append(chex(vf.one_real(i)))
            elif ft == CHAR:
                c = vf.one_char(i)
                parts.append(c if isinstance(c, str) else chr(c))
            elif ft in (STRING, DNA):
                parts.append(vf.one_string())
            elif ft == INT_LIST:
                parts.append(",".join(str(int(x))
                                      for x in vf.one_int_list()))
            elif ft == REAL_LIST:
                parts.append(",".join(chex(float(x))
                                      for x in vf.list_data))
            elif ft == STRING_LIST:
                parts.append(",".join(vf.one_string_list()))
        out.append("\t".join(parts))
    return "\n".join(out) + "\n" if out else ""


def run_case(seed, driver, workdir):
    rng = np.random.default_rng(seed)
    schema_text, types = gen_schema(rng)
    rows = gen_stream(rng, types, int(rng.integers(5, 400)))
    d = Path(workdir)
    (d / "schema.txt").write_text(schema_text)
    spec = "".join(
        "%s\t%s\n" % (t, "\t".join(spec_field(ft, v)
                                   for ft, v in zip(types[t][1], vals)))
        for t, vals in rows)
    (d / "spec.tsv").write_text(spec)
    for binary in (0, 1):
        ref_out = d / f"ref_{binary}.1fzz"
        our_out = d / f"our_{binary}.1fzz"
        r = subprocess.run([str(driver), "write", str(d / "schema.txt"),
                            str(d / "spec.tsv"), str(ref_out), str(binary),
                            "fzz"], capture_output=True)
        assert r.returncode == 0, (seed, r.stderr)
        write_ours(schema_text, types, rows, our_out, bool(binary))
        rb, ob = ref_out.read_bytes(), our_out.read_bytes()
        if rb != ob:
            i = next(i for i in range(min(len(rb), len(ob)) + 1)
                     if i >= min(len(rb), len(ob)) or rb[i] != ob[i])
            return (f"seed {seed} binary={binary}: byte mismatch at {i} "
                    f"(len {len(rb)} vs {len(ob)}): "
                    f"{rb[max(0,i-20):i+20]!r} vs {ob[max(0,i-20):i+20]!r}")
        # reader cross-check on the reference-written file
        r = subprocess.run([str(driver), "read", str(d / "schema.txt"),
                            str(ref_out), "fzz"], capture_output=True)
        assert r.returncode == 0, (seed, r.stderr)
        ours = dump_ours(schema_text, ref_out)
        if r.stdout.decode("latin1") != ours:
            return f"seed {seed} binary={binary}: reader dump mismatch"
    return None


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    from tests.golden.harness import build_one_driver
    driver = build_one_driver()
    fails = 0
    for i in range(n):
        with tempfile.TemporaryDirectory() as td:
            msg = run_case(seed0 + i, driver, td)
        if msg:
            print("FAIL:", msg)
            fails += 1
            if fails > 4:
                break
        elif (i + 1) % 10 == 0:
            print(f"{i+1}/{n} ok", flush=True)
    print("done:", "ALL OK" if not fails else f"{fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
