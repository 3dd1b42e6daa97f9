import os, sys, subprocess, random
sys.path.insert(0, "/root/repo")
import numpy as np
from tests.golden import harness
D = "/tmp/modimizer_fuzz"
sys.path.insert(0, "/root/repo")
from modimizer.core.modset import Modset
MA = str(harness.build_tool("modasm"))
PY = [sys.executable, "/root/repo/bin/modasm"]

def flt(b):
    t = b.decode("latin1")
    return "\n".join(l for l in t.splitlines()
                     if not l.startswith("user\t") and "resources used" not in l)

ms = Modset.read(f"{D}/asm.mod")
import numpy as np
cand = [i for i in range(1, ms.max + 1)
        if (int(ms.info[i]) & 3) == 1 and 4 <= int(ms.depth[i]) <= 30]
R = random.Random(23)
fails = 0
N = 14
for i in range(N):
    seed = R.choice(cand)
    off = R.choice([0, 0, 1, 5])
    cmds = ["-m", f"{D}/asm.mod", "-f", f"{D}/asm.fa", "-R", f"{D}/ref.fa"]
    if R.random() < 0.5:
        cmds += ["-b", "-c"]
    if R.random() < 0.4:
        cmds += ["-T", str(R.randint(2, 4)), str(R.randint(30, 80))]
    if R.random() < 0.4:
        cmds += ["-rb", str(R.choice([1, 2, 3]))]
    cmds += ["-a2", str(seed), str(off)]
    if R.random() < 0.3:
        cmds += ["-a2", str(R.choice(cand)), "0"]
    dc, dp = f"{D}/zc{i}", f"{D}/zp{i}"
    os.makedirs(dc, exist_ok=True); os.makedirs(dp, exist_ok=True)
    rc = subprocess.run([MA] + cmds, capture_output=True, cwd=dc, timeout=200)
    rp = subprocess.run(PY + cmds, capture_output=True, cwd=dp, timeout=300,
                        env={**os.environ, "MODIMIZER_SCAN": "host"})
    ok = (rc.returncode == rp.returncode and flt(rc.stdout) == flt(rp.stdout)
          and flt(rc.stderr) == flt(rp.stderr))
    if ok:
        for fn in sorted(os.listdir(dc)):
            a = open(f"{dc}/{fn}", "rb").read()
            pb = f"{dp}/{fn}"
            b = open(pb, "rb").read() if os.path.exists(pb) else None
            if a != b:
                ok = False; print(f"[{i}] FILE DIFF {fn}:", " ".join(cmds[4:])); break
    if not ok:
        fails += 1
        print(f"[{i}] MISMATCH:", " ".join(cmds[4:]), rc.returncode, rp.returncode)
        for x, y in zip(flt(rc.stdout).splitlines(), flt(rp.stdout).splitlines()):
            if x != y:
                print("  C :", x[:130]); print("  PY:", y[:130]); break
print(f"modasm -a2 fuzz: {N - fails}/{N} identical")
